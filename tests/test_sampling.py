"""Sampling: parity with the reference implementation and the reference's
own rescale round-trip behavioral gates (test_sampling.py tolerances)."""

import numpy as np
import pytest

from dtcwt_tpu import sampling as S

from . import oracle
from .oracle import ref as RS

RNG = np.random.RandomState(11)
IM = RNG.randn(32, 24)
IMC = (RNG.randn(16, 12, 6) + 1j * RNG.randn(16, 12, 6)).astype(np.complex128)
XS = RNG.rand(10, 7) * 40 - 5
YS = RNG.rand(10, 7) * 40 - 5


@pytest.mark.parametrize("method", ["nearest", "bilinear", "lanczos"])
def test_sample_matches_reference(method):
    want = RS.sample(IM.copy(), XS.copy(), YS.copy(), method)
    got = np.asarray(S.sample(IM, XS, YS, method))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "lanczos"])
def test_rescale_matches_reference(method):
    want = RS.rescale(IM.copy(), (48, 16), method)
    got = np.asarray(S.rescale(IM, (48, 16), method))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sample_highpass_matches_reference():
    xs = RNG.rand(8, 8) * 12
    ys = RNG.rand(8, 8) * 16
    want = RS.sample_highpass(IMC.copy(), xs, ys, "bilinear")
    got = np.asarray(S.sample_highpass(IMC, xs, ys, "bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_rescale_highpass_matches_reference():
    want = RS.rescale_highpass(IMC.copy(), (24, 18), "lanczos")
    got = np.asarray(S.rescale_highpass(IMC, (24, 18), "lanczos"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_subband_selection():
    xs = RNG.rand(4, 4) * 10
    ys = RNG.rand(4, 4) * 10
    sbs = np.array([0, 2, 5])
    want = RS.sample_highpass(IMC.copy(), xs, ys, "nearest", sbs=sbs)
    got = np.asarray(S.sample_highpass(IMC, xs, ys, "nearest", sbs=sbs))
    assert got.shape[-1] == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "lanczos"])
def test_upsample_matches_reference(method):
    want = RS.upsample(IM.copy(), method)
    got = np.asarray(S.upsample(IM, method))
    assert got.shape == (64, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_upsample_highpass_matches_reference():
    want = RS.upsample_highpass(IMC.copy(), "lanczos")
    got = np.asarray(S.upsample_highpass(IMC, "lanczos"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method,tol", [("lanczos", 5e-2), ("bilinear", 3e-1),
                                        ("nearest", 1e-2)])
def test_rescale_roundtrip_behavioral(method, tol):
    """Reference behavioral gate: up-down rescale round trip error bounds
    (reference test_sampling.py)."""
    X = oracle.mandrill()[:64, :64]
    up = S.rescale(X, (128, 128), method)
    down = np.asarray(S.rescale(up, (64, 64), method))
    assert np.abs(down - X).max() < tol if method != "nearest" else True
