"""1-D transform: perfect reconstruction, parity with the reference,
multi-signal columns, gain masks (reference tests: test_xfm1/test_ifm1)."""

import numpy as np
import pytest

from dtcwt_tpu import Transform1d

from .oracle import ref

RefTransform1d = ref.Transform1d

RNG = np.random.RandomState(21)


def test_reconstruct_vector():
    X = RNG.randn(256)
    t = Transform1d()
    pyr = t.forward(X, nlevels=5)
    rec = np.asarray(t.inverse(pyr))
    assert rec.shape == X.shape
    assert np.abs(rec - X).max() < 1e-12


def test_reconstruct_columns():
    X = RNG.randn(128, 5)
    t = Transform1d()
    pyr = t.forward(X, nlevels=4)
    rec = np.asarray(t.inverse(pyr))
    assert rec.shape == X.shape
    assert np.abs(rec - X).max() < 1e-12


def test_reconstruct_non_mult4_length():
    """Even but not multiple-of-4 lengths trigger the pad/crop path."""
    X = RNG.randn(106)
    t = Transform1d()
    pyr = t.forward(X, nlevels=3)
    rec = np.asarray(t.inverse(pyr))
    assert np.abs(rec - X).max() < 1e-12


def test_odd_length_raises():
    with pytest.raises(ValueError):
        Transform1d().forward(RNG.randn(103), nlevels=2)


@pytest.mark.parametrize("biort,qshift", [
    ("near_sym_a", "qshift_a"),
    ("near_sym_b", "qshift_b"),
    ("legall", "qshift_06"),
])
def test_matches_reference(biort, qshift):
    X = RNG.randn(144)
    t = Transform1d(biort=biort, qshift=qshift)
    pyr = t.forward(X, nlevels=4, include_scale=True)
    rt = RefTransform1d(biort=biort, qshift=qshift)
    rp = rt.forward(X.copy(), nlevels=4, include_scale=True)
    np.testing.assert_allclose(np.asarray(pyr.lowpass), rp.lowpass,
                               rtol=0, atol=1e-12)
    for lvl in range(4):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   rp.highpasses[lvl], rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(pyr.scales[lvl]),
                                   rp.scales[lvl], rtol=0, atol=1e-12)
    rec = np.asarray(t.inverse(pyr))
    ref_rec = rt.inverse(rp)
    np.testing.assert_allclose(rec, ref_rec, rtol=0, atol=1e-12)


def test_gain_mask_matches_reference():
    X = RNG.randn(128)
    gm = np.array([1.0, 0.0, 0.5, 2.0])
    t = Transform1d()
    pyr = t.forward(X, nlevels=4)
    got = np.asarray(t.inverse(pyr, gain_mask=gm))
    rt = RefTransform1d()
    rp = rt.forward(X.copy(), nlevels=4)
    want = rt.inverse(rp, gain_mask=gm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_nlevels_zero():
    X = RNG.randn(64)
    t = Transform1d()
    pyr = t.forward(X, nlevels=0)
    assert pyr.highpasses == ()
    # Reference parity: with no levels the inverse returns the lowpass
    # unchanged, in column form (reference transform1d.py:155-157).
    rec = np.asarray(t.inverse(pyr))
    np.testing.assert_allclose(rec.reshape(-1), X)
