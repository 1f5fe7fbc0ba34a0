"""2-D transform: perfect reconstruction, parity with the reference
implementation, odd-size handling, bandpass variants, batching, gain masks.

Tolerance ladder carried over from the reference suite: round-trip f64
< 1e-12 (test_ifm2.py:9), general equality 1e-6, f32 path 1e-3.
"""

import numpy as np
import pytest

import dtcwt_tpu
from dtcwt_tpu import Transform2d

from . import oracle
from .oracle import ref

RefTransform2d = ref.Transform2d

RNG = np.random.RandomState(7)
MANDRILL = oracle.mandrill()


def _roundtrip(X, nlevels=3, biort="near_sym_a", qshift="qshift_a", **kw):
    t = Transform2d(biort=biort, qshift=qshift)
    pyr = t.forward(X, nlevels=nlevels, **kw)
    rec = np.asarray(t.inverse(pyr))
    return pyr, rec


def test_reconstruct_mandrill():
    _, rec = _roundtrip(MANDRILL, nlevels=4)
    assert np.abs(rec - MANDRILL).max() < 1e-12


def test_reconstruct_random():
    X = RNG.randn(88, 72)
    _, rec = _roundtrip(X, nlevels=4)
    assert np.abs(rec - X).max() < 1e-12


@pytest.mark.parametrize("shape", [(127, 127), (126, 127), (63, 66), (31, 31)])
def test_reconstruct_odd_sizes(shape):
    """Odd sizes are edge-extended before decomposition; the reconstruction
    matches the extended image restricted to the original support."""
    X = RNG.randn(*shape)
    _, rec = _roundtrip(X, nlevels=3)
    assert np.abs(rec[:shape[0], :shape[1]] - X).max() < 1e-10


@pytest.mark.parametrize("biort,qshift", [
    ("near_sym_a", "qshift_a"),
    ("near_sym_b", "qshift_b"),
    ("legall", "qshift_06"),
    ("antonini", "qshift_c"),
    ("near_sym_b_bp", "qshift_b_bp"),
])
def test_matches_reference_forward_and_inverse(biort, qshift):
    X = MANDRILL[:128, :128]
    nlevels = 4
    t = Transform2d(biort=biort, qshift=qshift)
    pyr = t.forward(X, nlevels=nlevels, include_scale=True)

    rt = RefTransform2d(biort=biort, qshift=qshift)
    rp = rt.forward(X.copy(), nlevels=nlevels, include_scale=True)

    np.testing.assert_allclose(np.asarray(pyr.lowpass), rp.lowpass,
                               rtol=0, atol=1e-11)
    for lvl in range(nlevels):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   rp.highpasses[lvl], rtol=0, atol=1e-11)
        np.testing.assert_allclose(np.asarray(pyr.scales[lvl]),
                                   rp.scales[lvl], rtol=0, atol=1e-11)

    rec = np.asarray(t.inverse(pyr))
    ref_rec = rt.inverse(rp)
    np.testing.assert_allclose(rec, ref_rec, rtol=0, atol=1e-11)


def test_matches_reference_odd_size():
    X = MANDRILL[:129, :131]
    t = Transform2d()
    pyr = t.forward(X, nlevels=3)
    rp = RefTransform2d().forward(X.copy(), nlevels=3)
    np.testing.assert_allclose(np.asarray(pyr.lowpass), rp.lowpass,
                               rtol=0, atol=1e-11)
    for lvl in range(3):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   rp.highpasses[lvl], rtol=0, atol=1e-11)


def test_gain_mask_matches_reference():
    X = MANDRILL[:64, :64]
    gain_mask = RNG.rand(6, 3)
    gain_mask[gain_mask < 0.3] = 0.0
    t = Transform2d()
    pyr = t.forward(X, nlevels=3)
    got = np.asarray(t.inverse(pyr, gain_mask=gain_mask))

    rt = RefTransform2d()
    rp = rt.forward(X.copy(), nlevels=3)
    want = rt.inverse(rp, gain_mask=gain_mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_batched_forward_matches_per_image():
    X = RNG.randn(4, 64, 64)
    t = Transform2d()
    pyr = t.forward(X, nlevels=3)
    assert pyr.lowpass.shape[0] == 4
    assert pyr.highpasses[0].shape == (4, 32, 32, 6)
    for i in range(4):
        pi = t.forward(X[i], nlevels=3)
        np.testing.assert_allclose(np.asarray(pyr.lowpass[i]),
                                   np.asarray(pi.lowpass), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(pyr.highpasses[2][i]),
                                   np.asarray(pi.highpasses[2]),
                                   rtol=0, atol=1e-12)
    rec = np.asarray(t.inverse(pyr))
    assert np.abs(rec - X).max() < 1e-12


def test_nlevels_zero():
    X = RNG.randn(32, 32)
    t = Transform2d()
    pyr = t.forward(X, nlevels=0)
    assert pyr.highpasses == ()
    np.testing.assert_allclose(np.asarray(t.inverse(pyr)), X)


def test_float32_roundtrip():
    X = MANDRILL[:256, :256].astype(np.float32)
    t = Transform2d()
    pyr = t.forward(X, nlevels=3)
    assert pyr.lowpass.dtype == np.float32
    assert pyr.highpasses[0].dtype == np.complex64
    rec = np.asarray(t.inverse(pyr))
    assert rec.dtype == np.float32
    assert np.abs(rec - X).max() < 1e-3


def test_integer_input_promotes():
    X = (MANDRILL[:64, :64] * 255).astype(np.uint8)
    t = Transform2d()
    pyr = t.forward(X, nlevels=2)
    rec = np.asarray(t.inverse(pyr))
    assert np.abs(rec - X).max() < 1e-9


def test_jit_roundtrip_composes():
    """forward+inverse compose inside one outer jit (pytree round-trip)."""
    import jax
    t = Transform2d()

    @jax.jit
    def f(x):
        return t.inverse(t.forward(x, nlevels=3))

    X = RNG.randn(64, 64)
    np.testing.assert_allclose(np.asarray(f(X)), X, rtol=0, atol=1e-12)
