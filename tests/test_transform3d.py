"""3-D transform: perfect reconstruction, parity with the reference,
ext_mode 4/8, discard_level_1, Haar (even-length) filters, batching.
(Reference tests: test_xfm3.py.)"""

import numpy as np
import pytest

from dtcwt_tpu.transforms.transform3d import Transform3d

from . import oracle
from .oracle import ref

RefTransform3d = ref.Transform3d

RNG = np.random.RandomState(5)


def _ellipsoid(n=32):
    grid = slice(-(n >> 1), (n >> 1))
    X, Y, Z = np.mgrid[grid, grid, grid]
    r = np.sqrt(X * X + (1.2 * Y) ** 2 + (1.4 * Z) ** 2)
    return np.where(r <= 0.4 * n, 1.0, 0.0).astype(np.float64)


ELLIPSOID = _ellipsoid()


def _haar():
    h0 = np.array((1.0, 1.0))
    h0 = h0 / h0.sum()
    g0 = h0
    h1 = g0 * np.cumprod(-np.ones_like(g0))
    g1 = -h0 * np.cumprod(-np.ones_like(h0))
    return (h0, g0, h1, g1)


def test_roundtrip_default():
    t = Transform3d()
    pyr = t.forward(ELLIPSOID, nlevels=4)
    rec = np.asarray(t.inverse(pyr))
    assert rec.shape == ELLIPSOID.shape
    assert np.abs(rec - ELLIPSOID).max() < 1e-12


def test_roundtrip_haar_level1():
    t = Transform3d(biort=_haar())
    pyr = t.forward(ELLIPSOID, nlevels=1)
    rec = np.asarray(t.inverse(pyr))
    assert rec.size == ELLIPSOID.size
    assert np.abs(rec - ELLIPSOID).max() < 1e-12


@pytest.mark.parametrize("ext_mode,shape", [(4, (30, 32, 34)), (8, (28, 32, 36))])
def test_roundtrip_ext_modes_awkward_shapes(ext_mode, shape):
    X = RNG.randn(*shape)
    t = Transform3d(ext_mode=ext_mode)
    pyr = t.forward(X, nlevels=4)
    rec = np.asarray(t.inverse(pyr))
    assert rec.shape == X.shape
    assert np.abs(rec - X).max() < 1e-12


def test_matches_reference_forward_and_inverse():
    X = RNG.randn(32, 32, 32)
    t = Transform3d(biort="near_sym_b", qshift="qshift_b")
    rt = RefTransform3d(biort="near_sym_b", qshift="qshift_b")
    pyr = t.forward(X, nlevels=3, include_scale=True)
    rp = rt.forward(X.copy(), nlevels=3, include_scale=True)
    np.testing.assert_allclose(np.asarray(pyr.lowpass), rp.lowpass,
                               rtol=0, atol=1e-11)
    for lvl in range(3):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   rp.highpasses[lvl], rtol=0, atol=1e-11)
        np.testing.assert_allclose(np.asarray(pyr.scales[lvl]),
                                   rp.scales[lvl], rtol=0, atol=1e-11)
    rec = np.asarray(t.inverse(pyr))
    ref_rec = rt.inverse(rp)
    np.testing.assert_allclose(rec, ref_rec, rtol=0, atol=1e-11)


def test_matches_reference_ext_mode8():
    X = RNG.randn(28, 32, 36)
    t = Transform3d(ext_mode=8)
    rt = RefTransform3d(ext_mode=8)
    pyr = t.forward(X, nlevels=3)
    rp = rt.forward(X.copy(), nlevels=3)
    np.testing.assert_allclose(np.asarray(pyr.lowpass), rp.lowpass,
                               rtol=0, atol=1e-11)
    for lvl in range(3):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   rp.highpasses[lvl], rtol=0, atol=1e-11)


def test_discard_level_1():
    t = Transform3d()
    pyr = t.forward(ELLIPSOID, nlevels=4, discard_level_1=True)
    assert pyr.highpasses[0] is None
    pyr2 = t.forward(ELLIPSOID, nlevels=4)
    for lvl in range(1, 4):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   np.asarray(pyr2.highpasses[lvl]),
                                   rtol=0, atol=1e-12)
    # The inverse treats None as zero.  (We do not compare against the
    # reference here: its _level1_ifm_no_highpass has a missing transpose,
    # transform3d.py:456, which silently transposes slices on cube volumes.
    # Use the reference's own behavioral gate instead, test_xfm3.py:152-159.)
    rec = np.asarray(t.inverse(pyr))
    assert rec.shape == ELLIPSOID.shape
    assert np.median(np.abs(rec - ELLIPSOID)) < 1e-3


def test_shape_contract_errors():
    with pytest.raises(ValueError):
        Transform3d(ext_mode=4).forward(RNG.randn(31, 32, 32), nlevels=1)
    with pytest.raises(ValueError):
        Transform3d(ext_mode=8).forward(RNG.randn(30, 32, 32), nlevels=1)
    with pytest.raises(ValueError):
        Transform3d(ext_mode=3)


def test_batched_volumes():
    X = RNG.randn(2, 16, 16, 16)
    t = Transform3d()
    pyr = t.forward(X, nlevels=2)
    assert pyr.highpasses[0].shape == (2, 8, 8, 8, 28)
    rec = np.asarray(t.inverse(pyr))
    assert np.abs(rec - X).max() < 1e-12
    p0 = t.forward(X[0], nlevels=2)
    np.testing.assert_allclose(np.asarray(pyr.highpasses[1][0]),
                               np.asarray(p0.highpasses[1]),
                               rtol=0, atol=1e-12)


def test_qbgn_matches_reference():
    X = oracle.qbgn()[:32, :32, :32]
    t = Transform3d()
    rt = RefTransform3d()
    pyr = t.forward(X, nlevels=3)
    rp = rt.forward(X.copy(), nlevels=3)
    np.testing.assert_allclose(np.asarray(pyr.lowpass), rp.lowpass,
                               rtol=0, atol=1e-9)
    for lvl in range(3):
        np.testing.assert_allclose(np.asarray(pyr.highpasses[lvl]),
                                   rp.highpasses[lvl], rtol=0, atol=1e-9)
