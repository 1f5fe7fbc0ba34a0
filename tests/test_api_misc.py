"""API surface: compat wrappers, backend stack shim, coeffs errors, utils,
keypoints (reference tests: test_coeffs.py, test_switchbackends.py,
test_utils.py, test_import.py)."""

import numpy as np
import pytest

import dtcwt_tpu
from dtcwt_tpu import biort, qshift, compat, utils
from dtcwt_tpu.keypoint import find_keypoints

from .oracle import ref


def test_import_surface():
    for name in ("Transform1d", "Transform2d", "Transform3d", "Pyramid",
                 "biort", "qshift", "push_backend", "pop_backend",
                 "preserve_backend_stack", "backend_name"):
        assert hasattr(dtcwt_tpu, name), name


def test_coeffs_shapes_and_errors():
    h0o, g0o, h1o, g1o = biort("near_sym_a")
    assert h0o.shape == (5, 1) and h1o.shape == (7, 1)
    assert len(biort("near_sym_b_bp")) == 6
    assert len(qshift("qshift_b_bp")) == 12
    with pytest.raises(IOError):
        biort("this-does-not-exist")
    with pytest.raises(IOError):
        qshift("this-does-not-exist")
    with pytest.raises(ValueError):
        biort("qshift_a")
    with pytest.raises(ValueError):
        qshift("near_sym_a")


def test_coeffs_match_reference():
    for name in dtcwt_tpu.BIORT_NAMES:
        for a, b in zip(biort(name), ref.biort(name)):
            np.testing.assert_array_equal(np.asarray(a).ravel(), b)
    for name in dtcwt_tpu.QSHIFT_NAMES:
        for a, b in zip(qshift(name), ref.qshift(name)):
            np.testing.assert_array_equal(np.asarray(a).ravel(), b)


def test_backend_stack():
    assert dtcwt_tpu.backend_name == "xla"
    dtcwt_tpu.push_backend("numpy")
    assert dtcwt_tpu.backend_name == "numpy"
    dtcwt_tpu.pop_backend()
    assert dtcwt_tpu.backend_name == "xla"
    with pytest.raises(IndexError):
        dtcwt_tpu.pop_backend()
    with pytest.raises(KeyError):
        dtcwt_tpu.push_backend("not-a-backend")
    # exception safety
    try:
        with dtcwt_tpu.preserve_backend_stack():
            dtcwt_tpu.push_backend("tf")
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert dtcwt_tpu.backend_name == "xla"


def test_compat_1d_2d_3d():
    rng = np.random.RandomState(0)
    x1 = rng.randn(64)
    Yl, Yh = compat.dtwavexfm(x1, 3)
    z = np.asarray(compat.dtwaveifm(Yl, Yh))
    assert np.abs(z - x1).max() < 1e-12

    x2 = rng.randn(64, 64)
    Yl, Yh, Yscale = compat.dtwavexfm2(x2, 3, include_scale=True)
    assert len(Yscale) == 3
    z = np.asarray(compat.dtwaveifm2(Yl, Yh))
    assert np.abs(z - x2).max() < 1e-12
    assert compat.dtwavexfm2b is compat.dtwavexfm2

    x3 = rng.randn(16, 16, 16)
    Yl, Yh = compat.dtwavexfm3(x3, 2)
    z = np.asarray(compat.dtwaveifm3(Yl, Yh))
    assert np.abs(z - x3).max() < 1e-12


def test_reflect_matches_reference():
    x = np.arange(-20, 60, dtype=np.float64)
    np.testing.assert_array_equal(
        np.asarray(utils.reflect(x, -0.5, 9.5)), ref.reflect(x, -0.5, 9.5))


def test_drawedge_drawcirc_match_reference():
    rde, rdc = ref.drawedge, ref.drawcirc
    got = utils.drawedge(30, np.array([32, 32]), 4, 64)
    want = rde(30, np.array([32, 32]), 4, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got = utils.drawcirc(20, 4, 2, -3, 64)
    want = rdc(20, 4, 2, -3, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_unpack():
    from dtcwt_tpu import Pyramid, Transform2d
    p = Transform2d().forward(np.random.RandomState(1).randn(32, 32), 2,
                              include_scale=True)
    yl, yh, ys = utils.unpack(p)
    assert yh is p.highpasses and ys is p.scales
    p2 = Pyramid(p.lowpass, p.highpasses)
    assert len(list(utils.unpack(p2))) == 2


def test_find_keypoints():
    img = utils.drawcirc(20, 4, 0, 0, 128) + \
        0.01 * np.random.RandomState(7).randn(128, 128)
    from dtcwt_tpu import Transform2d
    pyr = Transform2d().forward(img, nlevels=4)
    for method in ("fauqueur", "bendale", "kingsbury"):
        kps = find_keypoints(pyr.highpasses, method=method, max_points=10)
        assert kps.shape[1] == 4
        assert kps.shape[0] <= 10
        # energies sorted descending
        assert np.all(np.diff(kps[:, 3]) <= 1e-12)
        # keypoints are inside the image
        assert kps[:, 0].min() >= -0.5 and kps[:, 0].max() <= 127.5
    with pytest.raises(ValueError):
        find_keypoints(pyr.highpasses, method="nope")


def test_find_keypoints_matches_reference():
    rkp = ref
    img = utils.drawcirc(20, 4, 0, 0, 128)
    from dtcwt_tpu import Transform2d
    pyr = Transform2d().forward(img, nlevels=4)
    hp = tuple(np.asarray(h) for h in pyr.highpasses)
    want = rkp.find_keypoints(hp, max_points=20)
    got = find_keypoints(pyr.highpasses, max_points=20)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)
    # unbounded path too (host gather instead of device top_k)
    want_all = rkp.find_keypoints(hp)
    got_all = find_keypoints(pyr.highpasses)
    assert got_all.shape == want_all.shape
    np.testing.assert_allclose(got_all, want_all, rtol=1e-7, atol=1e-9)


def test_find_keypoints_empty():
    """No detected maxima must yield an empty (0, 4) result, not a crash
    (r1 VERDICT: ``kps = None`` reached ``kps[np.argsort...]``)."""
    from dtcwt_tpu import Transform2d
    img = np.zeros((64, 64))     # constant image: no refined maxima survive
    pyr = Transform2d().forward(img, nlevels=3)
    kps = find_keypoints(pyr.highpasses)
    assert kps.shape == (0, 4)
    # all levels skipped
    kps2 = find_keypoints(pyr.highpasses, skip_levels=len(pyr.highpasses))
    assert kps2.shape == (0, 4)
    # threshold above every energy
    kps3 = find_keypoints(pyr.highpasses, threshold=1e9, max_points=5)
    assert kps3.shape == (0, 4)
