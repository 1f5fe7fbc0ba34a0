"""Registration: component parity with the plain NumPy reference and the
upstream behavioral gate (warped error < unwarped error) on a smooth
synthetic frame pair related by a known shift."""

import numpy as np

from dtcwt_tpu import Transform2d
from dtcwt_tpu import registration as reg

from . import oracle
from .oracle import ref as rreg

RefTransform2d = rreg.Transform2d

F1, F2 = oracle.smooth_pair((256, 384), shift=(3, 2))
# crop for component tests (fast); full frames for the behavioral gate
C1, C2 = F1[:128, :192], F2[:128, :192]

T = Transform2d()
RT = RefTransform2d()
P1 = T.forward(C1, nlevels=4)
P2 = T.forward(C2, nlevels=4)
RP1 = RT.forward(C1.copy(), nlevels=4)
RP2 = RT.forward(C2.copy(), nlevels=4)


def test_phasegradient_matches():
    sb1 = np.asarray(P1.highpasses[2][:, :, 1])
    sb2 = np.asarray(P2.highpasses[2][:, :, 1])
    want = rreg.phasegradient(sb1.copy(), sb2.copy(),
                              rreg.EXPECTED_SHIFTS[1, :])
    got = reg.phasegradient(sb1, sb2, reg.EXPECTED_SHIFTS[1, :])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=1e-11)


def test_confidence_matches():
    sb1 = np.asarray(P1.highpasses[2][:, :, 4])
    sb2 = np.asarray(P2.highpasses[2][:, :, 4])
    want = rreg.confidence(sb1.copy(), sb2.copy())
    got = np.asarray(reg.confidence(sb1, sb2))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_qtildematrices_matches():
    want = rreg.qtildematrices(RP1, RP2, [2, 3])
    got = reg.qtildematrices(P1, P2, [2, 3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-8, atol=1e-8)


def test_solvetransform_matches():
    rng = np.random.RandomState(9)
    # build a well-conditioned Qtilde batch from an SPD matrix
    vecs = []
    for _ in range(12):
        M = rng.randn(6, 6)
        Q = M @ M.T + 6 * np.eye(6)
        q = rng.randn(6)
        flat = np.concatenate([Q[np.triu_indices(6)], q])
        vecs.append(flat)
    vecs = np.stack(vecs).reshape(3, 4, 27)
    want = rreg.solvetransform(vecs.copy())
    got = np.asarray(reg.solvetransform(vecs))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_boxfilter_matches():
    rng = np.random.RandomState(2)
    X = rng.randn(16, 12, 3)
    want = rreg.boxfilter(X.copy(), 3)
    got = np.asarray(reg._boxfilter(X, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_velocityfield_and_warp_match():
    rng = np.random.RandomState(4)
    avecs = rng.randn(16, 24, 6) * 0.01
    want_vx, want_vy = rreg.velocityfield(avecs.copy(), C1.shape,
                                          method="bilinear")
    got_vx, got_vy = reg.velocityfield(avecs, C1.shape, method="bilinear")
    np.testing.assert_allclose(np.asarray(got_vx), want_vx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(got_vy), want_vy, rtol=0, atol=1e-10)
    want_w = rreg.warp(C1.copy(), avecs.copy(), method="bilinear")
    got_w = np.asarray(reg.warp(C1, avecs, method="bilinear"))
    np.testing.assert_allclose(got_w, want_w, rtol=0, atol=1e-10)


def test_warphighpass_matches():
    rng = np.random.RandomState(6)
    avecs = rng.randn(8, 12, 6) * 0.01
    Yh = np.asarray(P1.highpasses[1])
    want = rreg.warphighpass(Yh.copy(), avecs.copy(), method="bilinear")
    got = np.asarray(reg.warphighpass(Yh, avecs, method="bilinear"))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_estimatereg_matches_reference():
    """Full pipeline parity on a cropped frame pair."""
    want = rreg.estimatereg(RP1, RP2)
    got = np.asarray(reg.estimatereg(P1, P2))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_estimatereg_accepts_plane_pyramids():
    """Plane-layout pyramids feed estimatereg directly and give the
    interleaved result exactly."""
    q1 = T.forward(C1, nlevels=4, layout="planes")
    q2 = T.forward(C2, nlevels=4, layout="planes")
    want = np.asarray(reg.estimatereg(P1, P2))
    got = np.asarray(reg.estimatereg(q1, q2))
    np.testing.assert_array_equal(got, want)
    # the batched form takes plane pyramids too (leading pair axis)
    qb1 = T.forward(np.stack([C1, C1]), nlevels=4, layout="planes")
    qb2 = T.forward(np.stack([C2, C2]), nlevels=4, layout="planes")
    gb = np.asarray(reg.estimatereg_batched(qb1, qb2))
    # vmapped program: equal to f64 roundoff, not bit-exact
    assert np.abs(gb[0] - want).max() < 1e-10
    assert np.abs(gb[1] - want).max() < 1e-10


def test_estimatereg_behavioral_gate():
    """Upstream test_registration.py:27-37 on the full frame pair."""
    nlevels = 6
    t1 = T.forward(F1, nlevels=nlevels)
    t2 = T.forward(F2, nlevels=nlevels)
    avecs = reg.estimatereg(t1, t2)
    warped_f1 = np.asarray(reg.warp(F1, avecs, method="bilinear"))
    assert np.mean(np.abs(warped_f1 - F2)) < np.mean(np.abs(F1 - F2))


def test_estimatereg_batched_matches_loop():
    """Vmapped pair-batched registration equals the per-pair estimator
    (the device-side analogue of the reference MPI example's worker loop)."""
    import jax
    from dtcwt_tpu.registration import estimatereg, estimatereg_batched

    t = Transform2d()
    frames = np.random.RandomState(11).rand(4, 96, 128)
    pyr = t.forward(frames, nlevels=4)
    take = lambda sl: jax.tree_util.tree_map(lambda x: x[sl], pyr)
    batched = np.asarray(estimatereg_batched(take(slice(None, -1)),
                                             take(slice(1, None))))
    singles = []
    for i in range(3):
        s_p = jax.tree_util.tree_map(lambda x: x[i], pyr)
        r_p = jax.tree_util.tree_map(lambda x: x[i + 1], pyr)
        singles.append(np.asarray(estimatereg(s_p, r_p)))
    singles = np.stack(singles)
    assert batched.shape == singles.shape
    assert np.abs(batched - singles).max() < 1e-10   # f64 under conftest
