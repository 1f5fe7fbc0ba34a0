"""DTCWT-based phase image registration (2-D).

Implements the locally-affine motion estimator of Chen & Kingsbury
("Efficient Registration of Nonrigid 3-D Bodies", IEEE TIP 2012; 2-D form),
with behavioral parity surface upstream ``dtcwt/registration.py``
(EXPECTED_SHIFTS :30, phasegradient :32-76, confidence :84-136,
qtildematrices :141-212, solvetransform :214-249, warptransform :274-302,
estimatereg :304-372, velocityfield :374-395, warphighpass :397-409, warp
:411-420, _boxfilter :422-446).

Device-side design: the entire ``estimatereg`` schedule — initial global solve
plus every refinement stage (warp -> Qtilde accumulation -> box filter ->
rescale -> batched 6x6 solve) — compiles into ONE XLA program per pyramid
shape; the level schedule is static Python, per-pixel 27-element outer
products are a vectorized einsum, and the global Qt accumulation is a plain
sum that becomes a ``psum`` when the caller shards pixels over a mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from dtcwt_tpu import sampling
from dtcwt_tpu.transforms.pyramid import Pyramid
from dtcwt_tpu.utils import reflect

__all__ = [
    "estimatereg", "estimatereg_batched", "velocityfield", "warp", "warptransform",
    "warphighpass", "phasegradient", "confidence", "qtildematrices",
    "solvetransform", "normsample", "normsamplehighpass",
    "EXPECTED_SHIFTS",
]

#: Expected horizontal/vertical phase shift per subband of the 2-D transform
EXPECTED_SHIFTS = np.array(
    ((-1, -3), (-3, -3), (-3, -1), (-3, 1), (-3, 3), (-1, 3))) * np.pi / 2.15

_TRIU_R, _TRIU_C = np.triu_indices(6)
_TRIU_FLAT = np.ravel_multi_index(np.triu_indices(6), (6, 6))


def phasegradient(sb1, sb2, w=None):
    """d/dy, d/dx, d/dt phase gradients of a subband pair, de-rotated by the
    expected per-pixel shift *w* (reference: registration.py:32-76)."""
    if w is None:
        w = (0.0, 0.0)
    sb1, sb2 = jnp.asarray(sb1), jnp.asarray(sb2)
    if sb1.shape != sb2.shape:
        raise ValueError("Subbands should have identical size")
    rdt = jnp.real(sb1).dtype

    S = (sb1[:, 1:] * jnp.conj(sb1[:, :-1])
         + sb2[:, 1:] * jnp.conj(sb2[:, :-1])) * jnp.exp(
             jnp.asarray(-1j * w[0], sb1.dtype))
    dx = jnp.concatenate((
        jnp.angle(S[:, :1]),
        jnp.angle(0.5 * (S[:, :-1] + S[:, 1:])),
        jnp.angle(S[:, -1:])), axis=1) + jnp.asarray(w[0], rdt)

    S = (sb1[1:, :] * jnp.conj(sb1[:-1, :])
         + sb2[1:, :] * jnp.conj(sb2[:-1, :])) * jnp.exp(
             jnp.asarray(-1j * w[1], sb1.dtype))
    dy = jnp.concatenate((
        jnp.angle(S[:1, :]),
        jnp.angle(0.5 * (S[:-1, :] + S[1:, :])),
        jnp.angle(S[-1:, :])), axis=0) + jnp.asarray(w[1], rdt)

    dt = jnp.angle(sb2 * jnp.conj(sb1))
    return dy, dx, dt


def _edge_pad1(sb):
    """Replicate-pad by one pixel on every side."""
    sb = jnp.concatenate((sb[:, :1], sb, sb[:, -1:]), axis=1)
    return jnp.concatenate((sb[:1, :], sb, sb[-1:, :]), axis=0)


def confidence(sb1, sb2, epsilon=1e-6):
    """Confidence weight per pixel from the four diagonal neighbours
    (reference: registration.py:84-136)."""
    sb1, sb2 = jnp.asarray(sb1), jnp.asarray(sb2)
    if sb1.shape != sb2.shape:
        raise ValueError("Subbands should have identical size")
    us, vs = _edge_pad1(sb1), _edge_pad1(sb2)
    us3 = jnp.abs(us) ** 3
    vs3 = jnp.abs(vs) ** 3
    prod = jnp.conj(us) * vs

    numerator = 0.0
    denominator = epsilon
    for region in ((slice(0, -2), slice(0, -2)), (slice(0, -2), slice(2, None)),
                   (slice(2, None), slice(0, -2)), (slice(2, None), slice(2, None))):
        numerator = numerator + prod[region]
        denominator = denominator + us3[region] + vs3[region]
    return jnp.abs(numerator) ** 2 / denominator


def _qtilde_level(hp1, hp2):
    """NxMx27 Qtilde accumulation over the 6 subbands of one level."""
    h, w = hp1.shape[0], hp1.shape[1]
    xs, ys = np.meshgrid(np.arange(0, 1, 1 / w), np.arange(0, 1, 1 / h))
    rdt = jnp.real(hp1).dtype
    xs = jnp.asarray(xs, rdt)
    ys = jnp.asarray(ys, rdt)

    total = None
    for subband in range(hp1.shape[2]):
        sb1, sb2 = hp1[:, :, subband], hp2[:, :, subband]
        C_d = confidence(sb1, sb2)
        dy, dx, dt = phasegradient(sb1, sb2, EXPECTED_SHIFTS[subband, :])
        dx = dx * w
        dy = dy * h
        tmp = jnp.stack((dx, dy, xs * dx, xs * dy, ys * dx, ys * dy, -dt),
                        axis=-1)                       # [..., 7]
        outer = tmp[..., :, None] * tmp[..., None, :]  # [..., 7, 7]
        Qt = jnp.concatenate(
            (outer[..., _TRIU_R, _TRIU_C],             # 21 upper-tri of Q
             outer[..., :6, 6]), axis=-1)              # 6-vector q
        Qt = Qt * (C_d ** 2)[..., None]
        total = Qt if total is None else total + Qt
    return total


def qtildematrices(t_ref, t_target, levels):
    r"""Per-pixel :math:`\tilde{Q}` matrices (NxMx27) for each level index in
    *levels* (reference: registration.py:141-212)."""
    return tuple(_qtilde_level(t_ref.highpasses[level],
                               t_target.highpasses[level])
                 for level in levels)


def solvetransform(Qtilde_vec):
    r"""Solve :math:`a = -Q^{-1} q` from packed 27-vectors, batched over any
    leading dims (reference: registration.py:214-249; like the reference,
    only the upper triangle of Q is populated)."""
    Qtilde_vec = jnp.asarray(Qtilde_vec)
    lead = Qtilde_vec.shape[:-1]
    Q = jnp.zeros(lead + (36,), Qtilde_vec.dtype)
    Q = Q.at[..., _TRIU_FLAT].set(Qtilde_vec[..., :21])
    Q = Q.reshape(lead + (6, 6))
    q = Qtilde_vec[..., -6:]
    return jnp.linalg.solve(Q, -q[..., None])[..., 0]


def normsample(Yh, xs, ys, method=None):
    """Sample with coordinates normalised to unit width/height."""
    return sampling.sample(Yh, xs * Yh.shape[1], ys * Yh.shape[0],
                           method=method)


def normsamplehighpass(Yh, xs, ys, method=None):
    """Highpass sampling with unit-normalised coordinates."""
    return sampling.sample_highpass(Yh, xs * Yh.shape[1], ys * Yh.shape[0],
                                    method=method)


def velocityfield(avecs, shape, method=None):
    """x/y velocity component fields (unit-normalised) of size *shape*
    implied by the local affine parameters *avecs*."""
    h, w = avecs.shape[:2]
    pxs, pys = np.meshgrid(np.arange(w, dtype=np.float32) / w,
                           np.arange(h, dtype=np.float32) / h)
    vxs = avecs[:, :, 0] + avecs[:, :, 2] * pxs + avecs[:, :, 4] * pys
    vys = avecs[:, :, 1] + avecs[:, :, 3] * pxs + avecs[:, :, 5] * pys
    vxs = sampling.rescale(vxs, shape, method=method)
    vys = sampling.rescale(vys, shape, method=method)
    return vxs, vys


def warphighpass(Yh, avecs, method=None):
    """Warp a highpass subband stack along the velocity field implied by
    *avecs* (phase de-rotation handled by the sampler)."""
    X, Y = np.meshgrid(np.arange(Yh.shape[1], dtype=np.float32) / Yh.shape[1],
                       np.arange(Yh.shape[0], dtype=np.float32) / Yh.shape[0])
    vxs, vys = velocityfield(avecs, Yh.shape, method=method)
    return normsamplehighpass(Yh, X + vxs, Y + vys, method=method)


def warp(I, avecs, method=None):
    """Warp a real image along the velocity field implied by *avecs*."""
    I = jnp.asarray(I)
    X, Y = np.meshgrid(np.arange(I.shape[1], dtype=np.float32) / I.shape[1],
                       np.arange(I.shape[0], dtype=np.float32) / I.shape[0])
    vxs, vys = velocityfield(avecs, I.shape, method=method)
    return normsample(I, X + vxs, Y + vys, method=method)


def warptransform(t, avecs, levels, method=None):
    """Warp the given *levels* of a transformed image (shallow clone of the
    rest; reference: registration.py:274-302)."""
    warped_highpasses = list(t.highpasses)
    for level in levels:
        warped_highpasses[level] = warphighpass(
            warped_highpasses[level], avecs, method=method)
    return Pyramid(t.lowpass, tuple(warped_highpasses), t.scales)


def _shift_reflect(X, delta: int, axis: int):
    """X shifted by *delta* along *axis* with symmetric-reflect boundary —
    static slices + a small edge flip (a reflect-index ``take`` would lower
    to a gather)."""
    n = X.shape[axis]
    sl = lambda a, b: jax.lax.slice_in_dim(X, a, b, axis=axis)
    if delta > 0:
        return jnp.concatenate(
            [sl(delta, n), jnp.flip(sl(n - delta, n), axis=axis)], axis=axis)
    d = -delta
    return jnp.concatenate(
        [jnp.flip(sl(0, d), axis=axis), sl(0, n - d)], axis=axis)


def _boxfilter(X, kernel_size):
    """Separable odd-sized box filter with reflect boundary (reference:
    registration.py:422-446)."""
    if kernel_size % 2 == 0:
        raise ValueError("Kernel size must be odd")
    for axis_idx in range(2):
        out = X
        for delta in range(1, 1 + (kernel_size - 1) // 2):
            for sgn in (+1, -1):
                out = out + _shift_reflect(X, sgn * delta, axis_idx)
        X = out / kernel_size
    return X


def _default_levels(nlevels):
    levels = [[x for x in range(nlevels - 1, nlevels - 3, -1) if x >= 0]]
    for s in np.arange(nlevels - 1, 0, -0.5):
        refine_levels = [int(np.floor(s)) - x for x in range(2) if s - x >= 2]
        if len(refine_levels) < 2:
            continue
        levels.append(refine_levels)
    return levels


def estimatereg(source, reference, regshape=None, levels=None):
    """Estimate the registration mapping *source* onto *reference*.

    Both arguments are transformed :class:`Pyramid` (or plane-layout
    :class:`PlanePyramid`) instances.  Returns an ``NxMx6`` array of local
    affine parameters (one per 8x8 block by default); feed it to
    :func:`velocityfield` / :func:`warp`.  The whole multi-stage estimator
    compiles into a single XLA program per pyramid configuration.
    """
    from dtcwt_tpu.transforms.pyramid import PlanePyramid
    if isinstance(source, PlanePyramid):
        source = source.interleaved()
    if isinstance(reference, PlanePyramid):
        reference = reference.interleaved()
    nlevels = len(source.highpasses)
    if regshape is None:
        if nlevels < 4:
            raise ValueError(
                "estimatereg's default registration grid is the level-4 "
                "subband shape, but the pyramid has only %d level%s; either "
                "transform with nlevels >= 4 or pass regshape explicitly."
                % (nlevels, "" if nlevels == 1 else "s"))
        avecs_shape = tuple(source.highpasses[3].shape[:2]) + (6,)
    else:
        avecs_shape = tuple(regshape[:2]) + (6,)
    if levels is None:
        levels = _default_levels(nlevels)
    levels_key = tuple(tuple(int(l) for l in lv) for lv in levels)
    shapes_key = tuple(tuple(h.shape) for h in source.highpasses)
    fn = _estimatereg_jit(avecs_shape, levels_key, shapes_key)
    return fn(source, reference)


def estimatereg_batched(source, reference, regshape=None, levels=None):
    """Batched :func:`estimatereg`: *source*/*reference* are Pyramids whose
    leaves carry a leading pair axis (e.g. every neighbouring frame pair of
    a video GOP); returns ``[P, N, M, 6]`` affine parameter fields.  The
    whole pair batch compiles into one vmapped XLA program — the device-side
    analogue of the reference MPI example's per-worker frame loop
    (``examples/register_video.py:74-86``)."""
    from dtcwt_tpu.transforms.pyramid import PlanePyramid
    if isinstance(source, PlanePyramid):
        source = source.interleaved()
    if isinstance(reference, PlanePyramid):
        reference = reference.interleaved()
    nlevels = len(source.highpasses)
    if regshape is None:
        if nlevels < 4:
            raise ValueError(
                "estimatereg_batched's default registration grid is the "
                "level-4 subband shape, but the pyramid has only %d "
                "level%s; either transform with nlevels >= 4 or pass "
                "regshape explicitly."
                % (nlevels, "" if nlevels == 1 else "s"))
        avecs_shape = tuple(source.highpasses[3].shape[-3:-1]) + (6,)
    else:
        avecs_shape = tuple(regshape[:2]) + (6,)
    if levels is None:
        levels = _default_levels(nlevels)
    levels_key = tuple(tuple(int(l) for l in lv) for lv in levels)
    shapes_key = tuple(tuple(h.shape[1:]) for h in source.highpasses)
    fn = _estimatereg_batched_jit(avecs_shape, levels_key, shapes_key)
    return fn(source, reference)


@functools.lru_cache(maxsize=None)
def _estimatereg_batched_jit(avecs_shape, levels, shapes_key):
    impl = _estimatereg_impl(avecs_shape, levels)
    return jax.jit(jax.vmap(impl))


@functools.lru_cache(maxsize=None)
def _estimatereg_jit(avecs_shape, levels, shapes_key):
    return jax.jit(_estimatereg_impl(avecs_shape, levels))


def _estimatereg_impl(avecs_shape, levels):
    def impl(source, reference):
        # Initial global affine estimate from the coarsest level pair.
        Qt = sum(jnp.sum(x, axis=(0, 1))
                 for x in qtildematrices(source, reference, levels[0]))
        a = solvetransform(Qt)
        avecs = jnp.broadcast_to(a, avecs_shape).astype(a.dtype)

        # Refinement schedule: warp current estimate, re-accumulate Qtilde,
        # smooth, rescale to the avecs grid and solve per block.
        for est_levels in levels[1:]:
            warped = warptransform(source, avecs, est_levels,
                                   method="bilinear")
            all_qts = qtildematrices(warped, reference, est_levels)
            if len(all_qts) < 1:
                continue
            qts = 0.0
            for x in all_qts:
                qts = qts + sampling.rescale(_boxfilter(x, 3),
                                             avecs_shape[:2],
                                             method="bilinear")
            avecs = avecs + solvetransform(qts)
        return avecs

    return impl
