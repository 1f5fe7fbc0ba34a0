"""Multi-chip DTCWT image registration.

``estimatereg``'s cost is dominated by the per-pixel 27-element Qtilde
outer products over 6 subbands x levels, reduced into one global 27-vector
(upstream ``dtcwt/registration.py:346-350`` — "literally a
psum" per SURVEY.md §5).  Both stages are data-parallel over pixels, so the
multi-chip version is the idiomatic JAX SPMD recipe: place the pyramid
leaves on a :class:`jax.sharding.Mesh` with their row axis sharded, jit the
*unchanged* estimator, and let XLA's partitioner split the elementwise
phase/confidence math across devices, exchange the one-pixel neighbour
halos, and lower the global reductions to ``psum``.  The warp /
rescale stages of the refinement schedule run on gathered coarse levels
(they are 1/16 the pixels or less — SURVEY §7.6's "all_gather the coarse
levels" plan).

Numerically identical to :func:`dtcwt_tpu.registration.estimatereg`; tests
assert f64 equality on a virtual 8-device CPU mesh.

Why rows-only sharding suffices here (r2 verdict item 9): the Qt stage —
phasegradient, confidence and the 27-element outer products — is fully
data-parallel over pixels, so *any* pixel partition balances it; a 1-D row
split already gives each of R chips 1/R of the work, and GSPMD needs only
the one-pixel ``jnp.roll`` halos along the cut axis (a 2-D split would halve
per-chip halo bytes but add a second collective per level — noise next to
the Qt FLOPs).  The stages a 2-D mesh cannot help are the sequential-
schedule refine loop's warp + ``rescale(_boxfilter(...))`` on the avecs
grid (typically 32x32x6 — smaller than one Mosaic tile) and the 6x6
``solvetransform`` solves, which are replicated-cheap.  So the parallel
fraction is row-shardable in full, and the residual is too small to shard:
Amdahl, not implementation debt.  ``shard_pyramid_rows`` warns if a
non-trivial level cannot actually shard (row count not divisible by the
mesh), so the degradation is never silent.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dtcwt_tpu import registration as _reg
from dtcwt_tpu.transforms.pyramid import Pyramid

__all__ = ["estimatereg_sharded", "shard_pyramid_rows"]

logger = logging.getLogger(__name__)


def shard_pyramid_rows(pyr: Pyramid, mesh, rows_axis: str = "rows"):
    """Place a pyramid's leaves on *mesh* with image rows sharded over
    *rows_axis* (highpasses ``[H', W', 6]``, lowpass ``[H, W]``).  Levels
    whose row count does not divide the mesh axis are replicated instead —
    in practice only the tiny coarse levels, which carry negligible work.
    A level that replicates despite being at least ``4 * R`` rows tall (a
    real loss of parallelism, not a tiny coarse level) logs one warning,
    matching the transforms' degraded-sharding contract
    (``transform2d_dist._warn_degraded``)."""
    R = mesh.shape[rows_axis]

    def put(a, sharded_spec, what=None):
        if a is None:
            return None
        a = jnp.asarray(a)
        sharded = a.shape[0] % R == 0
        spec = sharded_spec if sharded else P()
        if not sharded and what is not None and a.shape[0] >= 4 * R:
            logger.warning(
                "shard_pyramid_rows: %s with %d rows does not divide the "
                "%d-shard %r mesh axis — it runs replicated (degraded "
                "sharding). Pad the image so every level's row count "
                "divides the mesh.", what, a.shape[0], R, rows_axis)
        return jax.device_put(a, NamedSharding(mesh, spec))

    hp_spec = P(rows_axis, None, None)
    img_spec = P(rows_axis, None)
    return Pyramid(
        put(pyr.lowpass, img_spec, "lowpass"),
        tuple(put(h, hp_spec, "highpass level %d" % i)
              for i, h in enumerate(pyr.highpasses)),
        None if pyr.scales is None
        else tuple(put(s, img_spec) for s in pyr.scales))


def estimatereg_sharded(source, reference, mesh, regshape=None, levels=None,
                        rows_axis: str = "rows"):
    """Estimate the registration of *source* onto *reference* with the
    pyramid pixels sharded over ``mesh[rows_axis]``.

    *source* / *reference* are single-image :class:`Pyramid` objects (host
    or device arrays); they are re-placed row-sharded and the whole
    estimator runs as one jit-compiled SPMD program.  The returned avecs
    field is replicated on every device and equals the single-device
    :func:`dtcwt_tpu.registration.estimatereg` result.  Plane-layout
    pyramids are accepted and converted at the boundary.
    """
    from dtcwt_tpu.transforms.pyramid import PlanePyramid
    if isinstance(source, PlanePyramid):
        source = source.interleaved()
    if isinstance(reference, PlanePyramid):
        reference = reference.interleaved()
    src = shard_pyramid_rows(source, mesh, rows_axis)
    ref = shard_pyramid_rows(reference, mesh, rows_axis)

    nlevels = len(src.highpasses)
    if regshape is None:
        if nlevels < 4:
            raise ValueError(
                "estimatereg_sharded's default registration grid is the "
                "level-4 subband shape, but the pyramid has only %d "
                "level%s; either transform with nlevels >= 4 or pass "
                "regshape explicitly."
                % (nlevels, "" if nlevels == 1 else "s"))
        avecs_shape = tuple(src.highpasses[3].shape[:2]) + (6,)
    else:
        avecs_shape = tuple(regshape[:2]) + (6,)
    if levels is None:
        levels = _reg._default_levels(nlevels)
    levels_key = tuple(tuple(int(l) for l in lv) for lv in levels)

    impl = _reg._estimatereg_impl(avecs_shape, levels_key)
    fn = jax.jit(impl, out_shardings=NamedSharding(mesh, P()))
    return fn(src, ref)
