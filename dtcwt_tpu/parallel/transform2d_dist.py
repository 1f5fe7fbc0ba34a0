"""Multi-chip 2-D DTCWT: batch data-parallel + 2-D spatial sharding.

The global transform is numerically IDENTICAL to
:class:`dtcwt_tpu.transforms.transform2d.Transform2d` (same boundary rules,
same subband packing); tests assert bit-level equality between the sharded
and single-device paths on a virtual CPU mesh.  Design (SURVEY.md §2
parallelism table, §7 step 5 — "shard H (and W) of the image across mesh
axes"):

* mesh ``('data', 'rows'[, 'cols'])`` — batch over ``data``, image rows over
  ``rows`` and (optionally) image columns over ``cols``;
* before each level's column (height-axis) pass, shards exchange
  filter-support halos (width = biort ``len(h)//2`` at level 1, qshift
  ``len(h)`` at levels >= 2) with ``lax.ppermute`` along ``rows``;
  the row (width-axis) pass does the same along ``cols``.  Only the physical
  image edges apply the reflect boundary rule;
* once a decimated axis becomes too small to shard cleanly (local extent not
  a multiple of 4, smaller than the halo, or a global mult-of-4 pad is
  required), that axis is ``all_gather``-ed and the remaining coarse levels
  run unsharded along it — they are tiny.  The two spatial axes degrade
  independently.

Alignment argument: each shard's local filter pass equals the global one
because local extents stay multiples of 4 while sharded, so every shard's
polyphase/quarter-phase grids coincide with the global grids.
"""

from __future__ import annotations

import functools
import logging
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from dtcwt_tpu.ops import fb
from dtcwt_tpu.ops.packing import c2q, c2q_planes
from dtcwt_tpu.parallel.halo import halo_exchange
from dtcwt_tpu.transforms.pyramid import (Pyramid, PlanePyramid,
                                          PLANE_BAND_ORDER, _PLANE_POS)
from dtcwt_tpu.transforms.transform2d import (
    DEFAULT_BIORT, DEFAULT_QSHIFT, Transform2d, normalize_biort,
    normalize_qshift, _pack_bands, _pack_band_planes)
from dtcwt_tpu.utils import compute_view as _comp

__all__ = ["ShardedTransform2d"]

logger = logging.getLogger(__name__)


def _axis_plan(extent: int, R: int, nlevels: int, halo1: int,
               halo2: int) -> List[bool]:
    """Per level: does the filter pass along this image axis run sharded
    over a mesh axis of size *R*?  Simulates the level shape evolution of
    ``Transform2d`` (odd-size extension, per-level mult-of-4 padding —
    reference ``numpy/transform2d.py:84-94,134-140``)."""
    plan = []
    n = extent + (extent % 2)
    sharded = extent % 2 == 0          # odd global size can't be sharded
    for level in range(nlevels):
        if level == 0:
            sharded = (sharded and n % R == 0 and (n // R) % 2 == 0
                       and (n // R) >= halo1)
            plan.append(sharded)
            nl = n                      # lowpass keeps the full extent
        else:
            need_pad = nl % 4 != 0
            sharded = (sharded and not need_pad and nl % R == 0
                       and (nl // R) % 4 == 0 and (nl // R) >= halo2)
            plan.append(sharded)
            if need_pad:
                nl += 2
            nl >>= 1
    return plan


class ShardedTransform2d:
    """An n-level 2-D DTCWT over a device mesh.

    :param mesh: a :class:`jax.sharding.Mesh` with a batch axis, a row axis
        and (optionally) a column axis.
    :param biort, qshift: wavelets, as for :class:`Transform2d`.
    :param cols_axis: name of the mesh axis sharding image columns, or
        ``None`` (default) for row-only spatial decomposition.

    ``forward``/``inverse`` accept and produce global ``[B, H, W]`` arrays /
    Pyramids; per-device layout is managed internally via ``shard_map``.
    """

    def __init__(self, mesh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 data_axis: str = "data", rows_axis: str = "rows",
                 cols_axis: Optional[str] = None):
        self.mesh = mesh
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        self.data_axis = data_axis
        self.rows_axis = rows_axis
        self.cols_axis = cols_axis
        if data_axis not in mesh.axis_names or rows_axis not in mesh.axis_names:
            raise ValueError("mesh must define axes %r and %r"
                             % (data_axis, rows_axis))
        if cols_axis is not None and cols_axis not in mesh.axis_names:
            raise ValueError("mesh does not define cols axis %r" % (cols_axis,))
        self._nrows = mesh.shape[rows_axis]
        self._ncols = mesh.shape[cols_axis] if cols_axis else 1
        # Reference single-device implementation used for the replicated
        # coarse-level fallback (same filters).
        self._single = Transform2d(self.biort, self.qshift)

    # ------------------------------------------------------------------
    # static planning: which levels stay sharded, per spatial axis?
    # ------------------------------------------------------------------
    def _halos(self) -> Tuple[int, int]:
        halo1 = max(v.size // 2 for v in self.biort)
        halo2 = max(v.size for v in self.qshift)
        return halo1, halo2

    def _plan(self, H: int, W: int, nlevels: int) -> Tuple[List[bool],
                                                           List[bool]]:
        halo1, halo2 = self._halos()
        rplan = _axis_plan(H, self._nrows, nlevels, halo1, halo2)
        if self._ncols > 1:
            cplan = _axis_plan(W, self._ncols, nlevels, halo1, halo2)
        else:
            cplan = [False] * nlevels
        return rplan, cplan

    def _warn_degraded(self, what: str, H: int, W: int, rplan, cplan):
        """One logged warning (per cached build) when a mesh axis the user
        asked for carries no levels at all — the transform still runs, but
        replicated along that axis (VERDICT r1 'silent loss of parallelism')."""
        if self._nrows > 1 and not rplan[0]:
            logger.warning(
                "ShardedTransform2d.%s: rows axis (%d shards) is unused for "
                "a %dx%d input — the transform runs row-replicated. Row "
                "sharding needs H divisible by %d with even local rows >= "
                "the filter halo.", what, self._nrows, H, W, self._nrows)
        if self._ncols > 1 and not cplan[0]:
            logger.warning(
                "ShardedTransform2d.%s: cols axis (%d shards) is unused for "
                "a %dx%d input — the transform runs column-replicated.",
                what, self._ncols, H, W)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3,
                layout: str = "interleaved",
                include_scale: bool = False) -> Pyramid:
        """Forward transform of a global ``[B, H, W]`` array.
        ``layout='planes'`` returns a :class:`PlanePyramid` of band-major
        re/im planes sharded like the complex subbands would be — the bf16
        storage route (bf16 input is promoted under the interleaved
        layout).  ``include_scale`` attaches the per-level lowpass images
        (sharded like their level's subbands), as for
        :meth:`Transform2d.forward`."""
        X = jnp.asarray(X)
        if X.ndim != 3:
            raise ValueError("ShardedTransform2d.forward expects [B, H, W]")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        if nlevels == 0:
            # degenerate case: no filtering — single-device semantics
            # (dtype rules + odd-size edge pad, empty highpasses)
            return self._single.forward(X, 0, include_scale=include_scale,
                                        layout=layout)
        return self._fwd_built(X.shape, X.dtype, nlevels, layout,
                               include_scale)(X)

    @functools.lru_cache(maxsize=None)
    def _fwd_built(self, shape, dtype, nlevels: int,
                   layout: str = "interleaved",
                   include_scale: bool = False):
        planes = layout == "planes"
        B, H, W = shape
        rplan, cplan = self._plan(H, W, nlevels)
        self._warn_degraded("forward", H, W, rplan, cplan)
        da, ra, ca = self.data_axis, self.rows_axis, self.cols_axis
        R, Cn = self._nrows, self._ncols
        b = self.biort
        h0o, h1o = b[0], b[2]
        h2o = b[4] if len(b) == 6 else None
        qs = self.qshift
        h0a, h0b, h1a, h1b = qs[0], qs[1], qs[4], qs[5]
        h2a, h2b = (qs[8], qs[9]) if len(qs) == 12 else (None, None)
        halo1 = max(v.size // 2 for v in (h0o, h1o)
                    + ((h2o,) if h2o is not None else ()))
        halo2 = max(v.size for v in (h0a, h1a)
                    + ((h2a,) if h2a is not None else ()))

        # Input sharding: only shard an axis the first level can use.
        in_rows = ra if rplan[0] else None
        in_cols = ca if cplan[0] else None
        in_spec = P(da, in_rows, in_cols)

        def spec(level):
            if planes:
                # [B, 6, h, w]: band axis is -3, unsharded
                return P(da, None, ra if rplan[level] else None,
                         ca if cplan[level] else None)
            return P(da, ra if rplan[level] else None,
                     ca if cplan[level] else None, None)

        def low_spec(level):
            return P(da, ra if rplan[level] else None,
                     ca if cplan[level] else None)

        out_specs = (
            low_spec(nlevels - 1),
            tuple(((spec(l), spec(l)) if planes else spec(l))
                  for l in range(nlevels)),
        )
        if include_scale:
            out_specs = out_specs + (
                tuple(low_spec(l) for l in range(nlevels)),)

        def hx(v, halo, axis):
            """Halo extension of a sharded axis."""
            name, size = (ra, R) if axis == -2 else (ca, Cn)
            return halo_exchange(v, halo, name, size, axis=axis)

        def local_fwd(x):
            # x: [B/d, H/r, W/c]
            if not jnp.issubdtype(x.dtype, jnp.inexact):
                x = x.astype(jnp.float32)
            if x.dtype == jnp.bfloat16 and not planes:
                # interleaved pyramids are complex; no bf16 complex dtype
                # exists, so promote (the single-device layout rule)
                x = x.astype(jnp.float32)
            sdt = x.dtype   # storage dtype; filter math runs at f32/f64
            Yh = []
            Yscale = []
            cur = _comp(x)
            row_sharded, col_sharded = rplan[0], cplan[0]
            for level in range(nlevels):
                if row_sharded and not rplan[level]:
                    cur = lax.all_gather(cur, ra, axis=1, tiled=True)
                    row_sharded = False
                if col_sharded and not cplan[level]:
                    cur = lax.all_gather(cur, ca, axis=2, tiled=True)
                    col_sharded = False
                if level == 0:
                    # (odd global sizes with sharding are rejected by _plan)
                    if not col_sharded and cur.shape[-1] % 2 != 0:
                        cur = jnp.concatenate([cur, cur[..., -1:]], axis=-1)
                    if not row_sharded and cur.shape[-2] % 2 != 0:
                        cur = jnp.concatenate([cur, cur[..., -1:, :]], axis=-2)
                    # Dual-stream calls: one read feeds both branch
                    # filters.  Sharded axes consume the halo exchange;
                    # unsharded axes extend locally.
                    def f2(v, axis, on):
                        if on:
                            return fb.filter2_from_wide_ext(
                                hx(v, halo1, axis), halo1, h0o, h1o,
                                axis)
                        return fb.filter2_axis(v, h0o, h1o, axis)

                    def f1(v, axis, on):
                        if on:
                            return fb.filter_from_wide_ext(
                                hx(v, halo1, axis), halo1, h2o, axis)
                        return fb.filter_axis(v, h2o, axis)

                    lo, hi = f2(cur, -2, row_sharded)
                    lolo, q23 = f2(lo, -1, col_sharded)
                    if h2o is not None:
                        ba = f1(cur, -2, row_sharded)
                        q05 = (fb.filter_from_wide_ext(
                                   hx(hi, halo1, -1), halo1, h0o, -1)
                               if col_sharded
                               else fb.filter_axis(hi, h0o, -1))
                        q14 = f1(ba, -1, col_sharded)
                    else:
                        q05, q14 = f2(hi, -1, col_sharded)
                else:
                    if not row_sharded and cur.shape[-2] % 4 != 0:
                        cur = jnp.concatenate(
                            [cur[..., :1, :], cur, cur[..., -1:, :]], axis=-2)
                    if not col_sharded and cur.shape[-1] % 4 != 0:
                        cur = jnp.concatenate(
                            [cur[..., :, :1], cur, cur[..., :, -1:]], axis=-1)
                    def d2(v, axis, on):
                        if on:
                            return fb.dfilt2_from_wide_ext(
                                hx(v, halo2, axis), halo2,
                                (h0b, h0a), (h1b, h1a), axis)
                        return fb.dfilt2_axis(v, (h0b, h0a), (h1b, h1a),
                                              axis)

                    def d1(v, axis, on, hb_, ha_):
                        if on:
                            return fb.dfilt_from_wide_ext(
                                hx(v, halo2, axis), halo2, hb_, ha_,
                                axis)
                        return fb.dfilt_axis(v, hb_, ha_, axis)

                    lo, hi = d2(cur, -2, row_sharded)
                    lolo, q23 = d2(lo, -1, col_sharded)
                    if h2b is not None:
                        ba = d1(cur, -2, row_sharded, h2b, h2a)
                        q05 = d1(hi, -1, col_sharded, h0b, h0a)
                        q14 = d1(ba, -1, col_sharded, h2b, h2a)
                    else:
                        q05, q14 = d2(hi, -1, col_sharded)
                if planes:
                    Yh.append(_pack_band_planes(q05, q23, q14, sdt))
                else:
                    Yh.append(_pack_bands(q05, q23, q14))
                # Requantize the inter-level lowpass to the storage dtype
                # exactly as the single-device path does per level
                # (transform2d.py `lolo.astype(sdt)`) — bit parity for bf16.
                lolo = lolo.astype(sdt)
                if include_scale:
                    Yscale.append(lolo)
                cur = _comp(lolo)
            if include_scale:
                return (cur.astype(sdt), tuple(Yh), tuple(Yscale))
            return (cur.astype(sdt), tuple(Yh))

        # check_vma=False: coarse levels after an all_gather are replicated
        # by construction, but the static checker cannot see through the
        # inner-jitted filter primitives to infer it.
        shmapped = jax.shard_map(
            local_fwd, mesh=self.mesh,
            in_specs=(in_spec,), out_specs=out_specs, check_vma=False)

        @jax.jit
        def run(X):
            if include_scale:
                lowpass, Yh, scales = shmapped(X)
            else:
                lowpass, Yh = shmapped(X)
                scales = None
            if planes:
                return PlanePyramid(lowpass, tuple(r for r, _ in Yh),
                                    tuple(i for _, i in Yh), scales)
            return Pyramid(lowpass, Yh, scales)

        return run

    # ------------------------------------------------------------------
    # inverse
    # ------------------------------------------------------------------
    def inverse(self, pyramid: Pyramid, gain_mask=None):
        """Inverse transform.  *gain_mask* is an optional ``(6, nlevels)``
        array of per-subband gains, as for :meth:`Transform2d.inverse`.
        Accepts a :class:`PlanePyramid` natively (no conversion pass;
        bf16 planes reconstruct back to bf16)."""
        planes = isinstance(pyramid, PlanePyramid)
        if planes:
            nlevels = pyramid.nlevels
            # shape key kept in the interleaved [..., h, w, 6] convention
            # so the synthesis shape arithmetic is layout-agnostic
            shapes = tuple(r.shape[:-3] + r.shape[-2:] + (6,)
                           for r in pyramid.highpasses_re)
        else:
            nlevels = len(pyramid.highpasses)
            shapes = tuple(tuple(h.shape) for h in pyramid.highpasses)
        if nlevels == 0:
            # degenerate case: identity (single-device semantics)
            return jnp.asarray(pyramid.lowpass)
        gm = None if gain_mask is None else jnp.asarray(gain_mask)
        return self._inv_built(
            tuple(pyramid.lowpass.shape), shapes, pyramid.lowpass.dtype,
            nlevels, "planes" if planes else "interleaved")(pyramid, gm)

    @functools.lru_cache(maxsize=None)
    def _inv_built(self, low_shape, hp_shapes, dtype, nlevels: int,
                   layout: str = "interleaved"):
        planes = layout == "planes"
        sdt = jnp.dtype(dtype)
        da, ra, ca = self.data_axis, self.rows_axis, self.cols_axis
        R, Cn = self._nrows, self._ncols
        b = self.biort
        g0o, g1o = b[1], b[3]
        g2o = b[5] if len(b) == 6 else None
        qs = self.qshift
        g0a, g0b, g1a, g1b = qs[2], qs[3], qs[6], qs[7]
        g2a, g2b = (qs[10], qs[11]) if len(qs) == 12 else (None, None)
        halo2 = max(v.size // 2 for v in (g0a, g1a)
                    + ((g2a,) if g2a is not None else ()))
        halo1 = max(v.size // 2 for v in (g0o, g1o)
                    + ((g2o,) if g2o is not None else ()))

        # Per-level, per-axis plan: synthesis at level l runs sharded on an
        # axis when every finer level (the sharded *suffix* in synthesis
        # order, i.e. levels <= l) has a shardable local extent AND the
        # suffix is crop-free along that axis (crops on a sharded axis
        # would unbalance the shards).  Coarser levels run replicated and
        # the lowpass re-shards once at the transition — the coarse levels
        # are tiny, the fine ones carry the work.  Crops along replicated
        # (or not-yet-sharded) stretches apply locally (reference crop
        # rule: ``numpy/transform2d.py:262-271``).
        def axis_plan(dim, Rax):
            plan = [False] * nlevels
            if Rax <= 1:
                return plan

            def level_ok(l):
                rows_in = (2 * hp_shapes[l][dim] if l < nlevels - 1
                           else low_shape[dim + 1])
                halo = halo2 if l > 0 else max(halo1, halo2)
                return (rows_in % Rax == 0 and (rows_in // Rax) % 2 == 0
                        and (rows_in // Rax) >= halo)

            def cropfree(l):          # no crop between level l+1 and l
                return 2 * hp_shapes[l + 1][dim] == hp_shapes[l][dim]

            for start in range(nlevels - 1, -1, -1):
                ok = all(level_ok(l) for l in range(start + 1)) and \
                    all(cropfree(l) for l in range(start))
                if ok:
                    for l in range(start + 1):
                        plan[l] = True
                    break
            return plan

        rplan = axis_plan(-3, R)
        cplan = axis_plan(-2, Cn)

        if not rplan[0] and not cplan[0]:
            # Replicated fallback: correctness first for awkward shapes.
            if R > 1 or Cn > 1:
                logger.warning(
                    "ShardedTransform2d.inverse: pyramid shapes (lowpass %s) "
                    "cannot be sharded over the %s mesh — running the inverse "
                    "replicated on every device.", low_shape,
                    dict(self.mesh.shape))
            single = self._single

            @jax.jit
            def run_repl(pyr, gain_mask):
                return single._inverse_body(pyr, gain_mask)
            return run_repl

        def spec(r_on, c_on, hp=False):
            if hp and planes:
                # (re, im) pair of [B, 6, h, w]: band axis unsharded
                s = P(da, None, ra if r_on else None, ca if c_on else None)
                return (s, s)
            base = (da, ra if r_on else None, ca if c_on else None)
            return P(*(base + ((None,) if hp else ())))

        low_spec = spec(rplan[nlevels - 1], cplan[nlevels - 1])
        hp_specs = tuple(spec(rplan[l], cplan[l], hp=True)
                         for l in range(nlevels))

        def hx(v, halo, axis):
            name, size = (ra, R) if axis == -2 else (ca, Cn)
            return halo_exchange(v, halo, name, size, axis=axis)

        def reshard(Z, axis_name, Rax, axis):
            """Replicated -> sharded transition: keep this shard's slice."""
            nloc = Z.shape[axis] // Rax
            idx = lax.axis_index(axis_name)
            return lax.dynamic_slice_in_dim(Z, idx * nloc, nloc, axis=axis)

        def quads(yh):
            """The three c2q quad images of a level — plane-direct for the
            plane layout (bf16 planes promote to the f32 compute dtype)."""
            if planes:
                re, im = yh
                bp = lambda d: (_comp(re[..., _PLANE_POS[d], :, :]),
                                _comp(im[..., _PLANE_POS[d], :, :]))
                return (c2q_planes(bp(0), bp(5)), c2q_planes(bp(2), bp(3)),
                        c2q_planes(bp(1), bp(4)))
            return (c2q(yh[..., 0], yh[..., 5]), c2q(yh[..., 2], yh[..., 3]),
                    c2q(yh[..., 1], yh[..., 4]))

        def local_inv(lowpass, *Yh):
            Z = _comp(lowpass)
            r_on = rplan[nlevels - 1]
            c_on = cplan[nlevels - 1]
            for level in range(nlevels - 1, 0, -1):
                lh, hl, hh = quads(Yh[level])

                # Fused branch-pair merges (one summed output per stage);
                # sharded axes consume the halo exchange, unsharded axes
                # extend locally.
                def i2(va, vb, pa, pb, axis, on):
                    if on:
                        return fb.ifilt2_sum_from_wide_ext(
                            hx(va, halo2, axis), hx(vb, halo2, axis),
                            halo2, pa, pb, axis)
                    return fb.ifilt2_sum_axis(va, vb, pa, pb, axis)

                def i1(v, gb_, ga_, axis, on):
                    if on:
                        return fb.ifilt_from_wide_ext(hx(v, halo2, axis),
                                                      halo2, gb_, ga_, axis)
                    return fb.ifilt_axis(v, gb_, ga_, axis)

                y1 = i2(Z, lh, (g0b, g0a), (g1b, g1a), -2, r_on)
                if g2b is not None:
                    y2 = i1(hl, g0b, g0a, -2, r_on)
                    y2bp = i1(hh, g2b, g2a, -2, r_on)
                    Z = (i2(y1, y2, (g0b, g0a), (g1b, g1a), -1, c_on)
                         + i1(y2bp, g2b, g2a, -1, c_on))
                else:
                    y2 = i2(hl, hh, (g0b, g0a), (g1b, g1a), -2, r_on)
                    Z = i2(y1, y2, (g0b, g0a), (g1b, g1a), -1, c_on)

                # crops only occur along not-(yet-)sharded axes; while an
                # axis is replicated Z carries its full global extent
                if not r_on:
                    want_h = 2 * hp_shapes[level - 1][-3]
                    if Z.shape[-2] != want_h:
                        Z = Z[..., 1:-1, :]
                    if Z.shape[-2] != want_h:
                        raise ValueError("Sizes of highpasses are not valid"
                                         " for the inverse transform")
                if not c_on:
                    want_w = 2 * hp_shapes[level - 1][-2]
                    if Z.shape[-1] != want_w:
                        Z = Z[..., :, 1:-1]
                    if Z.shape[-1] != want_w:
                        raise ValueError("Sizes of highpasses are not valid"
                                         " for the inverse transform")
                # Requantize to the storage dtype per level exactly as the
                # single-device inverse does (transform2d.py
                # `_crop_to(Z, ...).astype(sdt)`) — bit parity for bf16.
                # The elementwise cast commutes with the reshard slice.
                Z = _comp(Z.astype(sdt))
                # replicated -> sharded transitions for the finer level
                if not r_on and rplan[level - 1]:
                    Z = reshard(Z, ra, R, -2)
                    r_on = True
                if not c_on and cplan[level - 1]:
                    Z = reshard(Z, ca, Cn, -1)
                    c_on = True
            lh, hl, hh = quads(Yh[0])

            def s2(va, vb, ga, gb, axis, on):
                if on:
                    return fb.filter2_sum_from_wide_ext(
                        hx(va, halo1, axis), hx(vb, halo1, axis), halo1,
                        ga, gb, axis)
                return fb.filter2_sum_axis(va, vb, ga, gb, axis)

            def s1(v, g, axis, on):
                if on:
                    return fb.filter_from_wide_ext(hx(v, halo1, axis),
                                                   halo1, g, axis)
                return fb.filter_axis(v, g, axis)

            y1 = s2(Z, lh, g0o, g1o, -2, r_on)
            if g2o is not None:
                y2 = s1(hl, g0o, -2, r_on)
                y2bp = s1(hh, g2o, -2, r_on)
                Z = (s2(y1, y2, g0o, g1o, -1, c_on)
                     + s1(y2bp, g2o, -1, c_on))
            else:
                y2 = s2(hl, hh, g0o, g1o, -2, r_on)
                Z = s2(y1, y2, g0o, g1o, -1, c_on)
            return Z.astype(sdt)

        shmapped = jax.shard_map(
            local_inv, mesh=self.mesh,
            in_specs=(low_spec,) + hp_specs,
            out_specs=spec(rplan[0], cplan[0]), check_vma=False)

        @jax.jit
        def run(pyr, gain_mask):
            # Gains scale each complex subband elementwise before any
            # filtering (reference numpy/transform2d.py:243-245).
            if planes:
                Yh = tuple(zip(pyr.highpasses_re, pyr.highpasses_im))
                if gain_mask is not None:
                    gp = jnp.stack([gain_mask[d] for d in PLANE_BAND_ORDER])
                    Yh = tuple(((r * gp[:, i, None, None]).astype(r.dtype),
                                (m * gp[:, i, None, None]).astype(m.dtype))
                               for i, (r, m) in enumerate(Yh))
            else:
                Yh = pyr.highpasses
                if gain_mask is not None:
                    Yh = tuple(h * gain_mask[:, i] for i, h in enumerate(Yh))
            return shmapped(pyr.lowpass, *Yh)

        return run
