"""Multi-chip 1-D DTCWT: batch data-parallel + signal-axis sharding.

Long 1-D signals shard their *sample* axis across the mesh — the DTCWT
analogue of sequence/context parallelism.  Before each level's filter pass
the shards exchange only filter-support halos (<= 18 samples) via
``lax.ppermute`` between neighbouring shards; the reflect boundary rule applies
only on the physical first/last shard.  Once the decimated signal becomes
too short to shard cleanly it is ``all_gather``-ed and the coarse levels run
replicated (they are tiny).

The result is numerically identical to
:class:`dtcwt_tpu.transforms.transform1d.Transform1d`; tests assert equality
on a virtual CPU mesh.  (The reference library has no distributed execution
at all — SURVEY.md §2 parallelism table, "ring/sequence parallel" row.)
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from dtcwt_tpu.ops import fb
from dtcwt_tpu.ops.packing import (q2c1d, c2q1d, q2c1d_planes,
                                   c2q1d_planes)
from dtcwt_tpu.parallel.halo import halo_exchange
from dtcwt_tpu.transforms.pyramid import Pyramid, PlanePyramid
from dtcwt_tpu.transforms import transform1d as _t1
from dtcwt_tpu.transforms.transform2d import (
    DEFAULT_BIORT, DEFAULT_QSHIFT, normalize_biort, normalize_qshift)
from dtcwt_tpu.utils import compute_view as _comp

__all__ = ["ShardedTransform1d"]


def _hp_spec(sharded_spec, repl_spec, planes: bool, s: bool):
    """Per-level highpass PartitionSpec: a (re, im) pair for the plane
    layout, a single spec otherwise (shared by the forward out_specs and
    the inverse in_specs so they cannot desynchronize)."""
    base = sharded_spec if s else repl_spec
    return (base, base) if planes else base


def _sliced_ext(ext, halo: int, need: int, axis: int):
    if halo == need:
        return ext
    n = ext.shape[axis]
    return lax.slice_in_dim(ext, halo - need, n - (halo - need), axis=axis)


def _folded_halo(f, hw: int, C: int, axis_name: str, axis_size: int):
    """Lane-folded analogue of :func:`halo_exchange`: interior *segment*
    halos are neighbouring columns inside the shard, the shard's outermost
    segments exchange ``[..., hw, C]`` edges with neighbouring shards, and
    the physical signal ends reflect."""
    r, W = f.shape[-2], f.shape[-1]
    head = f[..., :hw, :C]
    tail = f[..., r - hw:, W - C:]
    # flip of a forward slice: safe when r == hw (negative-step stop wraps).
    reflect_top = jnp.flip(f[..., :hw, :C], axis=-2)
    reflect_bot = jnp.flip(f[..., r - hw:, W - C:], axis=-2)
    if axis_size == 1:
        top_src, bot_src = reflect_top, reflect_bot
    else:
        upper = lax.ppermute(tail, axis_name,
                             [(i, i + 1) for i in range(axis_size - 1)])
        lower = lax.ppermute(head, axis_name,
                             [(i + 1, i) for i in range(axis_size - 1)])
        idx = lax.axis_index(axis_name)
        top_src = jnp.where(idx == 0, reflect_top, upper)
        bot_src = jnp.where(idx == axis_size - 1, reflect_bot, lower)
    return _t1._lane_halo(f, hw, C, top_src, bot_src)


class ShardedTransform1d:
    """An n-level 1-D DTCWT over a device mesh.

    ``forward``/``inverse`` take and return global ``[B, N, C]`` arrays /
    Pyramids (signals along axis -2, as in :class:`Transform1d` for 3-D
    inputs); the signal axis is sharded over ``rows_axis``.
    """

    def __init__(self, mesh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 data_axis: str = "data", rows_axis: str = "rows"):
        self.mesh = mesh
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if len(self.biort) != 4 or len(self.qshift) != 8:
            raise ValueError("1-D transform does not use bandpass variants")
        self.data_axis = data_axis
        self.rows_axis = rows_axis
        self._nrows = mesh.shape[rows_axis]
        self._single = _t1.Transform1d(self.biort, self.qshift)

    def _plan(self, N: int, nlevels: int) -> List[bool]:
        """Per level: does its filter pass run signal-sharded?"""
        R = self._nrows
        halo1 = max(v.size // 2 for v in self.biort)
        halo2 = max(v.size for v in self.qshift)
        plan = []
        n = N
        sharded = True
        for level in range(nlevels):
            if level == 0:
                sharded = (sharded and n % R == 0 and (n // R) % 2 == 0
                           and (n // R) >= halo1)
            else:
                need_pad = n % 4 != 0
                sharded = (sharded and not need_pad and n % R == 0
                           and (n // R) % 4 == 0 and (n // R) >= halo2)
                if need_pad:
                    n += 2
                n >>= 1
            plan.append(sharded)
        return plan

    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3,
                layout: str = "interleaved") -> Pyramid:
        """Forward transform of a global ``[B, N, C]`` array.
        ``layout='planes'`` returns a 1-D :class:`PlanePyramid` of
        even/odd-sample re/im planes — the bf16 storage route (bf16
        input is promoted under the interleaved layout)."""
        X = jnp.asarray(X)
        if X.ndim != 3:
            raise ValueError("ShardedTransform1d.forward expects [B, N, C]")
        if X.shape[-2] % 2 != 0:
            raise ValueError("Size of input X must be a multiple of 2")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        if nlevels == 0:
            # degenerate case: no filtering — single-device semantics
            return self._single.forward(X, 0, layout=layout)
        return self._fwd_built(X.shape, X.dtype, nlevels, layout)(X)

    @functools.lru_cache(maxsize=None)
    def _fwd_built(self, shape, dtype, nlevels: int,
                   layout: str = "interleaved"):
        planes = layout == "planes"
        B, N, C = shape
        plan = self._plan(N, nlevels)
        da, ra = self.data_axis, self.rows_axis
        R = self._nrows
        h0o, _, h1o, _ = self.biort
        h0a, h0b, _, _, h1a, h1b, _, _ = self.qshift
        halo1 = max(h0o.size // 2, h1o.size // 2)
        halo2 = max(h0a.size, h1a.size)

        sharded_spec = P(da, ra, None)
        repl_spec = P(da, None, None)
        hp_spec = functools.partial(_hp_spec, sharded_spec, repl_spec,
                                    planes)
        out_specs = (sharded_spec if plan[-1] else repl_spec,
                     tuple(hp_spec(s) for s in plan))

        # Fold each shard's local signal into S*C columns as the
        # single-device transform does (transforms/transform1d.py fold;
        # here segment halos are local column shifts and only the shard-edge
        # segments ppermute, so the exchanged bytes are unchanged).
        ffold = [False] * nlevels
        S = None
        base = _t1._fold_plan(N // R, C, nlevels, halo1, halo2)
        if base is not None:
            S, Lf = base
            ffold = [lv < Lf and plan[lv] for lv in range(nlevels)]

        def local_fwd(x):
            if not jnp.issubdtype(x.dtype, jnp.inexact):
                x = x.astype(jnp.float32)
            if x.dtype == jnp.bfloat16 and not planes:
                # interleaved pyramids are complex; no bf16 complex dtype
                # exists, so promote (the single-device layout rule)
                x = x.astype(jnp.float32)
            sdt = x.dtype   # storage dtype; filter math runs at f32/f64
            Yh = []
            cur = _comp(x)
            cur_sharded = True
            folded = False
            for level in range(nlevels):
                if plan[level] != cur_sharded:
                    if folded:
                        cur = _t1._unfold(cur, S, C)
                        folded = False
                    cur = lax.all_gather(cur, ra, axis=1, tiled=True)
                    cur_sharded = False
                if ffold[level] and not folded:
                    cur = _t1._fold(cur, S)
                    folded = True
                elif folded and not ffold[level]:
                    cur = _t1._unfold(cur, S, C)
                    folded = False
                if level == 0:
                    if folded:
                        ext = _folded_halo(cur, halo1, C, ra, R)
                        hi = fb.filter_from_ext(
                            _sliced_ext(ext, halo1, h1o.size // 2, -2),
                            h1o, -2)
                        lo = fb.filter_from_ext(
                            _sliced_ext(ext, halo1, h0o.size // 2, -2),
                            h0o, -2)
                    elif cur_sharded:
                        ext = halo_exchange(cur, halo1, ra, R, axis=-2)
                        lo, hi = fb.filter2_from_wide_ext(ext, halo1, h0o,
                                                          h1o, -2)
                    else:
                        lo, hi = fb.filter2_axis(cur, h0o, h1o, -2)
                else:
                    if not cur_sharded and cur.shape[-2] % 4 != 0:
                        cur = jnp.concatenate(
                            [cur[..., :1, :], cur, cur[..., -1:, :]], axis=-2)
                    if folded:
                        ext = _folded_halo(cur, halo2, C, ra, R)
                        hi = fb.dfilt_from_ext(
                            _sliced_ext(ext, halo2, h1a.size, -2), h1b,
                            h1a, -2)
                        lo = fb.dfilt_from_ext(
                            _sliced_ext(ext, halo2, h0a.size, -2), h0b,
                            h0a, -2)
                    elif cur_sharded:
                        ext = halo_exchange(cur, halo2, ra, R, axis=-2)
                        lo, hi = fb.dfilt2_from_wide_ext(
                            ext, halo2, (h0b, h0a), (h1b, h1a), -2)
                    else:
                        lo, hi = fb.dfilt2_axis(cur, (h0b, h0a),
                                                (h1b, h1a), -2)
                if planes:
                    # even/odd deinterleave, cast to the storage dtype per
                    # level exactly as the single-device planes path does
                    # (transform1d.py `pack`)
                    re, im = q2c1d_planes(hi, -2)
                    if folded:
                        re = _t1._unfold(re, S, C)
                        im = _t1._unfold(im, S, C)
                    Yh.append((re.astype(sdt), im.astype(sdt)))
                else:
                    z = q2c1d(hi, -2)
                    Yh.append(_t1._unfold(z, S, C) if folded else z)
                cur = lo
            if folded:
                cur = _t1._unfold(cur, S, C)
            # the lowpass casts to storage dtype once at the end (matching
            # the single-device 1-D: no per-level lowpass requantization)
            return (cur.astype(sdt), tuple(Yh))

        shmapped = jax.shard_map(
            local_fwd, mesh=self.mesh,
            in_specs=(sharded_spec,), out_specs=out_specs, check_vma=False)

        @jax.jit
        def run(X):
            lowpass, Yh = shmapped(X)
            if planes:
                return PlanePyramid(lowpass, tuple(r for r, _ in Yh),
                                    tuple(i for _, i in Yh), kind="1d")
            return Pyramid(lowpass, Yh)

        return run

    # ------------------------------------------------------------------
    def inverse(self, pyramid: Pyramid, gain_mask=None):
        """Inverse transform.  *gain_mask* is an optional length-``nlevels``
        vector of per-level gains, as for :meth:`Transform1d.inverse`.
        Accepts a 1-D :class:`PlanePyramid` natively (bf16 planes
        reconstruct back to bf16)."""
        planes = isinstance(pyramid, PlanePyramid)
        if planes:
            nlevels = pyramid.nlevels
            # shape key in the interleaved [B, n, C] convention: the re
            # plane has the same shape as the complex subband
            shapes = tuple(tuple(r.shape) for r in pyramid.highpasses_re)
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
        da, ra = self.data_axis, self.rows_axis
        R = self._nrows
        N = hp_shapes[0][1] * 2
        plan = self._plan(N, nlevels)
        _, g0o, _, g1o = self.biort
        _, _, g0a, g0b, _, _, g1a, g1b = self.qshift
        halo_i = max(g0a.size // 2, g1a.size // 2)
        halo_f = max(g0o.size // 2, g1o.size // 2)

        sharded_spec = P(da, ra, None)
        repl_spec = P(da, None, None)
        hp_spec = functools.partial(_hp_spec, sharded_spec, repl_spec,
                                    planes)
        in_specs = ((sharded_spec if plan[-1] else repl_spec),) + tuple(
            hp_spec(s) for s in plan)

        # Same lane-fold plan as the forward (see _fwd_built); synthesis
        # supports are half the analysis dfilt halos, so a forward-foldable
        # level is always inverse-foldable.
        C = low_shape[2]
        ffold = [False] * nlevels
        S = None
        base = _t1._fold_plan(N // R, C, nlevels, halo_f,
                              max(g0a.size, g1a.size))
        if base is not None:
            S, Lf = base
            ffold = [lv < Lf and plan[lv] for lv in range(nlevels)]

        def hi_of(yh):
            """The level's real interleaved highpass branch input,
            plane-direct for the plane layout (bf16 planes promote to the
            f32 compute dtype)."""
            if planes:
                return c2q1d_planes(_comp(yh[0]), _comp(yh[1]), -2)
            return c2q1d(yh, -2)

        def n_of(yh):
            return (yh[0] if planes else yh).shape[-2]

        def local_inv(lowpass, *Yh):
            lo = _comp(lowpass)
            # Sharding in the forward plan is monotone (a sharded prefix of
            # fine levels, replicated coarse tail), so the inverse walks
            # replicated -> sharded with at most one re-shard transition.
            cur_sharded = plan[nlevels - 1]
            folded = False
            for level in range(nlevels - 1, 0, -1):
                hi = hi_of(Yh[level])
                if cur_sharded and ffold[level] and not folded:
                    lo = _t1._fold(lo, S)
                    folded = True
                elif folded and not ffold[level]:
                    lo = _t1._unfold(lo, S, C)
                    folded = False
                if folded:
                    ext_lo = _folded_halo(lo, halo_i, C, ra, R)
                    ext_hi = _folded_halo(_t1._fold(hi, S), halo_i, C,
                                          ra, R)
                    lo = (fb.ifilt_from_ext(
                              _sliced_ext(ext_lo, halo_i, g0a.size // 2,
                                          -2), g0b, g0a, -2)
                          + fb.ifilt_from_ext(
                              _sliced_ext(ext_hi, halo_i, g1a.size // 2,
                                          -2), g1b, g1a, -2))
                elif cur_sharded:
                    lo = fb.ifilt2_sum_from_wide_ext(
                        halo_exchange(lo, halo_i, ra, R, axis=-2),
                        halo_exchange(hi, halo_i, ra, R, axis=-2),
                        halo_i, (g0b, g0a), (g1b, g1a), -2)
                else:
                    lo = fb.ifilt2_sum_axis(lo, hi, (g0b, g0a),
                                            (g1b, g1a), -2)
                if folded:
                    # Sharded levels are crop-free by plan construction;
                    # verify against the finer level's (local) size.
                    if lo.shape[-2] * S != 2 * n_of(Yh[level - 1]):
                        raise ValueError("Yh sizes are not valid for the"
                                         " sharded inverse transform")
                elif cur_sharded:
                    # plan is a monotone sharded prefix, so the finer level
                    # is also sharded; a forward pad (=> crop here) would
                    # have forced this level replicated.
                    if lo.shape[-2] != 2 * n_of(Yh[level - 1]):
                        raise ValueError("Yh sizes are not valid for the"
                                         " sharded inverse transform")
                else:
                    want = 2 * n_of(Yh[level - 1]) * (
                        R if plan[level - 1] else 1)
                    if lo.shape[-2] != want:
                        lo = lo[..., 1:-1, :]   # undo the forward's pad
                    if lo.shape[-2] != want:
                        raise ValueError("Yh sizes are not valid for the"
                                         " inverse transform")
                    if plan[level - 1]:
                        # Re-shard: keep this shard's slice.
                        nloc = lo.shape[-2] // R
                        idx = lax.axis_index(ra)
                        lo = lax.dynamic_slice_in_dim(lo, idx * nloc, nloc,
                                                      axis=-2)
                        cur_sharded = True
            hi = hi_of(Yh[0])
            if cur_sharded and ffold[0] and not folded:
                lo = _t1._fold(lo, S)
                folded = True
            elif folded and not ffold[0]:
                lo = _t1._unfold(lo, S, C)
                folded = False
            if folded:
                ext_lo = _folded_halo(lo, halo_f, C, ra, R)
                ext_hi = _folded_halo(_t1._fold(hi, S), halo_f, C, ra, R)
                out = (fb.filter_from_ext(
                           _sliced_ext(ext_lo, halo_f, g0o.size // 2, -2),
                           g0o, -2)
                       + fb.filter_from_ext(
                           _sliced_ext(ext_hi, halo_f, g1o.size // 2, -2),
                           g1o, -2))
            elif cur_sharded:
                out = fb.filter2_sum_from_wide_ext(
                    halo_exchange(lo, halo_f, ra, R, axis=-2),
                    halo_exchange(hi, halo_f, ra, R, axis=-2),
                    halo_f, g0o, g1o, -2)
            else:
                out = fb.filter2_sum_axis(lo, hi, g0o, g1o, -2)
            out = _t1._unfold(out, S, C) if folded else out
            return out.astype(sdt)

        out_spec = sharded_spec if plan[0] else repl_spec
        shmapped = jax.shard_map(
            local_inv, mesh=self.mesh,
            in_specs=in_specs, out_specs=out_spec, check_vma=False)

        @jax.jit
        def run(pyr, gain_mask):
            # Per-level gains scale each complex subband elementwise before
            # any filtering (reference numpy/transform1d.py:138-148).
            if planes:
                Yh = tuple(zip(pyr.highpasses_re, pyr.highpasses_im))
                if gain_mask is not None:
                    Yh = tuple(((r * gain_mask[i]).astype(r.dtype),
                                (m * gain_mask[i]).astype(m.dtype))
                               for i, (r, m) in enumerate(Yh))
            else:
                Yh = pyr.highpasses
                if gain_mask is not None:
                    Yh = tuple(h * gain_mask[i] for i, h in enumerate(Yh))
            return shmapped(pyr.lowpass, *Yh)

        return run
