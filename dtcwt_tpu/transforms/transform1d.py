"""1-D dual-tree complex wavelet transform (forward + inverse).

Behavioral parity surface: upstream ``dtcwt/numpy/transform1d.py``
(forward :26-110, inverse :112-180, c2q1d :186-196).  Follows the reference
layout convention: a 1-D vector, or a 2-D array whose *columns* are
independent signals.  Higher-rank inputs are treated as ``[..., N, C]``
batches over the leading axes.  Signal length must be even; levels >= 2 pad
to a multiple of 4 by repeating edge samples, and the inverse crops
correspondingly (:95-96, :164-166).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from dtcwt_tpu.ops import fb
from dtcwt_tpu.ops.packing import (q2c1d, c2q1d, q2c1d_planes, c2q1d_planes)
from dtcwt_tpu.transforms.pyramid import (Pyramid, PlanePyramid,
                                          pyramid_to_device)
from dtcwt_tpu.utils import compute_view as _comp
from dtcwt_tpu.transforms.transform2d import (
    DEFAULT_BIORT, DEFAULT_QSHIFT, normalize_biort, normalize_qshift,
    _pad_multiple4)

__all__ = ["Transform1d"]


# ---------------------------------------------------------------------------
# Lane folding: a single long signal is one column of an [N, C] array with
# C = 1.  Fold it into S contiguous segments laid out side by side as
# columns and run each level's filter with *neighbour-segment halos* instead
# of per-segment symmetric extension — numerically identical to the flat
# transform (the same trick, across devices instead of columns, as
# parallel/transform1d_dist.py).  Reference has no analogue; its 1-D path is
# `dtcwt/numpy/transform1d.py:26-110` columns.
# ---------------------------------------------------------------------------

_FOLD_MIN_N = 4096      # don't bother folding short signals
_FOLD_MAX_C = 16        # folding targets signals with few columns
_FOLD_LANES = 512       # target folded lane count (S * C)


def _fold(x, S: int):
    """``[..., N, C] -> [..., N/S, S*C]``: segment j of each signal becomes
    lanes ``[j*C, (j+1)*C)`` (segment-major lane order)."""
    lead, (N, C) = x.shape[:-2], x.shape[-2:]
    xs = jnp.moveaxis(x.reshape(lead + (S, N // S, C)), -3, -2)
    return xs.reshape(lead + (N // S, S * C))


def _unfold(y, S: int, C: int):
    """Inverse of :func:`_fold` for a (decimated) folded array."""
    lead, r = y.shape[:-2], y.shape[-2]
    ys = jnp.moveaxis(y.reshape(lead + (r, S, C)), -2, -3)
    return ys.reshape(lead + (r * S, C))


def _lane_halo(f, hw: int, C: int, top_src=None, bot_src=None):
    """Extend folded ``[..., r, S*C]`` by *hw* rows each side: interior halos
    come from the neighbouring segment's lanes; the first/last segment
    reflect the true signal ends (same convention as
    :func:`fb.symmetric_extend`) unless *top_src*/*bot_src* supply them
    (the sharded path passes the neighbouring shard's edge here)."""
    r = f.shape[-2]
    # jnp.flip of a forward slice, not a negative-step slice: the latter's
    # stop index (r - hw - 1) wraps to -1 and yields an empty array when
    # r == hw (reachable, e.g. 16-tap qshift_c halos dividing the segment).
    if top_src is None:
        top_src = jnp.flip(f[..., :hw, :C], axis=-2)
    if bot_src is None:
        bot_src = jnp.flip(f[..., r - hw:, f.shape[-1] - C:], axis=-2)
    top = jnp.concatenate([top_src, f[..., r - hw:, :-C]], axis=-1)
    bot = jnp.concatenate([f[..., :hw, C:], bot_src], axis=-1)
    return jnp.concatenate([top, f, bot], axis=-2)


def _sliced(ext, halo: int, need: int):
    if halo == need:
        return ext
    n = ext.shape[-2]
    return jax.lax.slice_in_dim(ext, halo - need, n - (halo - need),
                                axis=-2)


def _fold_plan(N: int, C: int, nlevels: int, halo1: int, halo2: int):
    """Pick a segment count S and the folded level-prefix length Lf, or
    return ``None`` when folding doesn't apply."""
    if C > _FOLD_MAX_C or N < _FOLD_MIN_N or nlevels == 0:
        return None
    S = 1
    while (S * 2 * C <= _FOLD_LANES and N % (S * 2) == 0
           and N // (S * 2) >= max(halo1, 2 * halo2)):
        S *= 2
    if S == 1:
        return None
    R = N // S
    if R % 2 or R < halo1:
        return None
    Lf, r = 1, R          # level-1 lowpass is undecimated: level 1 input = R
    for _ in range(1, nlevels):
        if r % 4 or r < halo2:
            break
        Lf += 1
        r //= 2
    return S, Lf


class Transform1d:
    """An n-level 1-D DTCWT parameterised by *biort* / *qshift* wavelets."""

    def __init__(self, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT):
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if len(self.biort) != 4 or len(self.qshift) != 8:
            raise ValueError("1-D transform does not use bandpass variants")
        self._fwd = jax.jit(self._forward_body,
                            static_argnames=("nlevels", "include_scale",
                                             "layout"))
        self._inv = jax.jit(self._inverse_body, static_argnames=("ret_flat",))

    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3, include_scale: bool = False,
                layout: str = "interleaved") -> Pyramid:
        """Forward transform of a vector / columns-of-signals array.  The
        signal axis (axis 0 for <=2-D input, axis -2 otherwise) must have
        even length.  ``layout='planes'`` returns a :class:`PlanePyramid`
        (``kind='1d'``) whose re/im pair per level is the even/odd
        deinterleave of the level-1/tree output — no complex arrays, the
        bf16 storage route."""
        X = jnp.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        axis = 0 if X.ndim <= 2 else -2
        if X.shape[axis] % 2 != 0:
            raise ValueError("Size of input X must be a multiple of 2")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        return self._fwd(X, nlevels=nlevels, include_scale=include_scale,
                         layout=layout)

    def _forward_body(self, X, *, nlevels: int, include_scale: bool,
                      layout: str = "interleaved") -> Pyramid:
        planes = layout == "planes"
        h0o, _, h1o, _ = self.biort
        h0a, h0b, _, _, h1a, h1b, _, _ = self.qshift
        axis = 0 if X.ndim <= 2 else -2

        if not jnp.issubdtype(X.dtype, jnp.inexact):
            X = X.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        if X.dtype == jnp.bfloat16 and not planes:
            # The interleaved pyramid packs complex subbands and there is
            # no bfloat16 complex dtype; only ``layout='planes'`` stores
            # bf16.
            X = X.astype(jnp.float32)
        sdt = X.dtype  # storage dtype; filter math runs at compute dtype

        if nlevels == 0:
            if planes:
                return PlanePyramid(X, (), (), () if include_scale else None,
                                    kind="1d")
            return Pyramid(X, (), () if include_scale else None)

        Yh, Yscale = [], []

        def pack(hi, ax):
            if not planes:
                return q2c1d(hi, ax)
            re, im = q2c1d_planes(hi, ax)
            return re.astype(sdt), im.astype(sdt)

        Xc = _comp(X)
        halo1 = max(h0o.size // 2, h1o.size // 2)
        halo2 = max(h0a.size, h1a.size)
        plan = (_fold_plan(X.shape[0], X.shape[1], nlevels, halo1, halo2)
                if X.ndim == 2 else None)
        if plan is not None:
            S, Lf = plan
            C = X.shape[1]
            cur = _fold(Xc, S)
            for level in range(Lf):
                if level == 0:
                    ext = _lane_halo(cur, halo1, C)
                    hi = fb.filter_from_ext(
                        _sliced(ext, halo1, h1o.size // 2), h1o, 0)
                    cur = fb.filter_from_ext(
                        _sliced(ext, halo1, h0o.size // 2), h0o, 0)
                else:
                    ext = _lane_halo(cur, halo2, C)
                    hi = fb.dfilt_from_ext(
                        _sliced(ext, halo2, h1a.size), h1b, h1a, 0)
                    cur = fb.dfilt_from_ext(
                        _sliced(ext, halo2, h0a.size), h0b, h0a, 0)
                if planes:
                    re, im = q2c1d_planes(hi, 0)
                    Yh.append((_unfold(re, S, C).astype(sdt),
                               _unfold(im, S, C).astype(sdt)))
                else:
                    Yh.append(_unfold(q2c1d(hi, 0), S, C))
                if include_scale:
                    Yscale.append(_unfold(cur, S, C).astype(sdt))
            lo = _unfold(cur, S, C)
            start = Lf
        else:
            lo, hi = fb.filter2_axis(Xc, h0o, h1o, axis)
            Yh.append(pack(hi, axis))
            if include_scale:
                Yscale.append(lo.astype(sdt))
            start = 1

        for _level in range(start, nlevels):
            if lo.shape[axis] % 4 != 0:
                lo = _pad_multiple4(lo, axis)
            lo, hi = fb.dfilt2_axis(lo, (h0b, h0a), (h1b, h1a), axis)
            Yh.append(pack(hi, axis))
            if include_scale:
                Yscale.append(lo.astype(sdt))

        lo = lo.astype(sdt)
        scales = tuple(Yscale) if include_scale else None
        if planes:
            return PlanePyramid(lo, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales, kind="1d")
        return Pyramid(lo, tuple(Yh), scales)

    # ------------------------------------------------------------------
    def forward_channels(self, X, nlevels: int = 3,
                         include_scale: bool = False) -> Pyramid:
        """Forward transform of a 3-D batch of matrices whose *columns* (the
        second dimension) are the signals (reference surface:
        ``tf/transform1d.py:150-215``).  Inputs of 1 or 2 dimensions should
        use :meth:`forward`."""
        X = jnp.asarray(X)
        if X.ndim != 3:
            raise ValueError(
                "Incorrect input shape for the forward_channels method %s. "
                "For inputs of 1 or 2 dimensions, use the forward method."
                % (X.shape,))
        return self.forward(X, nlevels, include_scale)

    def inverse_channels(self, pyramid: Pyramid, gain_mask=None):
        """Inverse of :meth:`forward_channels` on a 3-D pyramid (reference
        surface: ``tf/transform1d.py:293-371``)."""
        low = jnp.asarray(pyramid.lowpass)
        if low.ndim != 3:
            raise ValueError(
                "Incorrect input shape for the inverse_channels method %s. "
                "For inputs of 1 or 2 dimensions, use the inverse method."
                % (low.shape,))
        return self.inverse(pyramid, gain_mask)

    # ------------------------------------------------------------------
    def inverse(self, pyramid: Pyramid, gain_mask=None):
        """Inverse transform of a :class:`Pyramid` or 1-D
        :class:`PlanePyramid`.  *gain_mask* is an optional
        length-``nlevels`` vector of per-level gains."""
        pyramid = pyramid_to_device(pyramid)
        lowpass = jnp.asarray(pyramid.lowpass)
        ret_flat = lowpass.ndim == 2 and lowpass.shape[-1] == 1
        gm = None if gain_mask is None else jnp.asarray(gain_mask)
        return self._inv(pyramid, gm, ret_flat=ret_flat)

    def _inverse_body(self, pyramid: Pyramid, gain_mask, *, ret_flat: bool):
        _, g0o, _, g1o = self.biort
        _, _, g0a, g0b, _, _, g1a, g1b = self.qshift

        plane_pyr = isinstance(pyramid, PlanePyramid)
        if plane_pyr:
            # the re planes stand in for the complex subbands in all shape
            # arithmetic (same shapes); data access goes through hi_at
            Yh = pyramid.highpasses_re
        else:
            Yh = pyramid.highpasses
        lo = jnp.asarray(pyramid.lowpass)
        sdt = lo.dtype
        lo = _comp(lo)
        nlevels = len(Yh)
        axis = 0 if lo.ndim <= 2 else -2
        if nlevels == 0:
            return lo.astype(sdt)

        def gained(level):
            z = Yh[level]
            if gain_mask is None:
                return z
            return z * gain_mask[level]

        def hi_at(level):
            """The level's real interleaved highpass branch input (c2q1d of
            the subbands), plane-direct for a PlanePyramid."""
            if plane_pyr:
                re = _comp(pyramid.highpasses_re[level])
                im = _comp(pyramid.highpasses_im[level])
                if gain_mask is not None:
                    re, im = re * gain_mask[level], im * gain_mask[level]
                return c2q1d_planes(re, im, axis)
            return c2q1d(gained(level), axis)

        halo_i = max(g0a.size // 2, g1a.size // 2)
        halo_f = max(g0o.size // 2, g1o.size // 2)

        # Lane-folding prepass (mirrors the forward's _fold_plan; all shapes
        # are static).  fold_E = finest-entry iteration level such that every
        # iteration from there down is fold-valid and crop-free.
        S = C = fold_E = None
        fold_final = False
        if lo.ndim == 2:
            C = lo.shape[1]
            N = 2 * Yh[0].shape[axis]
            base = _fold_plan(N, C, nlevels, halo_f,
                              max(g0a.size, g1a.size))
            if base is not None:
                S = base[0]
                ok = {}
                cur_len = lo.shape[axis]
                for level in range(nlevels - 1, 0, -1):
                    r, rem = divmod(cur_len, S)
                    want = 2 * Yh[level - 1].shape[axis]
                    ok[level] = (rem == 0 and r % 2 == 0 and r >= halo_i
                                 and cur_len == 2 * Yh[level].shape[axis]
                                 and 2 * cur_len == want)
                    cur_len = want
                e = 0
                while e + 1 <= nlevels - 1 and ok[e + 1]:
                    e += 1
                fold_E = e if e >= 1 else None
                fold_final = (cur_len % S == 0
                              and cur_len // S >= halo_f
                              and cur_len == 2 * Yh[0].shape[axis])

        folded = False
        for level in range(nlevels - 1, 0, -1):
            hi = hi_at(level)
            if not folded and fold_E is not None and level <= fold_E:
                lo = _fold(lo, S)
                folded = True
            if folded:
                ext_lo = _lane_halo(lo, halo_i, C)
                ext_hi = _lane_halo(_fold(hi, S), halo_i, C)
                lo = (fb.ifilt_from_ext(
                          _sliced(ext_lo, halo_i, g0a.size // 2),
                          g0b, g0a, 0)
                      + fb.ifilt_from_ext(
                          _sliced(ext_hi, halo_i, g1a.size // 2),
                          g1b, g1a, 0))
            else:
                lo = fb.ifilt2_sum_axis(lo, hi, (g0b, g0a), (g1b, g1a),
                                        axis)
                if lo.shape[axis] != 2 * Yh[level - 1].shape[axis]:
                    lo = jax.lax.slice_in_dim(lo, 1, lo.shape[axis] - 1,
                                              axis=axis)
                if lo.shape[axis] != 2 * Yh[level - 1].shape[axis]:
                    raise ValueError("Yh sizes are not valid for the inverse"
                                     " transform")

        hi = hi_at(0)
        if not folded and fold_final:
            lo = _fold(lo, S)
            folded = True
        if folded:
            ext_lo = _lane_halo(lo, halo_f, C)
            ext_hi = _lane_halo(_fold(hi, S), halo_f, C)
            Z = _unfold(fb.filter_from_ext(
                            _sliced(ext_lo, halo_f, g0o.size // 2), g0o, 0)
                        + fb.filter_from_ext(
                            _sliced(ext_hi, halo_f, g1o.size // 2), g1o, 0),
                        S, C)
        else:
            Z = fb.filter2_sum_axis(lo, hi, g0o, g1o, axis)
        if ret_flat:
            return Z[:, 0].astype(sdt)
        return Z.astype(sdt)
