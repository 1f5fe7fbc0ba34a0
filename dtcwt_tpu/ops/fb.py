"""Filter-bank primitives: non-decimating, decimate-by-2 and interpolate-by-2
column/row filtering with symmetric-reflect ("repeat end samples") boundary
handling.

Behavioral parity surface: upstream ``dtcwt/numpy/lowlevel.py``
(colfilter :47-80, coldfilt :82-154, colifilt :156-260).  The implementation
is a fresh polyphase derivation designed for XLA:

* Shapes and filters are static at trace time, so the reference's
  data-dependent branches (``sum(ha*hb) > 0`` output-parity tests at
  lowlevel.py:143-148 and :212-217, and the ``m/2`` parity split at :205) all
  resolve to Python-level constants here and emit straight-line code.
* The dual-filter ops are expressed as even/odd *phase splits* of the
  symmetrically extended signal followed by small stride-1/2 valid
  correlations — no strided scatter: every op works along an arbitrary axis
  of an arbitrarily batched array, so 2-D/3-D transforms and ``vmap``
  batches share one code path.  Minor-axis dual-filter work runs through a
  transpose pair (see ``_dfilt_impl``).

Closed forms (derived from the reference index algebra, verified bit-exactly
against it in ``tests/test_fb_vs_reference.py``):

Let ``ext`` be the input extended by ``n`` samples each side with repeated
end samples, ``r`` the input length, ``m = len(ha)`` (even), ``m2 = m//2``.

``colfilter`` (ext width ``m//2``)::

    Y[i] = sum_k rev(h)[k] * ext[i + k]            # len r (odd m) / r+1 (even)

``coldfilt`` (ext width ``m``; E/O = even/odd phase of ext)::

    Ya[i] = sum_k rev(ha)[k] * E[2i + 1 + k]       # i in [0, r//4)
    Yb[i] = sum_k rev(hb)[k] * O[2i + 1 + k]
    Y     = interleave2(Ya, Yb)  (order given by sign of sum(ha*hb))

``colifilt`` (ext width ``m2``; EV/OD = phases of ext holding even/odd
*extended* indices, i.e. ``ext[m2%2::2]`` / ``ext[(m2+1)%2::2]``)::

    m2 even, sum(ha*hb)>0:
        Y[4i+0] = corr(EV, rev(ha[1::2]))[i]
        Y[4i+1] = corr(OD, rev(hb[1::2]))[i]
        Y[4i+2] = corr(EV, rev(ha[0::2]))[i+1]
        Y[4i+3] = corr(OD, rev(hb[0::2]))[i+1]
    m2 odd,  sum(ha*hb)>0:
        Y[4i+0] = corr(EV, rev(ha[0::2]))[i]
        Y[4i+1] = corr(OD, rev(hb[0::2]))[i+1]
        Y[4i+2] = corr(EV, rev(ha[1::2]))[i]
        Y[4i+3] = corr(OD, rev(hb[1::2]))[i+1]
    sum(ha*hb)<0: swap the EV/OD roles between the a- and b-tree rows.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from dtcwt_tpu.utils import reflect

__all__ = [
    "colfilter", "rowfilter", "coldfilt", "rowdfilt", "colifilt", "rowifilt",
    "filter_axis", "dfilt_axis", "ifilt_axis", "symmetric_extend",
    "filter_from_ext", "dfilt_from_ext", "ifilt_from_ext",
    "filter2_axis", "dfilt2_axis", "filter2_sum_axis", "ifilt2_sum_axis",
]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _as_taps(h) -> np.ndarray:
    """Normalize a filter to a flat float64 numpy vector (static)."""
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    if h.size == 0:
        raise ValueError("Empty filter")
    return h


def _norm_axis(axis: int, ndim: int) -> int:
    axis = axis if axis >= 0 else axis + ndim
    if not 0 <= axis < ndim:
        raise ValueError("axis out of range")
    return axis


def _asfloat(x):
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    return x


def symmetric_extend(x, n: int, axis: int):
    """Extend *x* by *n* samples each side of *axis* using symmetric
    reflection with repeated end samples ([c b a | a b c ... x y z | z y x])."""
    axis = _norm_axis(axis, x.ndim)
    if n == 0:
        return x
    r = x.shape[axis]
    if n <= r:
        front = lax.rev(lax.slice_in_dim(x, 0, n, axis=axis), (axis,))
        back = lax.rev(lax.slice_in_dim(x, r - n, r, axis=axis), (axis,))
        return jnp.concatenate([front, x, back], axis=axis)
    # Rare case (filter support longer than the signal): full reflect gather.
    xe = reflect(np.arange(-n, r + n, dtype=np.float64), -0.5, r - 0.5)
    return jnp.take(x, xe.astype(np.int64), axis=axis)


def _corr(buf, taps: Sequence[float], n_out: int, axis: int,
          offset: int = 0, stride: int = 1):
    """Valid correlation: ``Y[i] = sum_k taps[k] * buf[stride*i + offset + k]``
    along *axis*, unrolled over the (static, small) tap count so XLA fuses it
    into a single vectorized pass."""
    rdt = jnp.real(buf).dtype if jnp.issubdtype(buf.dtype, jnp.complexfloating) else buf.dtype
    acc = None
    for k, t in enumerate(taps):
        lo = offset + k
        hi = lo + stride * (n_out - 1) + 1
        sl = lax.slice_in_dim(buf, lo, hi, stride=stride, axis=axis)
        term = sl * jnp.asarray(t, dtype=rdt)
        acc = term if acc is None else acc + term
    return acc


def _interleave(parts, axis: int):
    """Interleave k same-shape arrays along *axis*: out[k*i + q] = parts[q][i]."""
    axis = _norm_axis(axis, parts[0].ndim)
    stacked = jnp.stack(parts, axis=axis + 1)
    shape = list(parts[0].shape)
    shape[axis] = shape[axis] * len(parts)
    return stacked.reshape(shape)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def filter_from_ext(ext, h, axis: int):
    """:func:`filter_axis` on an already-extended buffer (extension width
    ``len(h)//2`` each side of *axis*) — the building block shared by the
    single-device path and the halo-exchanged sharded path."""
    h = _as_taps(h)
    axis = _norm_axis(axis, jnp.ndim(ext))
    m = h.size
    n_out = ext.shape[axis] - m + 1
    return _corr(ext, h[::-1], n_out, axis)


def _filter_impl(x, h: np.ndarray, axis: int):
    x = _asfloat(x)
    axis = _norm_axis(axis, x.ndim)
    ext = symmetric_extend(x, h.size // 2, axis)
    return filter_from_ext(ext, h, axis)


@functools.lru_cache(maxsize=None)
def _filter_jit(hbytes: bytes, axis: int):
    h = np.frombuffer(hbytes, dtype=np.float64)
    return jax.jit(functools.partial(_filter_impl, h=h, axis=axis))


def filter_axis(x, h, axis: int):
    """Non-decimating filter along *axis* with symmetric edge extension.

    Output length equals the input length for odd-length *h* and input
    length + 1 for even-length *h* (reference: ``numpy/lowlevel.py:47-80``).
    """
    h = _as_taps(h)
    return _filter_jit(h.tobytes(), axis)(x)


def _minor(x, axis: int) -> bool:
    """True when *axis* is the minor (contiguous) axis of a >= 2-D array."""
    return x.ndim >= 2 and axis == x.ndim - 1


def _dfilt_impl(x, ha: np.ndarray, hb: np.ndarray, axis: int):
    x = _asfloat(x)
    axis = _norm_axis(axis, x.ndim)
    # Along the minor axis the stride-4/stride-2 phase extractions below
    # read memory with a stride and run at ~230-450 GB/s on an H100; the
    # same extraction along a major axis reads whole contiguous rows.  So
    # minor-axis work goes through a transpose pair instead, kept out of the
    # filter fusions by optimization_barrier (XLA would otherwise fuse the
    # transpose back into the strided slices).  Measured on an H100 80GB
    # HBM3 at a 400 W limit: 4096^2 3-level round trip 2.79 ms with the
    # transposes against 3.59 ms without; 256^3 3-D round trip 5.57 against
    # 6.14 ms.
    if _minor(x, axis):
        xt = lax.optimization_barrier(jnp.swapaxes(x, -1, -2))
        y = lax.optimization_barrier(_dfilt_impl(xt, ha, hb, x.ndim - 2))
        return jnp.swapaxes(y, -1, -2)
    ext = symmetric_extend(x, ha.size, axis)    # width m each side
    return dfilt_from_ext(ext, ha, hb, axis)


def dfilt_from_ext(ext, ha, hb, axis: int):
    """:func:`dfilt_axis` on an already-extended buffer (extension width
    ``len(ha)`` each side; extended length must be a multiple of 4)."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    axis = _norm_axis(axis, jnp.ndim(ext))
    m = ha.size
    r = ext.shape[axis] - 2 * m
    # Quarter-phase decomposition: with E[n]=ext[2n], O[n]=ext[2n+1],
    #   Ya[i] = sum_k rev(ha)[k] E[2i+1+k],  Yb[i] = sum_k rev(hb)[k] O[2i+1+k]
    # splitting the tap index k by parity turns every per-tap slice into a
    # CONTIGUOUS slice of a quarter-phase stream Q_p[n] = ext[4n+p]:
    #   Ya[i] = sum_u rev(ha)[2u] Q2[i+u] + sum_u rev(ha)[2u+1] Q0[i+u+1]
    #   Yb[i] = sum_u rev(hb)[2u] Q3[i+u] + sum_u rev(hb)[2u+1] Q1[i+u+1]
    # (the four stride-4 phase extractions happen once; every tap then reads
    # a contiguous window).
    quarters = [lax.slice_in_dim(ext, p, None, stride=4, axis=axis)
                for p in range(4)]
    n4 = r // 4
    har, hbr = ha[::-1], hb[::-1]
    ya = (_corr(quarters[2], har[0::2], n4, axis, offset=0)
          + _corr(quarters[0], har[1::2], n4, axis, offset=1))
    yb = (_corr(quarters[3], hbr[0::2], n4, axis, offset=0)
          + _corr(quarters[1], hbr[1::2], n4, axis, offset=1))
    if float(np.sum(ha * hb)) > 0:
        return _interleave((ya, yb), axis)
    return _interleave((yb, ya), axis)


@functools.lru_cache(maxsize=None)
def _dfilt_jit(habytes: bytes, hbbytes: bytes, axis: int):
    ha = np.frombuffer(habytes, dtype=np.float64)
    hb = np.frombuffer(hbbytes, dtype=np.float64)
    return jax.jit(functools.partial(_dfilt_impl, ha=ha, hb=hb, axis=axis))


def dfilt_axis(x, ha, hb, axis: int):
    """Dual-tree decimate-by-2 filter along *axis*.

    *ha* operates on one polyphase branch and *hb* on the other; outputs are
    interleaved with parity chosen by the (static) sign of ``sum(ha*hb)``.
    Requires the axis length to be a multiple of 4 and even-length filters
    (reference: ``numpy/lowlevel.py:82-154``).
    """
    ha, hb = _as_taps(ha), _as_taps(hb)
    r = jnp.shape(x)[axis]
    if r % 4 != 0:
        raise ValueError("Length of axis %d must be a multiple of 4" % axis)
    if ha.shape != hb.shape:
        raise ValueError("Shapes of ha and hb must be the same")
    if ha.size % 2 != 0:
        raise ValueError("Lengths of ha and hb must be even")
    return _dfilt_jit(ha.tobytes(), hb.tobytes(), axis)(x)


def _ifilt_impl(x, ha: np.ndarray, hb: np.ndarray, axis: int):
    x = _asfloat(x)
    axis = _norm_axis(axis, x.ndim)
    if _minor(x, axis):     # transpose pair: see _dfilt_impl
        xt = lax.optimization_barrier(jnp.swapaxes(x, -1, -2))
        y = lax.optimization_barrier(_ifilt_impl(xt, ha, hb, x.ndim - 2))
        return jnp.swapaxes(y, -1, -2)
    ext = symmetric_extend(x, ha.size // 2, axis)
    return ifilt_from_ext(ext, ha, hb, axis)


def ifilt_from_ext(ext, ha, hb, axis: int):
    """:func:`ifilt_axis` on an already-extended buffer (extension width
    ``len(ha)//2`` each side of *axis*)."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    axis = _norm_axis(axis, jnp.ndim(ext))
    m = ha.size
    m2 = m // 2
    r = ext.shape[axis] - 2 * m2
    # Phases holding even / odd *extended* indices e = p - m2:
    ev = lax.slice_in_dim(ext, m2 % 2, None, stride=2, axis=axis)
    od = lax.slice_in_dim(ext, (m2 + 1) % 2, None, stride=2, axis=axis)

    ha_e, ha_o = ha[0::2][::-1], ha[1::2][::-1]   # reversed even/odd-index taps
    hb_e, hb_o = hb[0::2][::-1], hb[1::2][::-1]
    n2 = r // 2
    pos = float(np.sum(ha * hb)) > 0

    if m2 % 2 == 0:
        if pos:
            rows = (_corr(ev, ha_o, n2, axis, 0), _corr(od, hb_o, n2, axis, 0),
                    _corr(ev, ha_e, n2, axis, 1), _corr(od, hb_e, n2, axis, 1))
        else:
            rows = (_corr(od, ha_o, n2, axis, 0), _corr(ev, hb_o, n2, axis, 0),
                    _corr(od, ha_e, n2, axis, 1), _corr(ev, hb_e, n2, axis, 1))
    else:
        if pos:
            rows = (_corr(ev, ha_e, n2, axis, 0), _corr(od, hb_e, n2, axis, 1),
                    _corr(ev, ha_o, n2, axis, 0), _corr(od, hb_o, n2, axis, 1))
        else:
            rows = (_corr(od, ha_e, n2, axis, 1), _corr(ev, hb_e, n2, axis, 0),
                    _corr(od, ha_o, n2, axis, 1), _corr(ev, hb_o, n2, axis, 0))
    return _interleave(rows, axis)


@functools.lru_cache(maxsize=None)
def _ifilt_jit(habytes: bytes, hbbytes: bytes, axis: int):
    ha = np.frombuffer(habytes, dtype=np.float64)
    hb = np.frombuffer(hbbytes, dtype=np.float64)
    return jax.jit(functools.partial(_ifilt_impl, ha=ha, hb=hb, axis=axis))


def ifilt_axis(x, ha, hb, axis: int):
    """Dual-tree interpolate-by-2 filter along *axis* (output is twice the
    input length).  Requires even axis length and even-length filters
    (reference: ``numpy/lowlevel.py:156-260``)."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    r = jnp.shape(x)[axis]
    if r % 2 != 0:
        raise ValueError("Length of axis %d must be a multiple of 2" % axis)
    if ha.shape != hb.shape:
        raise ValueError("Shapes of ha and hb must be the same")
    if ha.size % 2 != 0:
        raise ValueError("Lengths of ha and hb must be even")
    return _ifilt_jit(ha.tobytes(), hb.tobytes(), axis)(x)


# ---------------------------------------------------------------------------
# dual-stream primitives: the separable-tree memory savers
#
# Every stage of a 2^k separable filter tree (the 3-D transform's hot path,
# reference ``numpy/transform3d.py:208-289``) applies BOTH branch filters to
# the same intermediate, and every synthesis stage SUMS two branch inverses.
# Expressed as independent primitive calls each intermediate is read from HBM
# twice on analysis and the branch sum costs an extra elementwise pass on
# synthesis; the dual-stream forms read each input once and keep the sum in
# registers.  Semantics are exactly
#
#   filter2_axis(x, h0, h1)        == (filter_axis(x, h0), filter_axis(x, h1))
#   dfilt2_axis(x, p0, p1)         == (dfilt_axis(x, *p0), dfilt_axis(x, *p1))
#   filter2_sum_axis(a, b, g0, g1) == filter_axis(a, g0) + filter_axis(b, g1)
#   ifilt2_sum_axis(a, b, p0, p1)  == ifilt_axis(a, *p0) + ifilt_axis(b, *p1)
# ---------------------------------------------------------------------------

def _filter2_impl(x, h0: np.ndarray, h1: np.ndarray, axis: int):
    x = _asfloat(x)
    axis = _norm_axis(axis, x.ndim)
    p0, p1 = h0.size // 2, h1.size // 2
    p = max(p0, p1)
    ext = symmetric_extend(x, p, axis)
    r = x.shape[axis]
    y0 = _corr(ext, h0[::-1], r + 2 * p0 - h0.size + 1, axis, offset=p - p0)
    y1 = _corr(ext, h1[::-1], r + 2 * p1 - h1.size + 1, axis, offset=p - p1)
    return y0, y1


@functools.lru_cache(maxsize=None)
def _filter2_jit(h0bytes: bytes, h1bytes: bytes, axis: int):
    h0 = np.frombuffer(h0bytes, dtype=np.float64)
    h1 = np.frombuffer(h1bytes, dtype=np.float64)
    return jax.jit(functools.partial(_filter2_impl, h0=h0, h1=h1, axis=axis))


def filter2_axis(x, h0, h1, axis: int):
    """Both non-decimating branch filters of one tree stage in a single pass:
    ``(filter_axis(x, h0), filter_axis(x, h1))`` with the input read once."""
    h0, h1 = _as_taps(h0), _as_taps(h1)
    return _filter2_jit(h0.tobytes(), h1.tobytes(), axis)(x)


def _dfilt2_impl(x, ha0, hb0, ha1, hb1, axis: int):
    x = _asfloat(x)
    axis = _norm_axis(axis, x.ndim)
    if _minor(x, axis):     # transpose pair: see _dfilt_impl
        xt = lax.optimization_barrier(jnp.swapaxes(x, -1, -2))
        y0, y1 = _dfilt2_impl(xt, ha0, hb0, ha1, hb1, x.ndim - 2)
        y0, y1 = lax.optimization_barrier((y0, y1))
        return jnp.swapaxes(y0, -1, -2), jnp.swapaxes(y1, -1, -2)
    ext = symmetric_extend(x, ha0.size, axis)    # all four lengths equal
    return (dfilt_from_ext(ext, ha0, hb0, axis),
            dfilt_from_ext(ext, ha1, hb1, axis))


@functools.lru_cache(maxsize=None)
def _dfilt2_jit(b0: bytes, b1: bytes, b2: bytes, b3: bytes, axis: int):
    taps = [np.frombuffer(b, dtype=np.float64) for b in (b0, b1, b2, b3)]
    return jax.jit(functools.partial(
        _dfilt2_impl, ha0=taps[0], hb0=taps[1], ha1=taps[2], hb1=taps[3],
        axis=axis))


def dfilt2_axis(x, pair0, pair1, axis: int):
    """Both decimate-by-2 branch filters of one tree stage in a single pass:
    ``(dfilt_axis(x, *pair0), dfilt_axis(x, *pair1))`` with the input read
    once.  All four filters must share one (even) length."""
    ha0, hb0 = (_as_taps(h) for h in pair0)
    ha1, hb1 = (_as_taps(h) for h in pair1)
    if not (ha0.size == hb0.size == ha1.size == hb1.size):
        # Mixed-length stages can't share one extension; fall back to the
        # independent single-stream ops (still correct, one extra read).
        return dfilt_axis(x, ha0, hb0, axis), dfilt_axis(x, ha1, hb1, axis)
    if jnp.shape(x)[axis] % 4 != 0:
        raise ValueError("Length of axis %d must be a multiple of 4" % axis)
    if ha0.size % 2 != 0:
        raise ValueError("Filter lengths must be even")
    return _dfilt2_jit(ha0.tobytes(), hb0.tobytes(), ha1.tobytes(),
                       hb1.tobytes(), axis)(x)


def _filter2_sum_impl(a, b, h0: np.ndarray, h1: np.ndarray, axis: int):
    a, b = _asfloat(a), _asfloat(b)
    axis = _norm_axis(axis, a.ndim)
    ya = filter_from_ext(symmetric_extend(a, h0.size // 2, axis), h0, axis)
    yb = filter_from_ext(symmetric_extend(b, h1.size // 2, axis), h1, axis)
    return ya + yb


@functools.lru_cache(maxsize=None)
def _filter2_sum_jit(h0bytes: bytes, h1bytes: bytes, axis: int):
    h0 = np.frombuffer(h0bytes, dtype=np.float64)
    h1 = np.frombuffer(h1bytes, dtype=np.float64)
    return jax.jit(functools.partial(_filter2_sum_impl, h0=h0, h1=h1,
                                     axis=axis))


def filter2_sum_axis(a, b, h0, h1, axis: int):
    """One synthesis-stage branch merge in a single pass:
    ``filter_axis(a, h0) + filter_axis(b, h1)`` with the sum kept on-chip.
    Requires both filters odd-length or both even (equal output lengths)."""
    h0, h1 = _as_taps(h0), _as_taps(h1)
    if h0.size % 2 != h1.size % 2:
        # Odd filters emit r samples, even ones r+1 — the sum is undefined.
        raise ValueError("Filter length parities must match")
    return _filter2_sum_jit(h0.tobytes(), h1.tobytes(), axis)(a, b)


def _ifilt2_sum_impl(a, b, ha0, hb0, ha1, hb1, axis: int):
    a, b = _asfloat(a), _asfloat(b)
    axis = _norm_axis(axis, a.ndim)
    if _minor(a, axis):     # transpose pair: see _dfilt_impl
        at, bt = lax.optimization_barrier((jnp.swapaxes(a, -1, -2),
                                           jnp.swapaxes(b, -1, -2)))
        y = lax.optimization_barrier(
            _ifilt2_sum_impl(at, bt, ha0, hb0, ha1, hb1, a.ndim - 2))
        return jnp.swapaxes(y, -1, -2)
    m2 = ha0.size // 2
    ya = ifilt_from_ext(symmetric_extend(a, m2, axis), ha0, hb0, axis)
    yb = ifilt_from_ext(symmetric_extend(b, m2, axis), ha1, hb1, axis)
    return ya + yb


@functools.lru_cache(maxsize=None)
def _ifilt2_sum_jit(b0: bytes, b1: bytes, b2: bytes, b3: bytes, axis: int):
    taps = [np.frombuffer(b, dtype=np.float64) for b in (b0, b1, b2, b3)]
    return jax.jit(functools.partial(
        _ifilt2_sum_impl, ha0=taps[0], hb0=taps[1], ha1=taps[2],
        hb1=taps[3], axis=axis))


def ifilt2_sum_axis(a, b, pair0, pair1, axis: int):
    """One synthesis-stage branch merge in a single pass:
    ``ifilt_axis(a, *pair0) + ifilt_axis(b, *pair1)`` with the sum kept
    on-chip.  All four filters must share one (even) length."""
    ha0, hb0 = (_as_taps(h) for h in pair0)
    ha1, hb1 = (_as_taps(h) for h in pair1)
    if not (ha0.size == hb0.size == ha1.size == hb1.size):
        return ifilt_axis(a, ha0, hb0, axis) + ifilt_axis(b, ha1, hb1, axis)
    if jnp.shape(a)[axis] % 2 != 0:
        raise ValueError("Length of axis %d must be a multiple of 2" % axis)
    if jnp.shape(a) != jnp.shape(b):
        raise ValueError("Branch inputs must have the same shape")
    if ha0.size % 2 != 0:
        raise ValueError("Filter lengths must be even")
    return _ifilt2_sum_jit(ha0.tobytes(), hb0.tobytes(), ha1.tobytes(),
                           hb1.tobytes(), axis)(a, b)


# ---------------------------------------------------------------------------
# wide-extension forms: the sharded transforms' entry points
#
# The spatially-sharded transforms (parallel/transform{1,2,3}d_dist) halo-
# exchange one extension per level and axis, as wide as the longest filter
# of the level needs, then run every branch filter of the level on it.
# Each filter sees the exact-width slice its closed form expects, so the
# sharded results are bit-identical to the single-device ones.
# ---------------------------------------------------------------------------

def trim_ext(ext, side: int, need: int, axis: int):
    """Trim a wide extension (width *side* per side) to width *need*."""
    if side == need:
        return ext
    axis = _norm_axis(axis, jnp.ndim(ext))
    n = ext.shape[axis]
    return lax.slice_in_dim(ext, side - need, n - (side - need), axis=axis)


def filter_from_wide_ext(ext, side: int, h, axis: int):
    """:func:`filter_from_ext` on an extension of width *side* >=
    ``len(h)//2`` per side."""
    h = _as_taps(h)
    return filter_from_ext(trim_ext(ext, side, h.size // 2, axis), h, axis)


def dfilt_from_wide_ext(ext, side: int, ha, hb, axis: int):
    """:func:`dfilt_from_ext` on an extension of width *side* >= ``len(ha)``
    per side."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    return dfilt_from_ext(trim_ext(ext, side, ha.size, axis), ha, hb, axis)


def ifilt_from_wide_ext(ext, side: int, ha, hb, axis: int):
    """:func:`ifilt_from_ext` on an extension of width *side* >=
    ``len(ha)//2`` per side."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    return ifilt_from_ext(trim_ext(ext, side, ha.size // 2, axis), ha, hb,
                          axis)


def filter2_from_wide_ext(ext, side: int, h0, h1, axis: int):
    """Both branch filters on one wide extension:
    ``(filter(ext|h0), filter(ext|h1))``."""
    h0, h1 = _as_taps(h0), _as_taps(h1)
    return (filter_from_ext(trim_ext(ext, side, h0.size // 2, axis), h0,
                            axis),
            filter_from_ext(trim_ext(ext, side, h1.size // 2, axis), h1,
                            axis))


def dfilt2_from_wide_ext(ext, side: int, pair0, pair1, axis: int):
    """Both decimating branch pairs on one wide extension."""
    ha0, hb0 = (_as_taps(h) for h in pair0)
    ha1, hb1 = (_as_taps(h) for h in pair1)
    return (dfilt_from_ext(trim_ext(ext, side, ha0.size, axis), ha0, hb0,
                           axis),
            dfilt_from_ext(trim_ext(ext, side, ha1.size, axis), ha1, hb1,
                           axis))


def filter2_sum_from_wide_ext(a, b, side: int, h0, h1, axis: int):
    """``filter(a|h0) + filter(b|h1)`` on two wide extensions (*side* must
    cover the longer filter)."""
    h0, h1 = _as_taps(h0), _as_taps(h1)
    return (filter_from_ext(trim_ext(a, side, h0.size // 2, axis), h0, axis)
            + filter_from_ext(trim_ext(b, side, h1.size // 2, axis), h1,
                              axis))


def ifilt2_sum_from_wide_ext(a, b, side: int, pair0, pair1, axis: int):
    """``ifilt(a|pair0) + ifilt(b|pair1)`` on two wide extensions."""
    ha0, hb0 = (_as_taps(h) for h in pair0)
    ha1, hb1 = (_as_taps(h) for h in pair1)
    return (ifilt_from_ext(trim_ext(a, side, ha0.size // 2, axis), ha0,
                           hb0, axis)
            + ifilt_from_ext(trim_ext(b, side, ha1.size // 2, axis), ha1,
                             hb1, axis))


# ---------------------------------------------------------------------------
# column/row aliases (column = second-to-last axis, row = last axis)
# ---------------------------------------------------------------------------

def _col_axis(x):
    """Reference layout: 1-D signals are columns, so for 1-D/2-D inputs the
    filter axis is 0; batched [..., H, W] inputs filter axis -2."""
    return 0 if jnp.ndim(x) <= 2 else -2


def colfilter(X, h):
    """Filter image columns with *h*, no decimation."""
    return filter_axis(X, h, _col_axis(X))


def rowfilter(X, h):
    """Filter image rows with *h*, no decimation."""
    return filter_axis(X, h, -1)


def coldfilt(X, ha, hb):
    """Decimate-by-2 dual filter on image columns."""
    return dfilt_axis(X, ha, hb, _col_axis(X))


def rowdfilt(X, ha, hb):
    """Decimate-by-2 dual filter on image rows."""
    return dfilt_axis(X, ha, hb, -1)


def colifilt(X, ha, hb):
    """Interpolate-by-2 dual filter on image columns."""
    return ifilt_axis(X, ha, hb, _col_axis(X))


def rowifilt(X, ha, hb):
    """Interpolate-by-2 dual filter on image rows."""
    return ifilt_axis(X, ha, hb, -1)
