"""Quad <-> complex subband packing for the DTCWT.

Behavioral parity surface: upstream ``dtcwt/numpy/transform2d.py``
(q2c :301-322, c2q :324-350) and ``transform1d.py`` (interleaved packing
:88,:101, c2q1d :186-196).  Written for batched ``[..., H, W]`` arrays; the
strided quad shuffles are expressed as slice + stack/reshape so XLA folds
them into the surrounding filter fusions instead of emitting gathers.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = ["q2c", "c2q", "q2c_planes", "c2q_planes", "q2c1d", "c2q1d",
           "q2c1d_planes", "c2q1d_planes", "cube2c", "c2cube",
           "cube2c_planes", "c2cube_planes", "interleave_axis"]

_SQRT_HALF = np.sqrt(0.5)


def _complex_dtype(real_dtype):
    return jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128


def interleave_axis(parts, axis: int):
    """Interleave same-shape arrays along *axis*: out[k*i+q] = parts[q][i]."""
    axis = axis if axis >= 0 else axis + parts[0].ndim
    stacked = jnp.stack(parts, axis=axis + 1)
    shape = list(parts[0].shape)
    shape[axis] *= len(parts)
    return stacked.reshape(shape)


def q2c(y):
    """Convert a real quad-sampled highpass image into the two complex
    subbands of the dual tree.

    The four corners of each 2x2 quad (a b / c d) combine as
    ``p = (a + jb)/sqrt(2)``, ``q = (d - jc)/sqrt(2)``; the two oriented
    subbands are ``p - q`` and ``p + q`` (reference:
    ``numpy/transform2d.py:301-322``).  Accepts ``[..., H, W]``, returns a
    pair of ``[..., H/2, W/2]`` complex arrays.
    """
    # Split one axis at a time (single-axis strided slices).
    ev = y[..., 0::2, :]
    od = y[..., 1::2, :]
    a = ev[..., 0::2]
    b = ev[..., 1::2]
    c = od[..., 0::2]
    d = od[..., 1::2]
    # lax.complex keeps the real and imaginary pipelines independent for
    # XLA to fuse.
    sc = jnp.asarray(_SQRT_HALF, y.dtype)
    return (lax.complex((a - d) * sc, (b + c) * sc),
            lax.complex((a + d) * sc, (b - c) * sc))


def q2c_planes(y):
    """:func:`q2c` without the complex dtype: returns the two subbands as
    ``((re0, im0), (re1, im1))`` real pairs.  Works for any real dtype —
    including bfloat16, which ``lax.complex`` cannot represent — and lets
    XLA keep the re/im pipelines as independent fusions."""
    ev = y[..., 0::2, :]
    od = y[..., 1::2, :]
    a = ev[..., 0::2]
    b = ev[..., 1::2]
    c = od[..., 0::2]
    d = od[..., 1::2]
    sc = jnp.asarray(_SQRT_HALF, y.dtype)
    return (((a - d) * sc, (b + c) * sc), ((a + d) * sc, (b - c) * sc))


def c2q_planes(w0, w1, g0=1.0, g1=1.0):
    """:func:`c2q` on ``(re, im)`` pairs instead of complex subbands (the
    plane-layout / bfloat16 route; same quad math as the reference
    ``numpy/transform2d.py:324-350``)."""
    r0, i0 = w0
    r1, i1 = w1
    rdt = r0.dtype
    s0 = jnp.asarray(g0, rdt) * jnp.asarray(_SQRT_HALF, rdt)
    s1 = jnp.asarray(g1, rdt) * jnp.asarray(_SQRT_HALF, rdt)
    pr, pi = r0 * s0 + r1 * s1, i0 * s0 + i1 * s1
    qr, qi = r0 * s0 - r1 * s1, i0 * s0 - i1 * s1
    top = interleave_axis((pr, pi), axis=-1)
    bot = interleave_axis((qi, -qr), axis=-1)
    return interleave_axis((top, bot), axis=-2)


def c2q(w0, w1, g0=1.0, g1=1.0):
    """Inverse of :func:`q2c`: scale the two complex subbands by (g0, g1)
    and reassemble the real quad image of twice the height and width
    (reference: ``numpy/transform2d.py:324-350``)."""
    rdt = jnp.real(w0).dtype
    s0 = jnp.asarray(g0, rdt) * jnp.asarray(_SQRT_HALF, rdt)
    s1 = jnp.asarray(g1, rdt) * jnp.asarray(_SQRT_HALF, rdt)
    p = w0 * s0 + w1 * s1
    q = w0 * s0 - w1 * s1
    # quads: rows (a b) from p, rows (c d) from q.imag/-q.real
    top = interleave_axis((jnp.real(p), jnp.imag(p)), axis=-1)
    bot = interleave_axis((jnp.imag(q), -jnp.real(q)), axis=-1)
    return interleave_axis((top, bot), axis=-2)


def _split2(y, axis: int):
    """Even/odd split along one axis (single-axis strided slices only)."""
    idx_e = [slice(None)] * y.ndim
    idx_o = [slice(None)] * y.ndim
    idx_e[axis] = slice(0, None, 2)
    idx_o[axis] = slice(1, None, 2)
    return y[tuple(idx_e)], y[tuple(idx_o)]


def _cube_corner_combos(y):
    """The eight 3-D octet corners and their p/q/r/s re/im combinations
    (eqs. (6)-(9) of Chen & Kingsbury, "Efficient Registration of Nonrigid
    3-D Bodies", IEEE TIP 21(1), 2012; reference
    ``numpy/transform3d.py:532-579``).  Corner extraction is done one axis
    at a time.  Returns ``(re4, im4)`` lists in p, q, r, s order."""
    e0, o0 = _split2(y, y.ndim - 3)
    e0e1, e0o1 = _split2(e0, y.ndim - 2)
    o0e1, o0o1 = _split2(o0, y.ndim - 2)
    A, E = _split2(e0e1, y.ndim - 1)
    B, F = _split2(e0o1, y.ndim - 1)
    C, G = _split2(o0e1, y.ndim - 1)
    D, H = _split2(o0o1, y.ndim - 1)

    half = jnp.asarray(0.5, y.dtype)
    re4 = [(A - G - D - F) * half, (A - G + D + F) * half,
           (A + G + D - F) * half, (A + G - D + F) * half]
    im4 = [(B - H + C + E) * half, (-B + H + C + E) * half,
           (B + H - C + E) * half, (-B - H - C + E) * half]
    return re4, im4


def cube2c(y):
    """Convert a real octet-sampled 3-D highpass volume ``[..., 2P, 2Q, 2R]``
    into its four complex directional subbands, each ``[..., P, Q, R]``,
    stacked on a new trailing axis (see :func:`_cube_corner_combos`)."""
    re4, im4 = _cube_corner_combos(y)
    return jnp.stack([lax.complex(r, i) for r, i in zip(re4, im4)], axis=-1)


def cube2c_planes(y):
    """:func:`cube2c` in the plane layout: returns ``(re, im)`` real arrays
    with the four directional subbands stacked on a new *band-major* axis
    (``[..., 4, P, Q, R]``) — no complex ops, so backends that emulate
    complex arithmetic (X64Combine custom calls) pay nothing."""
    re4, im4 = _cube_corner_combos(y)
    return jnp.stack(re4, axis=-4), jnp.stack(im4, axis=-4)


def c2cube(z):
    """Inverse of :func:`cube2c`: four complex subbands ``[..., P, Q, R, 4]``
    back to the real octet volume ``[..., 2P, 2Q, 2R]`` (reference:
    ``numpy/transform3d.py:581-619``)."""
    p, q, r, s = (z[..., i] for i in range(4))
    return _c2cube_parts(jnp.real(p), jnp.imag(p), jnp.real(q), jnp.imag(q),
                         jnp.real(r), jnp.imag(r), jnp.real(s), jnp.imag(s))


def c2cube_planes(re, im):
    """Inverse of :func:`cube2c_planes`: band-major ``[..., 4, P, Q, R]``
    re/im planes back to the real octet volume — no complex ops."""
    pr, qr, rr, sr = (re[..., i, :, :, :] for i in range(4))
    pi, qi, ri, si = (im[..., i, :, :, :] for i in range(4))
    return _c2cube_parts(pr, pi, qr, qi, rr, ri, sr, si)


def _c2cube_parts(pr, pi, qr, qi, rr, ri, sr, si):
    half = jnp.asarray(0.5, pr.dtype)
    # corners indexed (i, j, k) = (dim-3, dim-2, dim-1) parity
    c000 = (pr + qr + rr + sr) * half
    c101 = (-pr - qr + rr + sr) * half
    c110 = (-pr + qr + rr - sr) * half
    c011 = (-pr + qr - rr + sr) * half
    c010 = (pi - qi + ri - si) * half
    c111 = (-pi + qi + ri - si) * half
    c100 = (pi + qi - ri - si) * half
    c001 = (pi + qi + ri + si) * half

    # interleave k, then j, then i (single-axis interleaves)
    c00 = interleave_axis((c000, c001), axis=-1)
    c01 = interleave_axis((c010, c011), axis=-1)
    c10 = interleave_axis((c100, c101), axis=-1)
    c11 = interleave_axis((c110, c111), axis=-1)
    c0 = interleave_axis((c00, c01), axis=-2)
    c1 = interleave_axis((c10, c11), axis=-2)
    return interleave_axis((c0, c1), axis=-3)


def q2c1d(y, axis: int = 0):
    """Pack alternating samples along *axis* into complex values:
    ``z[i] = y[2i] + j*y[2i+1]`` (reference: ``transform1d.py:88``)."""
    axis = axis if axis >= 0 else axis + y.ndim
    idx_even = [slice(None)] * y.ndim
    idx_odd = [slice(None)] * y.ndim
    idx_even[axis] = slice(0, None, 2)
    idx_odd[axis] = slice(1, None, 2)
    return lax.complex(y[tuple(idx_even)], y[tuple(idx_odd)])


def c2q1d(z, axis: int = 0):
    """Inverse of :func:`q2c1d`: interleave real and imaginary parts along
    *axis* (reference: ``transform1d.py:186-196``)."""
    return interleave_axis((jnp.real(z), jnp.imag(z)), axis=axis)


def q2c1d_planes(y, axis: int = 0):
    """:func:`q2c1d` without the complex dtype: the (re, im) plane pair is
    simply the even/odd deinterleave of *y* (any real dtype, incl. bf16)."""
    return _split2(y, axis % y.ndim)


def c2q1d_planes(re, im, axis: int = 0):
    """Inverse of :func:`q2c1d_planes`: interleave the plane pair."""
    return interleave_axis((re, im), axis=axis)
