"""Rescaling / re-sampling of low- and highpass subbands, including the
phase-unwrap variants for complex highpass coefficients.

Behavioral parity surface: upstream ``dtcwt/sampling.py`` (sample
:105-129, rescale :131-165, phase tables :27-34, _phase_image :167-190,
sample_highpass :192-222, rescale_highpass :224-278, upsample :280-391).

Conventions (as in the reference): integer coordinate (x, y) is the *centre*
of pixel ``im[y, x]``; out-of-range samples reflect symmetrically with
repeated end samples.  All samplers are pure jnp (gather-based) and work on
real or complex images with arbitrary trailing channel axes; they are
differentiable and can be jitted/vmapped inside larger pipelines (the
registration module runs them inside one compiled program).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from dtcwt_tpu.utils import asdevice, reflect

__all__ = (
    "sample", "sample_highpass",
    "rescale", "rescale_highpass",
    "upsample", "upsample_highpass",
    "DTHETA_DX_2D", "DTHETA_DY_2D",
)

_W0 = -3 * np.pi / 2.15
_W1 = -np.pi / 2.15

#: Expected per-pixel phase advance of each 2-D subband in x
DTHETA_DX_2D = np.array((_W1, _W0, _W0, _W0, _W0, _W1))
#: Expected per-pixel phase advance of each 2-D subband in y
DTHETA_DY_2D = np.array((_W0, _W0, _W1, -_W1, -_W0, -_W0))


def _sample_clipped(im, xs, ys):
    """Gather ``im[y, x, ...]`` with symmetric-reflect index folding."""
    h, w = im.shape[0], im.shape[1]
    sym_xs = reflect(xs, -0.5, w - 0.5).astype(jnp.int32)
    sym_ys = reflect(ys, -0.5, h - 0.5).astype(jnp.int32)
    return im[sym_ys, sym_xs]


def _bcast_weight(weight, im_ndim):
    """Append channel axes so an (H, W) weight scales (H, W, C...) samples."""
    extra = im_ndim - 2
    return weight.reshape(weight.shape + (1,) * extra) if extra else weight


def _lanczos(x, a=3.0):
    return jnp.sinc(x) * jnp.sinc(x / a)


def _hat(x):
    return jnp.maximum(0.0, 1.0 - jnp.abs(x))


#: method -> (1-D tap offsets relative to floor(coord), tap weight function
#: of the signed distance).  Every interpolator is the same separable
#: gather-accumulate loop over this stencil.
_STENCILS = {
    "bilinear": (range(0, 2), _hat),
    "lanczos": (range(-2, 4), _lanczos),
}


def sample(im, xs, ys, method=None):
    """Sample *im* at fractional centre-of-pixel coordinates (xs, ys) using
    ``'lanczos'`` (default), ``'bilinear'`` or ``'nearest'`` interpolation.
    Out-of-range coordinates reflect symmetrically (repeated end samples)."""
    im = jnp.atleast_2d(asdevice(im))
    xs, ys = jnp.asarray(xs), jnp.asarray(ys)
    if xs.shape != ys.shape:
        raise ValueError("Shape of xs and ys must match")
    method = method or "lanczos"
    if method == "nearest":
        return _sample_clipped(im, jnp.round(xs), jnp.round(ys))
    if method not in _STENCILS:
        raise NotImplementedError(
            'Sampling method "{0}" is not implemented.'.format(method))
    offsets, weight = _STENCILS[method]
    fx, fy = jnp.floor(xs), jnp.floor(ys)
    acc = None
    for dx in offsets:
        wx = weight((xs - fx) - dx)
        for dy in offsets:
            w = _bcast_weight(wx * weight((ys - fy) - dy), im.ndim)
            term = w * _sample_clipped(im, fx + dx, fy + dy)
            acc = term if acc is None else acc + term
    return acc.astype(im.dtype) if method == "bilinear" else acc


def _rescale_grid(src_shape, dst_shape):
    sh, sw = src_shape[:2]
    dh, dw = dst_shape[:2]
    dxs, dys = np.meshgrid(np.arange(dw), np.arange(dh))
    sxs = (float(sw) / float(dw)) * (dxs + 0.5) - 0.5
    sys = (float(sh) / float(dh)) * (dys + 0.5) - 0.5
    return sxs, sys


def _interp_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """(dst, src) separable interpolation operator for the regular rescale
    grid, with the samplers' symmetric-reflect index folding baked in.
    Identical weights/taps to the gather samplers — but a rescale is a
    *separable regular-grid* resampling, so it runs as two matrix products
    instead of per-tap 2-D gathers."""
    cs = (float(src) / float(dst)) * (np.arange(dst) + 0.5) - 0.5
    A = np.zeros((dst, src))
    rows = np.arange(dst)

    def fold(idx):
        return reflect(idx, -0.5, src - 0.5).astype(np.int64)

    if method == "nearest":
        A[rows, fold(np.round(cs))] = 1.0
    elif method == "bilinear":
        fl = np.floor(cs)
        fr = cs - fl
        np.add.at(A, (rows, fold(fl)), 1.0 - fr)
        np.add.at(A, (rows, fold(fl + 1)), fr)
    else:  # lanczos
        a = 3
        fl = np.floor(cs)
        fr = cs - fl
        for dx in range(-a + 1, a + 1):
            w = np.sinc(fr - dx) * np.sinc((fr - dx) / a)
            np.add.at(A, (rows, fold(fl + dx)), w)
    return A


def _rescale_arr(im, shape, method):
    method = method or "lanczos"
    if method not in ("nearest", "bilinear", "lanczos"):
        raise NotImplementedError(
            'Sampling method "{0}" is not implemented.'.format(method))
    ay = jnp.asarray(_interp_matrix(im.shape[0], shape[0], method),
                     jnp.real(im).dtype)
    ax = jnp.asarray(_interp_matrix(im.shape[1], shape[1], method),
                     jnp.real(im).dtype)
    if jnp.iscomplexobj(im):
        re = _rescale_real(jnp.real(im), ay, ax)
        imag = _rescale_real(jnp.imag(im), ay, ax)
        return jax.lax.complex(re, imag)
    return _rescale_real(im, ay, ax).astype(im.dtype)


def _rescale_real(im, ay, ax):
    # Full f32 precision: a default-precision f32 dot may run in TF32 on
    # the GPU, which keeps ~3 decimal digits of the interpolation weights.
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.tensordot(ay, im, axes=(1, 0), precision=hi)   # [dh, sw, C...]
    out = jnp.tensordot(ax, tmp, axes=(1, 1), precision=hi)  # [dw, dh, C...]
    return jnp.swapaxes(out, 0, 1)


def rescale(im, shape, method=None):
    """Resample *im* so that its (half-pixel-inclusive) extent maps onto an
    array of size *shape*."""
    im = jnp.atleast_2d(asdevice(im))
    return _rescale_arr(im, shape, method)


def _phase_image(xs, ys, unwrap=True, sbs=None):
    """exp(-+j(w_x x + w_y y)) phase ramps for the selected subbands,
    stacked on a trailing axis (reference: sampling.py:167-190)."""
    sbs = np.arange(6) if sbs is None else np.asarray(sbs)
    xs = jnp.asarray(xs)
    ys = jnp.asarray(ys)
    sign = -1.0 if unwrap else 1.0
    slices = []
    for sb in sbs:
        ph = DTHETA_DX_2D[sb] * xs + DTHETA_DY_2D[sb] * ys
        slices.append(jax.lax.complex(jnp.cos(ph), sign * jnp.sin(ph)))
    return jnp.stack(slices, axis=-1)


def sample_highpass(im, xs, ys, method=None, sbs=None):
    """As :func:`sample` for complex highpass subband stacks ``[H, W, 6]``:
    unwrap each subband's expected phase ramp to ~DC, sample, re-wrap.
    *sbs* selects/reorders subbands."""
    im = asdevice(im)
    sbs = np.arange(6) if sbs is None else np.asarray(sbs)
    X, Y = np.meshgrid(np.arange(im.shape[1]), np.arange(im.shape[0]))
    im_unwrap = im[:, :, sbs] * _phase_image(X, Y, True, sbs)
    im_sampled = sample(im_unwrap, xs, ys, method)
    return _phase_image(xs, ys, False, sbs) * im_sampled


def rescale_highpass(im, shape, method=None, sbs=None):
    """As :func:`rescale` with the highpass phase unwrap/re-wrap."""
    im = asdevice(im)
    sbs = np.arange(6) if sbs is None else np.asarray(sbs)
    sxs, sys = _rescale_grid(im.shape, shape)
    X, Y = np.meshgrid(np.arange(im.shape[1]), np.arange(im.shape[0]))
    im_unwrap = im[:, :, sbs] * _phase_image(X, Y, True, sbs)
    im_sampled = _rescale_arr(im_unwrap, shape, method)
    return im_sampled * _phase_image(sxs, sys, False, sbs)


def _upsample_columns(X, method=None):
    """Double the column count by interleaving two shifted interpolation
    convolutions (A at x-0.25, B at x+0.25; reference: sampling.py:280-336)."""
    method = method or "lanczos"
    X = jnp.atleast_2d(jnp.asarray(X))
    M = X.shape[1]

    if method == "lanczos":
        a = 3.0
        sample_offsets = np.arange(-a, a + 1)
        l_as = np.sinc(-0.25 - sample_offsets) * np.sinc((-0.25 - sample_offsets) / a)
        l_bs = np.sinc(0.25 - sample_offsets) * np.sinc((0.25 - sample_offsets) / a)
    elif method == "nearest":
        sample_offsets, l_as, l_bs = [0], [1.0], [1.0]
    elif method == "bilinear":
        sample_offsets = [-1, 0, 1]
        l_as = [0.25, 0.75, 0.0]
        l_bs = [0.0, 0.75, 0.25]
    else:
        raise ValueError("Unknown interpolation mode: {0}".format(method))

    int_columns = np.arange(M, dtype=np.float64)
    A = None
    B = None
    for di, l_a, l_b in zip(sample_offsets, l_as, l_bs):
        cols = reflect(int_columns + di, -0.5, M - 0.5).astype(np.int64)
        gathered = jnp.take(X, cols, axis=1)
        ta = gathered * jnp.asarray(l_a, jnp.real(X).dtype)
        tb = gathered * jnp.asarray(l_b, jnp.real(X).dtype)
        A = ta if A is None else A + ta
        B = tb if B is None else B + tb
    stacked = jnp.stack([A, B], axis=2)
    return stacked.reshape(X.shape[:1] + (2 * M,) + X.shape[2:])


def upsample(image, method=None):
    """Upsample rows and columns by a factor of two (trailing axes kept)."""
    image = jnp.atleast_2d(jnp.asarray(image))

    def _t(X):
        axes = list(range(X.ndim))
        axes[0], axes[1] = 1, 0
        return jnp.transpose(X, axes)

    return _upsample_columns(_t(_upsample_columns(_t(image), method)), method)


def upsample_highpass(im, method=None):
    """As :func:`upsample` for complex subband stacks, with the phase
    unwrap/re-wrap around the interpolation."""
    im = jnp.atleast_2d(asdevice(im))
    dxs, dys = np.meshgrid(np.arange(im.shape[1] * 2), np.arange(im.shape[0] * 2))
    sxs = 0.5 * (dxs + 0.5) - 0.5
    sys = 0.5 * (dys + 0.5) - 0.5
    X, Y = np.meshgrid(np.arange(im.shape[1]), np.arange(im.shape[0]))
    im_unwrap = im * _phase_image(X, Y, True)
    im_sampled = upsample(im_unwrap, method)
    return im_sampled * _phase_image(sxs, sys, False)
