"""Shared helpers: boundary index maps, dtype rules, test-image generators.

Behavioral parity surface: upstream ``dtcwt/utils.py`` (reflect
:136-153, dtype rules :98-124, drawedge/drawcirc :45-96, unpack :9-42,
stacked einsum helpers :167-210).  Implementations here are written fresh for
a functional JAX code path: ``reflect`` works on both numpy arrays (used at
trace time to build static index maps) and jnp arrays.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "reflect", "asfarray", "appropriate_complex_type_for", "as_column_vector",
    "asnumpy", "asdevice", "compute_view", "use_compile_cache", "drawedge",
    "drawcirc", "unpack",
    "stacked_2d_matrix_vector_prod", "stacked_2d_vector_matrix_prod",
    "stacked_2d_matrix_matrix_prod",
]


def compute_view(x):
    """Compute-dtype view of a possibly-bfloat16 array: bfloat16 is a
    *storage* dtype (pyramid planes — half the memory traffic of f32); the
    filter arithmetic runs in float32.  Identity for every other dtype
    (incl. the f64 verification path)."""
    return x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x


def asnumpy(x):
    """Device array -> numpy array (``np.asarray``; complex included)."""
    return np.asarray(x)


def asdevice(x):
    """Host array -> device array (``jnp.asarray``; complex included).
    Device arrays pass through unchanged."""
    return jnp.asarray(x)


def use_compile_cache(default_dir=None):
    """Turn on JAX's persistent compilation cache for a script.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache goes to
    *default_dir*, by default ``.jax_cache`` beside the package (the
    checkout root).  Importing the library sets no cache: scripts opt in by
    calling this.  Returns the directory used."""
    import os
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir
    if not path:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def reflect(x, minx, maxx):
    """Reflect values of *x* into the interval ``[minx, maxx]`` by repeated
    folding at the two endpoints (triangle-wave index map).

    With integer *x* and half-integer bounds this produces symmetric
    extension *with repeated end samples*, the boundary rule used by every
    filter in the transform (reference semantics:
    upstream ``dtcwt/utils.py:136-153``).
    """
    xp = np if isinstance(x, (np.ndarray, int, float, list, tuple)) else jnp
    x = xp.asarray(x)
    rng = maxx - minx
    rng2 = 2.0 * rng
    mod = xp.fmod(x - minx, rng2)
    mod = xp.where(mod < 0, mod + rng2, mod)
    out = xp.where(mod >= rng, rng2 - mod, mod) + minx
    return out.astype(x.dtype)


def asfarray(X):
    """Convert *X* to a floating (or complex) array, preserving an existing
    inexact dtype and converting integers/bools to float64."""
    X = np.asanyarray(X)
    if np.issubdtype(X.dtype, np.inexact):
        return X
    return X.astype(np.float64)


def appropriate_complex_type_for(X):
    """Complex dtype matching the precision of *X* (f32->c64, f64->c128)."""
    dt = np.asanyarray(X).dtype
    if np.issubdtype(dt, np.complexfloating):
        return dt
    if dt == np.float32 or dt == np.float16:
        return np.complex64
    return np.complex128


def as_column_vector(v):
    """Return *v* reshaped to an (N, 1) column vector."""
    v = np.atleast_2d(np.asanyarray(v))
    return v.T if v.shape[0] == 1 else v


def drawedge(theta, r, w, N):
    """Synthetic N-by-N test image of a soft step edge at *theta* degrees
    passing through image-coordinate *r*, with a raised-cosine profile of
    width *w* pixels.  (Test-image generator; reference surface
    ``utils.py:45-74``.)"""
    thetar = float(theta) * np.pi / 180.0
    centre = (np.array([N, N], dtype=np.float64) - 1.0) / 2.0 + 1.0
    rr = -np.array([np.cos(thetar), np.sin(thetar)]) * (np.asarray(r, np.float64) - centre)
    w = max(1.0, float(w))
    ramp = np.arange(N, dtype=np.float64) - (N + 1) / 2.0
    # plane[i, j] = -sin(theta)*ramp[j] - r0  +  -cos(theta)*ramp[i] - r1
    plane = (-np.sin(thetar) * ramp[None, :] - rr[0]) \
        + (-np.cos(thetar) * ramp[:, None] - rr[1])
    return 0.5 + 0.5 * np.sin(np.clip(plane * (np.pi / w), -np.pi / 2, np.pi / 2))


def drawcirc(r, w, du, dv, N):
    """Synthetic N-by-N test image of a soft-edged circle of radius *r*
    offset (du, dv) from centre, cosine edge of width *w*.  (Reference
    surface ``utils.py:76-96``.)"""
    w = max(float(w), 1.0)
    r = float(r)
    x = np.ones((N, 1)) * ((np.arange(N, dtype=np.float64) - (N + 1) / 2.0 - dv) / r)
    y = (((np.arange(N, dtype=np.float64) - (N + 1) / 2.0 - du) / r)[None, :] * np.ones((1, N))).T
    arg = (np.exp(-0.5 * (x ** 2 + y ** 2)).T - np.exp(-0.5)) * (r * 3.0 / w)
    return 0.5 + 0.5 * np.sin(np.clip(arg, -np.pi / 2, np.pi / 2))


def unpack(pyramid, backend="numpy"):
    """Unpack a Pyramid into its ``(lowpass, highpasses[, scales])`` parts.

    The *backend* argument is accepted for API compatibility with the
    reference (``utils.py:9-42``); there is only one array type here.
    Plane-layout pyramids unpack through their interleaved view.
    """
    if hasattr(pyramid, "highpasses_re"):     # PlanePyramid
        pyramid = pyramid.interleaved()
    yield pyramid.lowpass
    yield pyramid.highpasses
    if pyramid.scales is not None:
        yield pyramid.scales


def _einsum(spec, a, b):
    # f32 dots on the GPU may run in TF32 (~3 decimal digits) unless asked
    # for full precision; these helpers back the registration solver.
    if isinstance(a, np.ndarray):
        return np.einsum(spec, a, b)
    return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST)


def stacked_2d_matrix_vector_prod(mats, vecs):
    """Batched matrix @ vector over leading dims: result[..., :] =
    mats[..., :, :] @ vecs[..., :]."""
    return _einsum("...ij,...j->...i", mats, vecs)


def stacked_2d_vector_matrix_prod(vecs, mats):
    """Batched vector @ matrix over leading dims: result[..., :] =
    mats[..., :, :].T @ vecs[..., :]."""
    return _einsum("...ij,...i->...j", mats, vecs)


def stacked_2d_matrix_matrix_prod(mats1, mats2):
    """Batched matrix @ matrix over leading dims."""
    return _einsum("...ij,...jk->...ik", mats1, mats2)
