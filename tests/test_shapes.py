"""Compile-only shape/dtype contract tests via ``jax.eval_shape``.

The reference's TF backend asserts static graph shapes without executing
(``tests/test_tfinputshapes.py:31-173``); the JAX analogue is abstract
evaluation — these tests trace the transforms over a grid of input
configurations and check every output aval without running (or even
compiling) anything, so they are fast and catch shape-rule regressions
across the whole configuration space.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import dtcwt_tpu as dt


def _spec(shape, dtype=jnp.float64):
    return jax.ShapeDtypeStruct(shape, dtype)


def _cdt(dtype):
    return jnp.complex128 if dtype == jnp.float64 else jnp.complex64


@pytest.mark.parametrize("shape", [(64, 64), (4, 64, 96), (2, 3, 128, 64),
                                   (30, 36)])
@pytest.mark.parametrize("nlevels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_transform2d_shapes(shape, nlevels, dtype):
    t = dt.Transform2d()
    p = jax.eval_shape(
        lambda x: t._forward_body(x, nlevels=nlevels, include_scale=True),
        _spec(shape, dtype))
    lead, (H, W) = shape[:-2], shape[-2:]
    assert p.lowpass.shape == lead + (H, W) if nlevels == 0 else True
    h, w = H, W
    for level in range(nlevels):
        if level == 0:
            hs, ws = h // 2, w // 2
        else:
            h, w = h + h % 4, w + w % 4
            hs, ws = h // 4, w // 4
            h, w = h // 2, w // 2
        assert p.highpasses[level].shape == lead + (hs, ws, 6), level
        assert p.highpasses[level].dtype == _cdt(dtype)
        assert p.scales[level].shape == lead + (h, w)
        assert p.scales[level].dtype == dtype
    assert p.lowpass.shape == lead + (h, w)
    # inverse restores the (even-extended) input shape
    r = jax.eval_shape(lambda q: t._inverse_body(q, None),
                       jax.eval_shape(
                           lambda x: t._forward_body(
                               x, nlevels=nlevels, include_scale=False),
                           _spec(shape, dtype)))
    assert r.shape == lead + (H + H % 2, W + W % 2)
    assert r.dtype == dtype


@pytest.mark.parametrize("N,C,nlevels", [(64, 1, 3), (256, 4, 5),
                                         (4096, 2, 6)])
def test_transform1d_shapes(N, C, nlevels):
    t = dt.Transform1d()
    p = jax.eval_shape(
        lambda x: t._forward_body(x, nlevels=nlevels, include_scale=False),
        _spec((N, C)))
    n = N
    for level in range(nlevels):
        if level > 0 and n % 4:
            n += 2
        n //= 2
        assert p.highpasses[level].shape == (n, C)
        assert p.highpasses[level].dtype == jnp.complex128
    # the lowpass is always twice the coarsest subband (level 1 is
    # undecimated; every further level halves both together)
    assert p.lowpass.shape == (2 * n, C)


@pytest.mark.parametrize("shape,nlevels,ext_mode", [
    ((32, 32, 32), 2, 4), ((2, 64, 32, 16), 3, 4), ((32, 32, 32), 2, 8)])
def test_transform3d_shapes(shape, nlevels, ext_mode):
    t = dt.Transform3d(ext_mode=ext_mode)
    p = jax.eval_shape(
        lambda x: t._forward_body(x, nlevels=nlevels, include_scale=False,
                                  discard_level_1=False),
        _spec(shape))
    for level in range(nlevels):
        hp = p.highpasses[level]
        assert hp.shape[-1] == 28
        assert hp.dtype == jnp.complex128
    r = jax.eval_shape(lambda q: t._inverse_body(q), p)
    assert r.shape == shape


def test_channel_format_shapes():
    t = dt.Transform2d()
    for fmt, shape, hp_shape in [
        ("nhw", (5, 64, 64), (5, 32, 32, 6)),
        ("hwc", (64, 64, 3), (32, 32, 3, 6)),
        ("nchw", (2, 3, 64, 64), (2, 3, 32, 32, 6)),
        ("nhwc", (2, 64, 64, 3), (2, 32, 32, 3, 6)),
    ]:
        p = jax.eval_shape(
            lambda x: t.forward_channels(x, fmt, nlevels=2), _spec(shape))
        assert p.highpasses[0].shape == hp_shape, fmt
