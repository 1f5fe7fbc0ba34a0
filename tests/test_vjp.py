"""Gradients of the transforms: ``jax.vjp`` is the exact adjoint.

Every transform is linear in its input, so its VJP must satisfy the
dot-product identity <A x, y> = <x, A^T y> for random x and cotangent y
(real inner product; a complex output pairs as Re sum(y * A x), the
cotangent convention of ``jax.vjp``).  Checked at f64 (conftest) on the
interleaved and plane layouts, the bandpass variant with an odd-sized
pad/crop chain, 3-D and 1-D, plus the end-to-end gradient of a
reconstruction loss.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import dtcwt_tpu as dt

TOL = 1e-10   # f64 round-off of sums over a few thousand terms


def _rand_like(tree, seed):
    rng = np.random.RandomState(seed)

    def one(a):
        if a is None:
            return None
        if jnp.iscomplexobj(a):
            return jnp.asarray(rng.randn(*a.shape) + 1j * rng.randn(*a.shape),
                               a.dtype)
        return jnp.asarray(rng.randn(*a.shape), a.dtype)
    return jax.tree_util.tree_map(one, tree)


def _dot(a, b):
    """Re sum(a * b) over every leaf of two matching pytrees."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return sum(float(jnp.sum(jnp.real(u * v))) for u, v in zip(la, lb))


def _check_adjoint(f, x, seed=0):
    """<f(x), y> == <x, vjp_f(y)> for a linear f."""
    fx, vjp = jax.vjp(f, x)
    y = _rand_like(fx, seed)
    (xbar,) = vjp(y)
    lhs, rhs = _dot(y, fx), _dot(xbar, x)
    assert abs(lhs - rhs) <= TOL * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("nlevels", [1, 2, 3])
def test_forward_2d_vjp_is_adjoint(nlevels):
    t = dt.Transform2d()
    x = jnp.asarray(np.random.RandomState(1).randn(32, 48))
    _check_adjoint(lambda a: t.forward(a, nlevels), x)


@pytest.mark.parametrize("nlevels", [1, 2, 3])
def test_inverse_2d_vjp_is_adjoint(nlevels):
    t = dt.Transform2d()
    p = _rand_like(t.forward(jnp.zeros((32, 48)), nlevels), 2)
    _check_adjoint(t.inverse, p, seed=3)


def test_planes_2d_vjp_is_adjoint():
    t = dt.Transform2d()
    x = jnp.asarray(np.random.RandomState(4).randn(2, 32, 32))
    _check_adjoint(lambda a: t.forward(a, 3, layout="planes"), x)
    p = _rand_like(t.forward(jnp.zeros((2, 32, 32)), 3, layout="planes"), 5)
    _check_adjoint(t.inverse, p, seed=6)


def test_bandpass_odd_size_vjp_is_adjoint():
    """Bandpass filters and a 30x34 image (per-level pad and crop)."""
    t = dt.Transform2d("near_sym_b_bp", "qshift_b_bp")
    x = jnp.asarray(np.random.RandomState(7).randn(30, 34))
    _check_adjoint(lambda a: t.forward(a, 3), x)
    p = _rand_like(t.forward(jnp.zeros((30, 34)), 3), 8)
    _check_adjoint(t.inverse, p, seed=9)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_3d_vjp_is_adjoint(layout):
    t = dt.Transform3d()
    x = jnp.asarray(np.random.RandomState(10).randn(16, 16, 16))
    _check_adjoint(lambda a: t.forward(a, 2, layout=layout), x)
    p = _rand_like(t.forward(jnp.zeros((16, 16, 16)), 2, layout=layout), 11)
    _check_adjoint(t.inverse, p, seed=12)


def test_1d_vjp_is_adjoint():
    t = dt.Transform1d()
    x = jnp.asarray(np.random.RandomState(13).randn(128, 3))
    _check_adjoint(lambda a: t.forward(a, 4), x)
    p = _rand_like(t.forward(jnp.zeros((128, 3)), 4), 14)
    _check_adjoint(t.inverse, p, seed=15)


def test_grad_of_reconstruction_loss():
    """Perfect reconstruction makes ||inverse(forward(x))||^2 = ||x||^2, so
    its gradient is 2x."""
    t = dt.Transform2d()
    x = jnp.asarray(np.random.RandomState(16).randn(64, 64))
    g = jax.grad(lambda a: jnp.sum(t.inverse(t.forward(a, 3)) ** 2))(x)
    assert float(jnp.abs(g - 2 * x).max()) < 1e-10
