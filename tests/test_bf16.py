"""bfloat16 storage path + complex-free plane packing.

bf16 is a storage dtype (half the device-memory traffic of f32 for a
memory-bound transform).  There is no bf16 complex dtype, so bf16 pyramids
exist only in the plane layout (band-major re/im planes); the interleaved
layout promotes to f32/complex64.  Arithmetic discipline: bf16 arrays are
*storage* — the filter math runs at f32 (utils.compute_view).

Also pins q2c_planes/c2q_planes (ops/packing.py) against the complex
originals: same quad math as the reference ``numpy/transform2d.py:301-350``
with no complex intermediate.
"""

import numpy as np
import jax
import jax.numpy as jnp

import dtcwt_tpu as dt
from dtcwt_tpu.ops.packing import q2c, c2q, q2c_planes, c2q_planes

# bf16 mantissa is 8 bits (eps ~ 7.8e-3); a 3-level roundtrip of an O(1)
# image accumulates a handful of per-stage roundings.
BF16_TOL_2D = 0.04
BF16_TOL_3D = 0.08


def _rand(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_q2c_planes_matches_q2c():
    y = np.random.RandomState(0).randn(3, 16, 24)
    (r0, i0), (r1, i1) = q2c_planes(jnp.asarray(y))
    z0, z1 = q2c(jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(r0) + 1j * np.asarray(i0),
                               np.asarray(z0), atol=1e-12)
    np.testing.assert_allclose(np.asarray(r1) + 1j * np.asarray(i1),
                               np.asarray(z1), atol=1e-12)


def test_c2q_planes_matches_c2q():
    rng = np.random.RandomState(1)
    w0 = rng.randn(2, 8, 12) + 1j * rng.randn(2, 8, 12)
    w1 = rng.randn(2, 8, 12) + 1j * rng.randn(2, 8, 12)
    got = c2q_planes((jnp.asarray(w0.real), jnp.asarray(w0.imag)),
                     (jnp.asarray(w1.real), jnp.asarray(w1.imag)),
                     0.7, 1.3)
    want = c2q(jnp.asarray(w0), jnp.asarray(w1), 0.7, 1.3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)


def test_bf16_planes_roundtrip_2d():
    x = _rand((128, 128))
    t = dt.Transform2d()
    p = t.forward(jnp.asarray(x, jnp.bfloat16), 3, layout="planes")
    assert p.lowpass.dtype == jnp.bfloat16
    assert all(r.dtype == jnp.bfloat16 for r in p.highpasses_re)
    rec = t.inverse(p)
    assert rec.dtype == jnp.bfloat16
    err = float(np.abs(np.asarray(rec, np.float32) - x).max())
    assert err < BF16_TOL_2D, err


def test_bf16_planes_roundtrip_3d():
    v = _rand((16, 32, 32), seed=2)
    t3 = dt.Transform3d()
    p = t3.forward(jnp.asarray(v, jnp.bfloat16), 2, layout="planes")
    assert p.lowpass.dtype == jnp.bfloat16
    rec = t3.inverse(p)
    assert rec.dtype == jnp.bfloat16
    err = float(np.abs(np.asarray(rec, np.float32) - v).max())
    assert err < BF16_TOL_3D, err


def test_bf16_interleaved_promotes():
    x = jnp.asarray(_rand((64, 64)), jnp.bfloat16)
    p2 = dt.Transform2d().forward(x, 2)
    assert p2.highpasses[0].dtype == jnp.complex64
    assert p2.lowpass.dtype == jnp.float32
    v = jnp.asarray(_rand((16, 16, 16), seed=3), jnp.bfloat16)
    p3 = dt.Transform3d().forward(v, 1)
    assert p3.highpasses[0].dtype == jnp.complex64
    s = jnp.asarray(_rand((128,), seed=4), jnp.bfloat16)
    p1 = dt.Transform1d().forward(s, 2)
    assert p1.highpasses[0].dtype == jnp.complex64


def test_bf16_tracks_f32_path():
    """The bf16 pyramid is the f32 pyramid rounded to bf16, not a different
    computation: subband planes must agree to bf16 resolution."""
    x = _rand((64, 96), seed=5)
    t = dt.Transform2d()
    pf = t.forward(x, 2, layout="planes")
    pb = t.forward(jnp.asarray(x, jnp.bfloat16), 2, layout="planes")
    for rf, rb in zip(pf.highpasses_re, pb.highpasses_re):
        err = float(np.abs(np.asarray(rf)
                           - np.asarray(rb, np.float32)).max())
        scale = float(np.abs(np.asarray(rf)).max())
        assert err < 0.02 * max(scale, 1.0), err


def test_bf16_gain_mask():
    """Degree-order gain semantics hold for bf16 plane pyramids (zeroing a
    band kills exactly that band's contribution)."""
    x = _rand((64, 64), seed=6)
    t = dt.Transform2d()
    gm = np.ones((6, 2), np.float32)
    gm[3, :] = 0.0
    pf = t.forward(x, 2, layout="planes")
    want = t.inverse(pf, gm)                      # f32 oracle
    pb = t.forward(jnp.asarray(x, jnp.bfloat16), 2, layout="planes")
    got = t.inverse(pb, gm)
    assert got.dtype == jnp.bfloat16
    err = float(np.abs(np.asarray(want)
                       - np.asarray(got, np.float32)).max())
    assert err < BF16_TOL_2D, err


def test_1d_planes_layout():
    """1-D ``layout='planes'`` = even/odd deinterleave of the tree output:
    exact parity with the interleaved pyramid (f64), incl. the lane-folded
    long-signal path and gain_mask."""
    t = dt.Transform1d()
    for x, lv in ((np.random.RandomState(0).randn(512, 3), 4),
                  (np.random.RandomState(1).randn(16384), 5)):  # folded
        pi = t.forward(x, lv)
        pp = t.forward(x, lv, layout="planes")
        assert pp.kind == "1d"
        for z, (r, m) in zip(pi.highpasses,
                             zip(pp.highpasses_re, pp.highpasses_im)):
            np.testing.assert_array_equal(
                np.asarray(z), np.asarray(r) + 1j * np.asarray(m))
        np.testing.assert_array_equal(np.asarray(t.inverse(pi)),
                                      np.asarray(t.inverse(pp)))
        gm = np.linspace(1.0, 0.0, lv)
        np.testing.assert_array_equal(np.asarray(t.inverse(pi, gm)),
                                      np.asarray(t.inverse(pp, gm)))


def test_1d_bf16_planes_roundtrip():
    t = dt.Transform1d()
    x = _rand((1024,), seed=9)
    p = t.forward(jnp.asarray(x, jnp.bfloat16), 3, layout="planes")
    assert p.lowpass.dtype == jnp.bfloat16
    assert all(r.dtype == jnp.bfloat16 for r in p.highpasses_re)
    rec = t.inverse(p)
    assert rec.dtype == jnp.bfloat16
    err = float(np.abs(np.asarray(rec, np.float32) - x).max())
    assert err < 0.02, err
    assert p.interleaved().highpasses[0].dtype == jnp.complex64


def test_bf16_interleaved_view():
    """`.interleaved()` on a bf16 plane pyramid yields a coherent complex64
    Pyramid (bf16 has no complex dtype) tracking the f32 pyramid."""
    x = _rand((64, 64), seed=8)
    t = dt.Transform2d()
    pb = t.forward(jnp.asarray(x, jnp.bfloat16), 2, layout="planes")
    pi = pb.interleaved()
    pf = t.forward(x, 2)
    assert pi.highpasses[0].dtype == jnp.complex64
    assert pi.lowpass.dtype == jnp.float32
    err = float(np.abs(np.asarray(pi.highpasses[0])
                       - np.asarray(pf.highpasses[0])).max())
    assert err < 0.05, err


def test_sharded_bf16_promotes():
    """Sharded pyramids are interleaved complex, so bf16 input promotes to
    f32 (same rule as the single-device interleaved layout) instead of
    tripping lax.complex."""
    from dtcwt_tpu.parallel import (ShardedTransform1d, ShardedTransform2d,
                                    ShardedTransform3d, make_mesh)
    x = jnp.asarray(_rand((4, 64, 64), seed=10), jnp.bfloat16)
    st2 = ShardedTransform2d(make_mesh((2, 4), ("data", "rows")))
    p2 = st2.forward(x, 2)
    assert p2.highpasses[0].dtype == jnp.complex64
    st3 = ShardedTransform3d(make_mesh((2, 4), ("data", "depth")))
    v = jnp.asarray(_rand((2, 32, 16, 16), seed=11), jnp.bfloat16)
    assert st3.forward(v, 2).highpasses[0].dtype == jnp.complex64
    st1 = ShardedTransform1d(make_mesh((2, 4), ("data", "rows")))
    s = jnp.asarray(_rand((2, 4096, 1), seed=12), jnp.bfloat16)
    assert st1.forward(s, 3).highpasses[0].dtype == jnp.complex64


def test_f64_unaffected():
    """The storage/compute split is a bf16-only affordance: the f64
    verification path still reconstructs to 1e-12."""
    x = _rand((64, 64), seed=7).astype(np.float64)
    t = dt.Transform2d()
    p = t.forward(x, 3, layout="planes")
    assert p.highpasses_re[0].dtype == jnp.float64
    rec = t.inverse(p)
    assert rec.dtype == jnp.float64
    assert float(np.abs(np.asarray(rec) - x).max()) < 1e-12
