"""Sharded 3-D transform == single-device transform, on a virtual 8-device
CPU mesh.  Depth-axis spatial decomposition (halo exchange over ppermute)
for the reference's worst-scaling case — its Python plane-loop 3-D path
(upstream ``dtcwt/numpy/transform3d.py:37-206``)."""

import numpy as np
import pytest
import jax

from dtcwt_tpu import Transform3d
from dtcwt_tpu.parallel import ShardedTransform3d, make_mesh

RNG = np.random.RandomState(5)


def _mesh(data=2, depth=4):
    devs = jax.devices()
    assert len(devs) >= data * depth
    return make_mesh((data, depth), ("data", "depth"), devs[:data * depth])


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2)])
def test_sharded3d_matches_single(mesh_shape):
    mesh = _mesh(*mesh_shape)
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    X = RNG.rand(mesh_shape[0], 64, 32, 32)
    ps = st.forward(X, nlevels=3)
    p = t.forward(X, nlevels=3)
    assert np.abs(np.asarray(ps.lowpass) - np.asarray(p.lowpass)).max() < 1e-12
    for a, b in zip(ps.highpasses, p.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12


def test_sharded3d_roundtrip_and_inverse_parity():
    mesh = _mesh(1, 8)
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    X = RNG.rand(1, 128, 16, 16)
    ps = st.forward(X, nlevels=3)
    rec = np.asarray(st.inverse(ps))
    want = np.asarray(t.inverse(t.forward(X, nlevels=3)))
    assert np.abs(rec - want).max() < 1e-12
    assert np.abs(rec - X).max() < 1e-11


def test_sharded3d_ext8_and_hw_crops():
    """ext_mode=8 and H/W sizes that force edge-repeat pads (crops in the
    inverse) — pads/crops along unsharded axes are shard-local."""
    mesh = _mesh(2, 4)
    t = Transform3d(ext_mode=8)
    st = ShardedTransform3d(mesh, ext_mode=8)
    X = RNG.rand(2, 64, 24, 24)
    ps = st.forward(X, nlevels=2)
    p = t.forward(X, nlevels=2)
    for a, b in zip(ps.highpasses, p.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    rec = np.asarray(st.inverse(ps))
    assert np.abs(rec - np.asarray(t.inverse(p))).max() < 1e-12


def test_sharded3d_discard_level_1():
    mesh = _mesh(2, 4)
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    X = RNG.rand(2, 64, 32, 32)
    ps = st.forward(X, nlevels=2, discard_level_1=True)
    p = t.forward(X, nlevels=2, discard_level_1=True)
    assert ps.highpasses[0] is None
    assert np.abs(np.asarray(ps.lowpass) - np.asarray(p.lowpass)).max() < 1e-12
    assert np.abs(np.asarray(ps.highpasses[1])
                  - np.asarray(p.highpasses[1])).max() < 1e-12
    rec = np.asarray(st.inverse(ps))
    assert np.abs(rec - np.asarray(t.inverse(p))).max() < 1e-12


def test_sharded3d_depth_degrade_warns(caplog):
    """Depth too shallow for deep levels: coarse levels gather and run
    replicated; a fully unusable depth axis logs a warning."""
    import logging
    mesh = _mesh(2, 4)
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    X = RNG.rand(2, 32, 64, 64)
    ps = st.forward(X, nlevels=4)
    p = t.forward(X, nlevels=4)
    for a, b in zip(ps.highpasses, p.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    # a depth axis that can't be used at all warns
    X2 = RNG.rand(2, 6, 64, 64)     # 6 not divisible by 4
    with caplog.at_level(logging.WARNING,
                         logger="dtcwt_tpu.parallel.transform3d_dist"):
        st.forward(X2, nlevels=1)
    assert any("depth axis" in r.message for r in caplog.records)


def test_sharded3d_inverse_resharding_transition():
    """Deep pyramids with unshardable coarse levels keep their fine levels
    depth-sharded: replicated coarse synthesis, one re-shard slice."""
    mesh = _mesh(2, 4)
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    X = RNG.rand(2, 64, 32, 32)
    ps = st.forward(X, nlevels=4)       # coarsest depth 4 < halo on 4 shards
    rec = np.asarray(st.inverse(ps))
    want = np.asarray(t.inverse(t.forward(X, nlevels=4)))
    assert np.abs(rec - want).max() < 1e-11


def test_sharded3d_grad_flows():
    mesh = _mesh(2, 4)
    st = ShardedTransform3d(mesh)
    X = RNG.rand(2, 32, 16, 16)

    def loss(x):
        p = st._fwd_built(x.shape, x.dtype, 2, False)(x)
        return sum(jax.numpy.sum(jax.numpy.abs(h) ** 2)
                   for h in p.highpasses) + jax.numpy.sum(p.lowpass ** 2)

    g = jax.grad(loss)(jax.numpy.asarray(X))
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_sharded3d_planes_layout():
    """layout='planes' matches interleaved + single-device planes; the
    inverse accepts the plane container; bf16 planes stay bf16."""
    import jax.numpy as jnp
    mesh = _mesh()
    st = ShardedTransform3d(mesh)
    v = RNG.rand(2, 32, 16, 16)
    pi = st.forward(v, 2)
    pp = st.forward(v, 2, layout="planes")
    zi = pp.interleaved()
    for a, b in zip(pi.highpasses, zi.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    sp = Transform3d().forward(v, 2, layout="planes")
    for a, b in zip(pp.highpasses_re, sp.highpasses_re):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    ri, rp = np.asarray(st.inverse(pi)), np.asarray(st.inverse(pp))
    assert np.abs(ri - rp).max() < 1e-12
    # discard_level_1 plane slot is (None, None)
    pd = st.forward(v, 2, discard_level_1=True, layout="planes")
    assert pd.highpasses_re[0] is None
    assert st.inverse(pd).shape == v.shape
    # bf16 planes
    vb = jnp.asarray(v.astype(np.float32), jnp.bfloat16)
    pb = st.forward(vb, 2, layout="planes")
    assert pb.highpasses_re[0].dtype == jnp.bfloat16
    rb = st.inverse(pb)
    assert rb.dtype == jnp.bfloat16
    assert np.abs(np.asarray(rb, np.float64) - v).max() < 0.1


def test_sharded3d_bf16_plane_bit_parity():
    """bf16 plane pyramids from the sharded 3-D forward/inverse are
    BIT-identical to the single-device ones (per-level lowpass
    requantization to the storage dtype, incl. discard_level_1)."""
    import jax.numpy as jnp
    mesh = _mesh()
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    v = RNG.rand(2, 32, 16, 16).astype(np.float32)
    vb = jnp.asarray(v, jnp.bfloat16)
    ps = st.forward(vb, 2, layout="planes")
    p1 = t.forward(vb, 2, layout="planes")
    assert np.array_equal(np.asarray(ps.lowpass, np.float32),
                          np.asarray(p1.lowpass, np.float32))
    for a, b in zip(ps.highpasses_re + ps.highpasses_im,
                    p1.highpasses_re + p1.highpasses_im):
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
    assert np.array_equal(np.asarray(st.inverse(ps), np.float32),
                          np.asarray(t.inverse(p1), np.float32))
    pd = st.forward(vb, 2, discard_level_1=True, layout="planes")
    pd1 = t.forward(vb, 2, discard_level_1=True, layout="planes")
    assert np.array_equal(np.asarray(pd.lowpass, np.float32),
                          np.asarray(pd1.lowpass, np.float32))
    assert np.array_equal(np.asarray(st.inverse(pd), np.float32),
                          np.asarray(t.inverse(pd1), np.float32))


def test_sharded3d_forward_include_scale():
    """include_scale on the sharded 3-D forward matches the single-device
    per-level lowpass volumes."""
    mesh = _mesh()
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    v = RNG.rand(2, 32, 16, 16)
    ps = st.forward(v, 2, include_scale=True)
    p = t.forward(v, 2, include_scale=True)
    assert len(ps.scales) == 2
    for a, b in zip(ps.scales, p.scales):
        assert a.shape == b.shape
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12


def test_sharded3d_nlevels0():
    """nlevels=0 returns the single-device empty pyramid instead of a bare
    IndexError; the inverse is the identity."""
    mesh = _mesh()
    st = ShardedTransform3d(mesh)
    v = RNG.rand(2, 16, 16, 16)
    p = st.forward(v, nlevels=0)
    assert p.highpasses == ()
    assert np.abs(np.asarray(p.lowpass) - v).max() == 0.0
    assert np.abs(np.asarray(st.inverse(p)) - v).max() == 0.0


def _mesh2(data=2, depth=2, rows=2):
    devs = jax.devices()
    assert len(devs) >= data * depth * rows
    return make_mesh((data, depth, rows), ("data", "depth", "rows"),
                     devs[:data * depth * rows])


def test_sharded3d_rows_axis_matches_single():
    """2-axis spatial decomposition (depth x rows) of a volume matches the
    single-device transform to f64, roundtrips, and transitions off the
    rows plan as H decimates."""
    import jax.numpy as jnp
    mesh = _mesh2()
    st = ShardedTransform3d(mesh, rows_axis="rows")
    t = Transform3d()
    v = RNG.rand(2, 32, 32, 16)
    ps = st.forward(v, 2)
    p = t.forward(v, 2)
    assert np.abs(np.asarray(ps.lowpass) - np.asarray(p.lowpass)).max() < 1e-12
    for a, b in zip(ps.highpasses, p.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    assert np.abs(np.asarray(st.inverse(ps)) - v).max() < 1e-12
    # deep pyramid: rows plan falls off mid-pyramid (replicated coarse tail)
    v4 = RNG.rand(2, 16, 64, 16)
    p4 = st.forward(v4, 4)
    q4 = t.forward(v4, 4)
    for a, b in zip(p4.highpasses, q4.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    assert np.abs(np.asarray(st.inverse(p4)) - v4).max() < 1e-12
    # bf16 planes keep bit parity over the 2-axis mesh
    vb = jnp.asarray(np.asarray(v, np.float32), jnp.bfloat16)
    pb = st.forward(vb, 2, layout="planes")
    qb = t.forward(vb, 2, layout="planes")
    for a, b in zip(pb.highpasses_re + pb.highpasses_im + (pb.lowpass,),
                    qb.highpasses_re + qb.highpasses_im + (qb.lowpass,)):
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
    assert np.array_equal(np.asarray(st.inverse(pb), np.float32),
                          np.asarray(t.inverse(qb), np.float32))


def test_sharded3d_rows_axis_discard_and_ext8():
    """rows-sharded discard_level_1 and ext_mode=8 crop paths match the
    single-device transform."""
    mesh = _mesh2()
    st = ShardedTransform3d(mesh, rows_axis="rows")
    t = Transform3d()
    v = RNG.rand(2, 16, 64, 16)
    pd = st.forward(v, 3, discard_level_1=True, include_scale=True)
    qd = t.forward(v, 3, discard_level_1=True, include_scale=True)
    for a, b in zip(pd.scales, qd.scales):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    assert np.abs(np.asarray(st.inverse(pd))
                  - np.asarray(t.inverse(qd))).max() < 1e-12
    st8 = ShardedTransform3d(mesh, rows_axis="rows", ext_mode=8)
    t8 = Transform3d(ext_mode=8)
    v8 = RNG.rand(2, 16, 40, 16)   # H=40: level-2 pad => inverse crop
    p8 = st8.forward(v8, 2)
    q8 = t8.forward(v8, 2)
    for a, b in zip(p8.highpasses, q8.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    assert np.abs(np.asarray(st8.inverse(p8))
                  - np.asarray(t8.inverse(q8))).max() < 1e-12

def test_sharded3d_batch_mesh_matches_single():
    """On a batch-only (spatially replicated) mesh each shard runs the
    single-device level stages on its local volumes; f32 results match the
    single-device transform."""
    mesh = _mesh(8, 1)
    st = ShardedTransform3d(mesh)
    t = Transform3d()
    X = RNG.rand(8, 16, 16, 32).astype(np.float32)
    ps = st.forward(X, nlevels=2)
    rec = np.asarray(st.inverse(ps))
    p = t.forward(X, nlevels=2)
    for a, b in zip(ps.highpasses, p.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-5
    assert np.abs(rec - X).max() < 1e-4
