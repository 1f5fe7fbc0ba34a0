"""Plane-layout (band-major) pyramid tests.

``Transform2d.forward(..., layout='planes')`` returns a
:class:`dtcwt_tpu.PlanePyramid` holding each level's subbands as band-major
re/im real planes in ``PLANE_BAND_ORDER`` (no complex ``[..., 6]``
interleave on the forward, no band re-split on the inverse; the only layout
that stores bfloat16).  These tests pin the layout's contract:

* planes -> interleaved conversion reproduces the standard pyramid exactly
* the inverse accepts either container and agrees to f32 tolerance
* gain_mask semantics match the reference's degree-order convention
* gradients flow through the plane path
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dtcwt_tpu as dt
from dtcwt_tpu import PlanePyramid, PLANE_BAND_ORDER


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


def test_plane_band_order_is_a_permutation():
    assert sorted(PLANE_BAND_ORDER) == list(range(6))
    # quad pairs (0,5), (1,4), (2,3) sit adjacent
    for p in range(0, 6, 2):
        assert PLANE_BAND_ORDER[p] + PLANE_BAND_ORDER[p + 1] == 5


def test_planes_match_interleaved_f64_xla():
    t = dt.Transform2d()
    x = _rand((128, 256), dtype=np.float64)
    p = t.forward(x, 3)
    pp = t.forward(x, 3, layout="planes")
    assert isinstance(pp, PlanePyramid)
    assert pp.nlevels == 3
    for re in pp.highpasses_re:
        assert re.shape[-3] == 6
    pi = pp.interleaved()
    for a, b in zip(p.highpasses, pi.highpasses):
        assert float(jnp.abs(a - b).max()) < 1e-12
    r = t.inverse(pp)
    assert float(jnp.abs(r - x).max()) < 1e-11


def test_planes_match_interleaved_f32():
    t = dt.Transform2d()
    x = _rand((64, 512))
    p = t.forward(x, 3)
    pp = t.forward(x, 3, layout="planes")
    for a, b in zip(p.highpasses, pp.interleaved().highpasses):
        assert float(jnp.abs(a - b).max()) < 1e-4
    r = t.inverse(pp)
    assert float(jnp.abs(r - x).max()) < 1e-4


def test_from_interleaved_roundtrip_exact():
    t = dt.Transform2d()
    p = t.forward(_rand((64, 512)), 2)
    p2 = PlanePyramid.from_interleaved(p).interleaved()
    for a, b in zip(p.highpasses, p2.highpasses):
        assert float(jnp.abs(a - b).max()) == 0.0


def test_gain_mask_degree_order_convention():
    """gain_mask stays in the reference's degree order for both layouts."""
    t = dt.Transform2d()
    x = _rand((64, 256), dtype=np.float64)
    gm = np.linspace(0.0, 1.5, 18).reshape(6, 3)
    p = t.forward(x, 3)
    pp = t.forward(x, 3, layout="planes")
    r1 = t.inverse(p, gm)
    r2 = t.inverse(pp, gm)
    assert float(jnp.abs(r1 - r2).max()) < 1e-12


def test_bp_variant_planes():
    t = dt.Transform2d("near_sym_b_bp", "qshift_b_bp")
    x = _rand((64, 512))
    p = t.forward(x, 3)
    pp = t.forward(x, 3, layout="planes")
    for a, b in zip(p.highpasses, pp.interleaved().highpasses):
        assert float(jnp.abs(a - b).max()) < 1e-4
    assert float(jnp.abs(t.inverse(pp) - t.inverse(p)).max()) < 1e-4


def test_batched_and_fallback_shapes():
    """Batched inputs and sizes that are not powers of two keep the
    plane-layout contract."""
    t = dt.Transform2d()
    x = _rand((3, 2, 62, 130), seed=2)
    pp = t.forward(x, 2, layout="planes")
    assert pp.highpasses_re[0].shape[:2] == (3, 2)
    r = t.inverse(pp)
    rs = t.inverse(t.forward(x, 2))
    assert float(jnp.abs(r - rs).max()) < 1e-4


def test_grad_through_plane_layout():
    t = dt.Transform2d()
    x = jnp.asarray(_rand((64, 256)))

    def loss(a):
        p = t._forward_body(a, nlevels=2, include_scale=False,
                            layout="planes")
        s = sum(jnp.sum(v ** 2) for v in p.highpasses_re)
        s += sum(jnp.sum(v ** 2) for v in p.highpasses_im)
        return s + jnp.sum(p.lowpass ** 2)

    g = jax.grad(loss)(x)
    assert np.isfinite(np.asarray(g)).all()
    # the transform is orthogonal-ish; grad of sum-of-squares ~ 2x
    assert float(jnp.abs(g - 2 * x).max()) < 0.5


def test_include_scale_and_nlevels0():
    t = dt.Transform2d()
    x = _rand((64, 256))
    pp = t.forward(x, 2, include_scale=True, layout="planes")
    assert pp.scales is not None and len(pp.scales) == 2
    p0 = t.forward(x, 0, layout="planes")
    assert p0.nlevels == 0 and p0.highpasses_re == ()


def test_layout_validation():
    t = dt.Transform2d()
    with pytest.raises(ValueError):
        t.forward(_rand((32, 32)), 2, layout="bogus")
    with pytest.raises(ValueError):
        dt.Transform3d().forward(_rand((8, 8, 8)), 2, layout="bogus")


# ---------------------------------------------------------------------------
# 3-D plane layout (kind='3d': [..., 28, P, Q, R] planes, octant band order)
# ---------------------------------------------------------------------------

def test_3d_planes_match_interleaved_f64_xla():
    t3 = dt.Transform3d()
    v = _rand((32, 32, 32), dtype=np.float64)
    p = t3.forward(v, 3)
    pp = t3.forward(v, 3, layout="planes")
    assert isinstance(pp, PlanePyramid) and pp.kind == "3d"
    assert pp.highpasses_re[0].shape[-4] == 28
    for a, b in zip(p.highpasses, pp.interleaved().highpasses):
        assert float(jnp.abs(a - b).max()) < 1e-13
    r = t3.inverse(pp)
    rs = t3.inverse(p)
    assert float(jnp.abs(r - rs).max()) < 1e-13
    assert float(jnp.abs(r - v).max()) < 1e-10


def test_3d_planes_f32_and_discard_level_1():
    t3 = dt.Transform3d()
    v = _rand((32, 32, 32))
    pp = t3.forward(v, 2, layout="planes")
    p = t3.forward(v, 2)
    for a, b in zip(p.highpasses, pp.interleaved().highpasses):
        assert float(jnp.abs(a - b).max()) < 1e-4
    assert float(jnp.abs(t3.inverse(pp) - t3.inverse(p)).max()) < 1e-4
    pd = t3.forward(v, 2, discard_level_1=True, layout="planes")
    assert pd.highpasses_re[0] is None
    rd = t3.inverse(pd)
    rds = t3.inverse(t3.forward(v, 2, discard_level_1=True))
    assert float(jnp.abs(rd - rds).max()) < 1e-4


def test_3d_from_interleaved_roundtrip_exact():
    t3 = dt.Transform3d()
    p = t3.forward(_rand((16, 16, 32)), 2)
    p2 = PlanePyramid.from_interleaved(p, kind="3d").interleaved()
    for a, b in zip(p.highpasses, p2.highpasses):
        assert float(jnp.abs(a - b).max()) == 0.0


def test_unpack_plane_pyramid():
    """utils.unpack accepts a PlanePyramid (through its interleaved view)."""
    from dtcwt_tpu.utils import unpack
    t = dt.Transform2d()
    x = np.random.RandomState(11).rand(64, 64)
    pi = t.forward(x, 3)
    pp = t.forward(x, 3, layout="planes")
    li = list(unpack(pi))
    lp = list(unpack(pp))
    assert len(li) == len(lp) == 2
    assert np.abs(np.asarray(lp[0]) - np.asarray(li[0])).max() == 0.0
    for a, b in zip(lp[1], li[1]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    # include_scale pyramids unpack to three parts
    pps = t.forward(x, 3, layout="planes", include_scale=True)
    parts = list(unpack(pps))
    assert len(parts) == 3
