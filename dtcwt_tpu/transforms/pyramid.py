"""The transform-domain container: a JAX pytree.

Parity surface: upstream ``dtcwt/numpy/common.py:5-33`` (attributes
``lowpass``, ``highpasses``, ``scales``).  Unlike the reference's three
backend-specific containers (NumPy arrays / OpenCL device handles / lazy TF
graph ops), there is exactly one Pyramid here: a registered pytree, so it
flows through ``jit`` / ``vmap`` / ``shard_map`` / optimizers untouched and
device placement is owned by XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

__all__ = ["Pyramid", "PlanePyramid", "PLANE_BAND_ORDER"]

#: Band order of :class:`PlanePyramid` planes: plane ``p`` holds the subband
#: whose *degree index* (the reference's 15/45/75/105/135/165-degree order,
#: ``numpy/transform2d.py:112-130``) is ``PLANE_BAND_ORDER[p]``: "pair
#: order", in which the (p-q, p+q) bands of each quad — (0,5), (1,4),
#: (2,3) — sit adjacent, as the q2c pack produces and c2q consumes them.
PLANE_BAND_ORDER = (0, 5, 1, 4, 2, 3)

# position of degree band d in the plane order (inverse permutation)
_PLANE_POS = tuple(PLANE_BAND_ORDER.index(d) for d in range(6))


@jax.tree_util.register_pytree_node_class
class Pyramid:
    """A DTCWT pyramid.

    :ivar lowpass: coarsest-scale real lowpass image/signal/volume.
    :ivar highpasses: tuple of per-level complex subband arrays
        (``[..., H_l, W_l, 6]`` in 2-D, ``[..., N_l]`` in 1-D,
        ``[..., D_l, H_l, W_l, 28]`` in 3-D).
    :ivar scales: optional tuple of intermediate lowpass images (present
        when the transform ran with ``include_scale=True``).
    """

    __slots__ = ("lowpass", "highpasses", "scales")

    def __init__(self, lowpass, highpasses: Tuple, scales: Optional[Tuple] = None):
        self.lowpass = lowpass
        self.highpasses = tuple(highpasses)
        self.scales = None if scales is None else tuple(scales)

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.lowpass, self.highpasses, self.scales), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        lowpass, highpasses, scales = children
        return cls(lowpass, highpasses, scales)

    # -- conveniences --------------------------------------------------------
    @property
    def nlevels(self) -> int:
        return len(self.highpasses)

    def block_until_ready(self):
        jax.block_until_ready((self.lowpass, self.highpasses, self.scales))
        return self

    def __repr__(self):
        hp = ", ".join(str(tuple(h.shape)) for h in self.highpasses)
        return "Pyramid(lowpass={}, highpasses=[{}]{})".format(
            tuple(self.lowpass.shape), hp,
            "" if self.scales is None else ", scales=%d" % len(self.scales))


@jax.tree_util.register_pytree_node_class
class PlanePyramid:
    """A 2-D DTCWT pyramid in the **band-plane layout**.

    Instead of the reference's complex ``[..., H_l, W_l, 6]`` subband arrays
    (real and imaginary parts interleaved at the finest granularity), each
    level holds two real band-major arrays ``[..., 6, H_l, W_l]``
    (``highpasses_re`` / ``highpasses_im``) in :data:`PLANE_BAND_ORDER`.
    Produced by ``Transform2d.forward(..., layout='planes')`` and consumed
    by ``Transform2d.inverse``; a jitted forward→process→inverse chain in
    this layout skips the complex ``[..., 6]`` assembly and the inverse's
    band re-split.  It is also the only layout that stores bfloat16.

    The same container carries the 3-D transform's plane layout
    (``kind='3d'``): band-major ``[..., 28, P_l, Q_l, R_l]`` planes in the
    reference's own octant band order (no permutation).

    Convert with :meth:`interleaved` / :meth:`from_interleaved` at the API
    boundary when reference-layout subbands are needed.
    """

    __slots__ = ("lowpass", "highpasses_re", "highpasses_im", "scales",
                 "kind")

    def __init__(self, lowpass, highpasses_re: Tuple, highpasses_im: Tuple,
                 scales: Optional[Tuple] = None, kind: str = "2d"):
        self.lowpass = lowpass
        self.highpasses_re = tuple(highpasses_re)
        self.highpasses_im = tuple(highpasses_im)
        self.scales = None if scales is None else tuple(scales)
        self.kind = kind

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.lowpass, self.highpasses_re, self.highpasses_im,
                self.scales), self.kind

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, kind=aux)

    # -- conversions ---------------------------------------------------------
    def interleaved(self) -> "Pyramid":
        """The reference-layout :class:`Pyramid` (complex band-minor
        subbands).  One relayout pass per level."""
        import jax.numpy as jnp
        from jax import lax

        def pack(re, im):
            if re is None:
                return None
            re, im = jnp.asarray(re), jnp.asarray(im)
            if re.dtype == jnp.bfloat16:
                # no bf16 complex dtype exists; the interleaved view of a
                # bf16 plane pyramid is complex64
                re, im = re.astype(jnp.float32), im.astype(jnp.float32)
            z = lax.complex(re, im)
            if self.kind == "1d":
                return z            # no band axis to reorder
            if self.kind == "3d":
                return jnp.moveaxis(z, -4, -1)
            # static-slice band reorder (plane order -> degrees); an index-
            # array permutation would lower to a full-array gather
            return jnp.stack([z[..., p, :, :] for p in _PLANE_POS], axis=-1)

        up = lambda a: (a.astype(jnp.float32)
                        if jnp.asarray(a).dtype == jnp.bfloat16 else a)
        return Pyramid(up(self.lowpass),
                       tuple(pack(re, im) for re, im in
                             zip(self.highpasses_re, self.highpasses_im)),
                       None if self.scales is None
                       else tuple(up(s) for s in self.scales))

    @classmethod
    def from_interleaved(cls, p: "Pyramid", kind: str = "2d"
                         ) -> "PlanePyramid":
        """Split a reference-layout pyramid into band planes."""
        import jax.numpy as jnp

        def split(yh):
            if yh is None:
                return None, None
            yh = jnp.asarray(yh)
            if kind == "1d":
                zp = yh
            elif kind == "3d":
                zp = jnp.moveaxis(yh, -1, -4)
            else:
                zp = jnp.stack([yh[..., d] for d in PLANE_BAND_ORDER],
                               axis=-3)
            return jnp.real(zp), jnp.imag(zp)

        planes = [split(h) for h in p.highpasses]
        return cls(p.lowpass, tuple(r for r, _ in planes),
                   tuple(i for _, i in planes), p.scales, kind=kind)

    # -- conveniences --------------------------------------------------------
    @property
    def nlevels(self) -> int:
        return len(self.highpasses_re)

    def block_until_ready(self):
        jax.block_until_ready((self.lowpass, self.highpasses_re,
                               self.highpasses_im, self.scales))
        return self

    def __repr__(self):
        hp = ", ".join(str(tuple(h.shape)) for h in self.highpasses_re)
        return "PlanePyramid(lowpass={}, planes=[{}]{})".format(
            tuple(self.lowpass.shape), hp,
            "" if self.scales is None else ", scales=%d" % len(self.scales))


def pyramid_to_device(p) -> "Pyramid | PlanePyramid":
    """Move a (possibly host-side) pyramid of either container onto the
    device; ``None`` entries (a discarded level) stay ``None``."""
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, p)
