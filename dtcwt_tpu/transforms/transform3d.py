"""3-D dual-tree complex wavelet transform (forward + inverse).

Behavioral parity surface: upstream ``dtcwt/numpy/transform3d.py``
(forward :37-131, inverse :133-206, _level1_xfm :208-289, _level2_xfm
:317-383, _level1_ifm :385-440, _level2_ifm :460-526, no-highpass variants
:291-315/:442-458), including ``ext_mode`` 4/8 divisibility + edge-repeat
padding, ``discard_level_1`` (28 directional subbands -> 1:1 redundancy) and
the inverse-side crop rules.

Redesign: the reference loops over 2-D planes in Python, calling
column filters per slice (its hottest code path).  Here each level is three
whole-volume separable axis passes over ``[..., D, H, W]`` (the filter
primitives are axis-parameterised and batched), so one jit-compiled program
covers any batch with no Python-level plane loops.  The reference's "work
array" double-size scratch is dropped: its even-filter padding turns out to
be vestigial (the padded samples are never consumed by later passes), so the
transform is a pure separable filter tree plus the octet<->complex packing.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp

from dtcwt_tpu.ops import fb
from dtcwt_tpu.ops.packing import (cube2c, c2cube, cube2c_planes,
                                   c2cube_planes)
from dtcwt_tpu.transforms.pyramid import (Pyramid, PlanePyramid,
                                          pyramid_to_device)
from dtcwt_tpu.transforms.transform2d import (
    DEFAULT_BIORT, DEFAULT_QSHIFT, normalize_biort, normalize_qshift)
from dtcwt_tpu.utils import compute_view as _comp

__all__ = ["Transform3d"]

# octant order of the 28 highpass directions (reference transform3d.py:
# :278-289).  Letters index (dim-2 half, dim-3 half, dim-1 half) as in the
# reference comment; tuples are (i, j, k) = halves of (dim-3, dim-2, dim-1).
_OCTANTS = (
    (0, 1, 0),   # HLL
    (1, 0, 0),   # LHL
    (1, 1, 0),   # HHL
    (0, 0, 1),   # LLH
    (0, 1, 1),   # HLH
    (1, 0, 1),   # LHH
    (1, 1, 1),   # HHH
)


def _repeat_edges(x, axis: int, n: int):
    """Append *n* copies of the first/last sample at each end of *axis*."""
    first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    last = jax.lax.slice_in_dim(x, x.shape[axis] - 1, x.shape[axis], axis=axis)
    parts = [first] * n + [x] + [last] * n
    return jnp.concatenate(parts, axis=axis)


def _crop(x, axis: int, n: int):
    return jax.lax.slice_in_dim(x, n, x.shape[axis] - n, axis=axis)


class Transform3d:
    """An n-level 3-D DTCWT with 28 directional subbands per level.

    :param ext_mode: 4 or 8 — the divisibility contract / edge-repeat
        padding mode (see reference docstring, ``transform3d.py:60-67``).
    """

    def __init__(self, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 ext_mode: int = 4):
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if ext_mode not in (4, 8):
            raise ValueError("ext_mode must be one of 4 or 8")
        self.ext_mode = ext_mode
        self._fwd = jax.jit(self._forward_body,
                            static_argnames=("nlevels", "include_scale",
                                             "discard_level_1", "layout"))
        self._inv = jax.jit(self._inverse_body)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3, include_scale: bool = False,
                discard_level_1: bool = False,
                layout: str = "interleaved") -> Pyramid:
        """Forward transform of a ``[..., D, H, W]`` real volume.  Each
        highpass level is ``[..., D', H', W', 28]`` complex; with
        ``discard_level_1`` the first entry is ``None`` (1:1 redundancy).

        ``layout='planes'`` returns a :class:`PlanePyramid` (``kind='3d'``)
        holding each level as band-major re/im f32 planes
        ``[..., 28, D', H', W']`` in the reference's octant band order —
        no complex packing on the forward and no band re-split on the
        inverse (``inverse`` accepts either container)."""
        X = jnp.asarray(X)
        if X.ndim < 3:
            raise ValueError("Transform3d.forward needs at least a 3-D input")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        div = 2 if self.ext_mode == 4 else 4
        for d in (-3, -2, -1):
            if X.shape[d] % div != 0:
                raise ValueError(
                    "Input shape should be a multiple of %d in each direction"
                    " when ext_mode == %d" % (div, self.ext_mode))
        return self._fwd(X, nlevels=nlevels, include_scale=include_scale,
                         discard_level_1=discard_level_1, layout=layout)

    def _forward_body(self, X, *, nlevels, include_scale, discard_level_1,
                      layout="interleaved"):
        planes = layout == "planes"
        b = self.biort
        h0o, h1o = b[0], b[2]
        q = self.qshift
        h0a, h0b, h1a, h1b = q[0], q[1], q[4], q[5]

        if not jnp.issubdtype(X.dtype, jnp.inexact):
            X = X.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        if X.dtype == jnp.bfloat16 and not planes:
            # No bfloat16 complex dtype exists; only the plane layout can
            # store bf16 subbands.
            X = X.astype(jnp.float32)

        Yl = X
        Yh = []
        Yscale = []
        for level in range(nlevels):
            if level == 0 and discard_level_1:
                Yl = self._level1_lowpass_only(Yl, h0o)
                Yh.append((None, None) if planes else None)
            elif level == 0:
                Yl, hp = self._level1_fwd(Yl, h0o, h1o, planes=planes)
                Yh.append(hp)
            else:
                Yl, hp = self._level2_fwd(Yl, h0a, h0b, h1a, h1b,
                                          planes=planes)
                Yh.append(hp)
            if include_scale:
                Yscale.append(Yl)
        scales = tuple(Yscale) if include_scale else None
        if planes:
            return PlanePyramid(Yl, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales, kind="3d")
        return Pyramid(Yl, tuple(Yh), scales)

    @staticmethod
    def _pack_octants(octs, planes: bool, dtype=None):
        """Concatenate the 7 octant packs into the 28-band level: trailing
        band axis (interleaved complex) or leading band-major plane axis.
        *dtype* downcasts plane output back to the storage dtype (bf16)."""
        if planes:
            parts = [cube2c_planes(v) for v in octs]
            re = jnp.concatenate([r for r, _ in parts], axis=-4)
            im = jnp.concatenate([i for _, i in parts], axis=-4)
            if dtype is not None:
                re, im = re.astype(dtype), im.astype(dtype)
            return re, im
        return jnp.concatenate([cube2c(v) for v in octs], axis=-1)

    @staticmethod
    def _level1_fwd(X, h0o, h1o, planes: bool = False):
        # Separable tree along dims (-1, -2, -3); branch index 0 = lowpass.
        # (The reference's double-size work array and its even-filter edge
        # pads are not needed: the padded samples are never consumed.)
        # Each stage emits BOTH branches from one read of its input
        # (fb.filter2_axis).
        sdt = X.dtype
        t2 = fb.filter2_axis(_comp(X), h0o, h1o, -1)
        t21 = [fb.filter2_axis(v, h0o, h1o, -2) for v in t2]
        oct_ = {}
        for j in range(2):          # dim -2 half
            for k in range(2):      # dim -1 half
                v = t21[k][j]
                oct_[(0, j, k)], oct_[(1, j, k)] = fb.filter2_axis(
                    v, h0o, h1o, -3)

        even = h0o.size % 2 == 0
        lll = oct_[(0, 0, 0)]
        if even:
            # highpass octants drop the extra trailing sample the even-length
            # filters produce (reference keeps the x-ranges only,
            # transform3d.py:236-241,278-289); the lowpass keeps it.
            def trim(v):
                for ax in (-3, -2, -1):
                    v = jax.lax.slice_in_dim(v, 0, v.shape[ax] - 1, axis=ax)
                return v
        else:
            def trim(v):
                return v
        hp = Transform3d._pack_octants([trim(oct_[o]) for o in _OCTANTS],
                                       planes, dtype=sdt)
        return lll.astype(sdt), hp

    @staticmethod
    def _level1_lowpass_only(X, h0o):
        if h0o.size % 2 == 0:
            raise ValueError("discard_level_1 requires odd-length level-1"
                             " filters")
        # reference order: dims 2, 1, 0 (transform3d.py:304-313)
        out = fb.filter_axis(_comp(X), h0o, -1)
        out = fb.filter_axis(out, h0o, -2)
        out = fb.filter_axis(out, h0o, -3)
        return out.astype(X.dtype)

    def _level2_fwd(self, X, h0a, h0b, h1a, h1b, planes: bool = False):
        div = self.ext_mode
        rep = 1 if div == 4 else 2
        for ax in (-3, -2, -1):
            if X.shape[ax] % div != 0:
                X = _repeat_edges(X, ax, rep)
        sdt = X.dtype
        t2 = fb.dfilt2_axis(_comp(X), (h0b, h0a), (h1b, h1a), -1)
        t21 = [fb.dfilt2_axis(v, (h0b, h0a), (h1b, h1a), -2) for v in t2]
        oct_ = {}
        for j in range(2):
            for k in range(2):
                v = t21[k][j]
                oct_[(0, j, k)], oct_[(1, j, k)] = fb.dfilt2_axis(
                    v, (h0b, h0a), (h1b, h1a), -3)
        lll = oct_[(0, 0, 0)]
        hp = self._pack_octants([oct_[o] for o in _OCTANTS], planes,
                                dtype=sdt)
        return lll.astype(sdt), hp

    # ------------------------------------------------------------------
    # inverse
    # ------------------------------------------------------------------
    def inverse(self, pyramid: Pyramid):
        """Inverse transform of a :class:`Pyramid` or 3-D
        :class:`PlanePyramid`.  A ``None`` first highpass entry (from
        ``discard_level_1``) is treated as zero."""
        pyramid = pyramid_to_device(pyramid)
        return self._inv(pyramid)

    def _inverse_body(self, pyramid: Pyramid):
        b = self.biort
        g0o, g1o = b[1], b[3]
        q = self.qshift
        g0a, g0b, g1a, g1b = q[2], q[3], q[6], q[7]

        if isinstance(pyramid, PlanePyramid):
            Yb = tuple(zip(pyramid.highpasses_re, pyramid.highpasses_im))
            has = lambda lvl: Yb[lvl][0] is not None
            spatial = lambda lvl: Yb[lvl][0].shape[-3:]
            oct_at = lambda lvl: self._octants_planes(*Yb[lvl])
            nlevels = len(Yb)
        else:
            Yh = pyramid.highpasses
            has = lambda lvl: Yh[lvl] is not None
            spatial = lambda lvl: Yh[lvl].shape[-4:-1]
            oct_at = lambda lvl: self._octants(Yh[lvl])
            nlevels = len(Yh)
        Yl = jnp.asarray(pyramid.lowpass)

        for level in range(nlevels - 1, 0, -1):
            if has(level - 1):
                prev_shape = spatial(level - 1)
            else:
                prev_shape = tuple(2 * s for s in spatial(level))
            Yl = self._level2_inv(Yl, oct_at(level), spatial(level),
                                  g0a, g0b, g1a, g1b, prev_shape)
        if nlevels >= 1:
            if not has(0):
                Yl = self._level1_inv_lowpass_only(Yl, g0o)
            else:
                Yl = self._level1_inv(Yl, oct_at(0), g0o, g1o)
        return Yl

    @staticmethod
    def _octants(Yh):
        """Split a 28-band level into the 7 real octet volumes."""
        out = {}
        for n, o in enumerate(_OCTANTS):
            out[o] = c2cube(Yh[..., 4 * n:4 * n + 4])
        return out

    @staticmethod
    def _octants_planes(re, im):
        """Octet volumes from band-major plane-layout re/im arrays
        (``[..., 28, P, Q, R]``) — no complex ops.  bf16 planes are
        storage: the corner combinations (three chained additions each)
        run at f32 like every other arithmetic stage."""
        re, im = _comp(re), _comp(im)
        out = {}
        for n, o in enumerate(_OCTANTS):
            out[o] = c2cube_planes(re[..., 4 * n:4 * n + 4, :, :, :],
                                   im[..., 4 * n:4 * n + 4, :, :, :])
        return out

    @staticmethod
    def _synth(oct_, merge):
        """Separable synthesis in the reference pass order (-2, -3, -1)
        (transform3d.py:425-435, :485-495).  *merge(a, b, ax)* fuses one
        stage's branch pair (lowpass-synth of *a* + highpass-synth of *b*)
        in a single pass (fb dual-stream sum primitives)."""
        U = {}
        for i in range(2):
            for k in range(2):
                U[(i, k)] = merge(oct_[(i, 0, k)], oct_[(i, 1, k)], -2)
        V = {}
        for k in range(2):
            V[k] = merge(U[(0, k)], U[(1, k)], -3)
        return merge(V[0], V[1], -1)

    def _level2_inv(self, Yl, oct_, curr, g0a, g0b, g1a, g1b, prev_shape):
        sdt = Yl.dtype
        # bf16 is storage: the synthesis stages run at f32, as
        # _octants_planes already promoted the octants.
        Yl = _comp(Yl)
        oct_ = {k: _comp(v) for k, v in oct_.items()}
        oct_[(0, 0, 0)] = Yl

        def merge(a, b, ax):
            return fb.ifilt2_sum_axis(a, b, (g0b, g0a), (g1b, g1a), ax)

        out = self._synth(oct_, merge)

        crop = 1 if self.ext_mode == 4 else 2
        for d, ax in enumerate((-3, -2, -1)):
            if 2 * curr[d] != prev_shape[d]:
                out = _crop(out, ax, crop)
        return out.astype(sdt)

    @staticmethod
    def _level1_inv(Yl, oct_, g0o, g1o):
        sdt = Yl.dtype
        even = g0o.size % 2 == 0
        if even:
            # drop the lowpass's extra trailing sample per dim (reference
            # x-ranges, transform3d.py:408-413)
            for ax in (-3, -2, -1):
                Yl = jax.lax.slice_in_dim(Yl, 0, Yl.shape[ax] - 1, axis=ax)
        Yl = _comp(Yl)
        oct_ = {k: _comp(v) for k, v in oct_.items()}
        oct_[(0, 0, 0)] = Yl

        def merge(a, b, ax):
            return fb.filter2_sum_axis(a, b, g0o, g1o, ax)

        out = Transform3d._synth(oct_, merge)
        if even:
            for ax in (-3, -2, -1):
                out = jax.lax.slice_in_dim(out, 1, out.shape[ax], axis=ax)
        return out.astype(sdt)

    @staticmethod
    def _level1_inv_lowpass_only(Yl, g0o):
        # Reference order: dims 1, 0, 2 (transform3d.py:450-457).  Note the
        # reference has a missing transpose in its third pass (:456 assigns
        # a [dim2, dim0] result into a [dim0, dim2] slot, silently
        # transposing each slice on cube-shaped volumes); we implement the
        # mathematically correct separable synthesis — its own behavioral
        # gate (median recon error < 1e-3, test_xfm3.py:152-159) passes
        # either way.
        out = fb.filter_axis(_comp(Yl), g0o, -2)
        out = fb.filter_axis(out, g0o, -3)
        out = fb.filter_axis(out, g0o, -1)
        return out.astype(Yl.dtype)
