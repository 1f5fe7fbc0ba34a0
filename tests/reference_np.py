"""Plain NumPy float64 reference of the DTCWT and the algorithms built on it.

Written from the published definitions of the dual-tree complex wavelet
transform (Kingsbury's filter-bank formulation, as laid out in SURVEY.md
sections 2-3 for the upstream ``dtcwt`` library) and kept deliberately
naive: every filter is a direct convolution over a symmetric-extension index
vector, every transform loops over levels with explicit axis moves, and the
samplers and the registration solver loop over stencil taps and subbands.
Nothing here imports ``dtcwt_tpu`` beyond the coefficient tables in
``dtcwt_tpu/data/*.npz``, so the tests compare the library against an
independent formulation of the same semantics.

Conventions follow the upstream library: 1-D signals are columns; a 2-D
pyramid level is ``[H', W', 6]`` complex; a 3-D level is ``[D', H', W', 28]``.
"""

from __future__ import annotations

import os
from collections import namedtuple

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "dtcwt_tpu",
                        "data")

Pyramid = namedtuple("Pyramid", ("lowpass", "highpasses", "scales"))

_BIORT_KEYS = ("h0o", "g0o", "h1o", "g1o", "h2o", "g2o")
_QSHIFT_KEYS = ("h0a", "h0b", "g0a", "g0b", "h1a", "h1b", "g1a", "g1b",
                "h2a", "h2b", "g2a", "g2b")


def _load(name, keys):
    with np.load(os.path.join(DATA_DIR, name + ".npz")) as f:
        return tuple(np.asarray(f[k], np.float64).reshape(-1)
                     for k in keys if k in f.files)


def biort(name):
    """(h0o, g0o, h1o, g1o[, h2o, g2o]) as flat float64 vectors."""
    return _load(name, _BIORT_KEYS)


def qshift(name):
    """(h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b[, h2a, h2b, g2a, g2b])."""
    return _load(name, _QSHIFT_KEYS)


# ---------------------------------------------------------------------------
# boundary rule and column filters
# ---------------------------------------------------------------------------

def reflect(x, minx, maxx):
    """Fold *x* into [minx, maxx] by reflection at both ends."""
    x = np.asarray(x, dtype=np.float64)
    rng = maxx - minx
    mod = np.fmod(x - minx, 2 * rng)
    mod = np.where(mod < 0, mod + 2 * rng, mod)
    return np.where(mod >= rng, 2 * rng - mod, mod) + minx


def _ext_index(r, n):
    """Indices of ``[-n, r + n)`` folded with repeated end samples."""
    return reflect(np.arange(-n, r + n), -0.5, r - 0.5).astype(np.int64)


def _conv_valid(X, h):
    """'valid' convolution of the columns of X with h."""
    m = h.size
    n = X.shape[0] - m + 1
    out = np.zeros((n,) + X.shape[1:], dtype=np.result_type(X, h))
    for k in range(m):
        out += h[k] * X[m - 1 - k:m - 1 - k + n]
    return out


def colfilter(X, h):
    """Filter the columns of X with h, symmetric extension, no decimation."""
    X = np.asarray(X, np.float64)
    h = np.asarray(h, np.float64).reshape(-1)
    m2 = h.size // 2
    return _conv_valid(X[_ext_index(X.shape[0], m2)], h)


def coldfilt(X, ha, hb):
    """Decimate-by-2 dual-tree column filter (rows a multiple of 4)."""
    X = np.asarray(X, np.float64)
    ha = np.asarray(ha, np.float64).reshape(-1)
    hb = np.asarray(hb, np.float64).reshape(-1)
    r = X.shape[0]
    if r % 4:
        raise ValueError("No. of rows in X must be a multiple of 4")
    if ha.shape != hb.shape or ha.size % 2:
        raise ValueError("ha and hb must share one even length")
    m = ha.size
    xe = _ext_index(r, m)
    hao, hae = ha[0::2], ha[1::2]
    hbo, hbe = hb[0::2], hb[1::2]
    t = np.arange(5, r + 2 * m - 2, 4)
    r2 = r // 2
    Y = np.zeros((r2,) + X.shape[1:])
    s1, s2 = ((slice(0, r2, 2), slice(1, r2, 2)) if np.sum(ha * hb) > 0
              else (slice(1, r2, 2), slice(0, r2, 2)))
    Y[s1] = _conv_valid(X[xe[t - 1]], hao) + _conv_valid(X[xe[t - 3]], hae)
    Y[s2] = _conv_valid(X[xe[t]], hbo) + _conv_valid(X[xe[t - 2]], hbe)
    return Y


def colifilt(X, ha, hb):
    """Interpolate-by-2 dual-tree column filter (rows a multiple of 2)."""
    X = np.asarray(X, np.float64)
    ha = np.asarray(ha, np.float64).reshape(-1)
    hb = np.asarray(hb, np.float64).reshape(-1)
    r = X.shape[0]
    if r % 2:
        raise ValueError("No. of rows in X must be a multiple of 2")
    if ha.shape != hb.shape or ha.size % 2:
        raise ValueError("ha and hb must share one even length")
    m = ha.size
    m2 = m // 2
    Y = np.zeros((2 * r,) + X.shape[1:])
    xe = _ext_index(r, m2)
    hao, hae = ha[0::2], ha[1::2]
    hbo, hbe = hb[0::2], hb[1::2]
    s = np.arange(0, 2 * r, 4)
    if m2 % 2 == 0:
        t = np.arange(3, r + m, 2)
        ta, tb = (t, t - 1) if np.sum(ha * hb) > 0 else (t - 1, t)
        Y[s] = _conv_valid(X[xe[tb - 2]], hae)
        Y[s + 1] = _conv_valid(X[xe[ta - 2]], hbe)
        Y[s + 2] = _conv_valid(X[xe[tb]], hao)
        Y[s + 3] = _conv_valid(X[xe[ta]], hbo)
    else:
        t = np.arange(2, r + m - 1, 2)
        ta, tb = (t, t - 1) if np.sum(ha * hb) > 0 else (t - 1, t)
        Y[s] = _conv_valid(X[xe[tb]], hao)
        Y[s + 1] = _conv_valid(X[xe[ta]], hbo)
        Y[s + 2] = _conv_valid(X[xe[tb]], hae)
        Y[s + 3] = _conv_valid(X[xe[ta]], hbe)
    return Y


def _along(f, X, axis, *args):
    """Apply column filter *f* along *axis* of X."""
    return np.moveaxis(f(np.moveaxis(X, axis, 0), *args), 0, axis)


# ---------------------------------------------------------------------------
# subband packing
# ---------------------------------------------------------------------------

def q2c(y):
    """Quads -> the two complex subbands [..., 2] of a 2-D level."""
    a, b = y[0::2, 0::2], y[0::2, 1::2]
    c, d = y[1::2, 0::2], y[1::2, 1::2]
    p = (a + 1j * b) * np.sqrt(0.5)
    q = (d - 1j * c) * np.sqrt(0.5)
    return np.stack((p - q, p + q), axis=-1)


def c2q(w, gain=(1.0, 1.0)):
    """Inverse of :func:`q2c` with per-subband gains."""
    sc = np.sqrt(0.5) * np.asarray(gain, np.float64)
    P = w[..., 0] * sc[0] + w[..., 1] * sc[1]
    Q = w[..., 0] * sc[0] - w[..., 1] * sc[1]
    x = np.zeros((2 * w.shape[0], 2 * w.shape[1]))
    x[0::2, 0::2] = P.real
    x[0::2, 1::2] = P.imag
    x[1::2, 0::2] = Q.imag
    x[1::2, 1::2] = -Q.real
    return x


def cube2c(y):
    """Octets -> the four complex subbands [..., 4] of a 3-D octant
    (Chen & Kingsbury, IEEE TIP 21(1) 2012, eqs. 6-9)."""
    A, E = y[0::2, 0::2, 0::2], y[0::2, 0::2, 1::2]
    B, F = y[0::2, 1::2, 0::2], y[0::2, 1::2, 1::2]
    C, G = y[1::2, 0::2, 0::2], y[1::2, 0::2, 1::2]
    D, H = y[1::2, 1::2, 0::2], y[1::2, 1::2, 1::2]
    p = ((A - G - D - F) + 1j * (B - H + C + E)) * 0.5
    q = ((A - G + D + F) + 1j * (-B + H + C + E)) * 0.5
    r = ((A + G + D - F) + 1j * (B + H - C + E)) * 0.5
    s = ((A + G - D + F) + 1j * (-B - H - C + E)) * 0.5
    return np.stack((p, q, r, s), axis=-1)


def c2cube(z):
    """Inverse of :func:`cube2c` (an orthogonal map: its transpose)."""
    P, Q, R, S = (z[..., i] for i in range(4))
    y = np.zeros(tuple(2 * n for n in z.shape[:3]))
    y[0::2, 0::2, 0::2] = 0.5 * (P.real + Q.real + R.real + S.real)   # A
    y[0::2, 1::2, 0::2] = 0.5 * (P.imag - Q.imag + R.imag - S.imag)   # B
    y[1::2, 0::2, 0::2] = 0.5 * (P.imag + Q.imag - R.imag - S.imag)   # C
    y[1::2, 1::2, 0::2] = 0.5 * (-P.real + Q.real + R.real - S.real)  # D
    y[0::2, 0::2, 1::2] = 0.5 * (P.imag + Q.imag + R.imag + S.imag)   # E
    y[0::2, 1::2, 1::2] = 0.5 * (-P.real + Q.real - R.real + S.real)  # F
    y[1::2, 0::2, 1::2] = 0.5 * (-P.real - Q.real + R.real + S.real)  # G
    y[1::2, 1::2, 1::2] = 0.5 * (-P.imag + Q.imag + R.imag - S.imag)  # H
    return y


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

class Transform1d:
    """1-D DTCWT of a vector or of the columns of a matrix."""

    def __init__(self, biort="near_sym_a", qshift="qshift_a"):
        self.b = globals()["biort"](biort) if isinstance(biort, str) else biort
        self.q = (globals()["qshift"](qshift) if isinstance(qshift, str)
                  else qshift)

    def forward(self, X, nlevels=3, include_scale=False):
        h0o, _, h1o, _ = self.b[:4]
        h0a, h0b, _, _, h1a, h1b, _, _ = self.q[:8]
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[:, None]
        if X.shape[0] % 2:
            raise ValueError("Size of input X must be a multiple of 2")
        if nlevels == 0:
            return Pyramid(X, (), () if include_scale else None)
        Yh, Ys = [], []
        Hi, Lo = colfilter(X, h1o), colfilter(X, h0o)
        Yh.append(Hi[0::2] + 1j * Hi[1::2])
        Ys.append(Lo)
        for _ in range(1, nlevels):
            if Lo.shape[0] % 4:
                Lo = np.vstack((Lo[:1], Lo, Lo[-1:]))
            Hi, Lo = coldfilt(Lo, h1b, h1a), coldfilt(Lo, h0b, h0a)
            Yh.append(Hi[0::2] + 1j * Hi[1::2])
            Ys.append(Lo)
        return Pyramid(Lo, tuple(Yh), tuple(Ys) if include_scale else None)

    def inverse(self, pyramid, gain_mask=None):
        _, g0o, _, g1o = self.b[:4]
        _, _, g0a, g0b, _, _, g1a, g1b = self.q[:8]
        Yh = pyramid.highpasses
        n = len(Yh)
        gm = np.ones(n) if gain_mask is None else np.asarray(gain_mask)
        Lo = np.asarray(pyramid.lowpass, np.float64)
        if n == 0:
            return Lo

        def c2q1d(z):
            x = np.zeros((2 * z.shape[0],) + z.shape[1:])
            x[0::2], x[1::2] = z.real, z.imag
            return x

        for level in range(n - 1, 0, -1):
            Hi = c2q1d(Yh[level] * gm[level])
            Lo = colifilt(Lo, g0b, g0a) + colifilt(Hi, g1b, g1a)
            if Lo.shape[0] != 2 * Yh[level - 1].shape[0]:
                Lo = Lo[1:-1]
        Z = colfilter(Lo, g0o) + colfilter(c2q1d(Yh[0] * gm[0]), g1o)
        return Z[:, 0] if Z.shape[1] == 1 else Z


class Transform2d:
    """2-D DTCWT with six oriented subbands per level."""

    def __init__(self, biort="near_sym_a", qshift="qshift_a"):
        self.b = globals()["biort"](biort) if isinstance(biort, str) else biort
        self.q = (globals()["qshift"](qshift) if isinstance(qshift, str)
                  else qshift)

    def forward(self, X, nlevels=3, include_scale=False):
        b, q = self.b, self.q
        h0o, h1o = b[0], b[2]
        h0a, h0b, h1a, h1b = q[0], q[1], q[4], q[5]
        X = np.atleast_2d(np.asarray(X, np.float64))
        if X.shape[0] % 2:
            X = np.vstack((X, X[-1:]))
        if X.shape[1] % 2:
            X = np.hstack((X, X[:, -1:]))
        if nlevels == 0:
            return Pyramid(X, (), () if include_scale else None)

        def level(Lo, Hi, Ba, f, lo_args, hi_args, bp_args):
            LoLo = f(Lo, *lo_args).T
            yh = np.zeros((LoLo.shape[0] // 2, LoLo.shape[1] // 2, 6), complex)
            yh[:, :, [0, 5]] = q2c(f(Hi, *lo_args).T)
            yh[:, :, [2, 3]] = q2c(f(Lo, *hi_args).T)
            if Ba is not None:
                yh[:, :, [1, 4]] = q2c(f(Ba, *bp_args).T)
            else:
                yh[:, :, [1, 4]] = q2c(f(Hi, *hi_args).T)
            return LoLo, yh

        Yh, Ys = [], []
        Lo, Hi = colfilter(X, h0o).T, colfilter(X, h1o).T
        Ba = colfilter(X, b[4]).T if len(b) == 6 else None
        LoLo, yh = level(Lo, Hi, Ba, colfilter, (h0o,), (h1o,),
                         (b[4],) if len(b) == 6 else None)
        Yh.append(yh)
        Ys.append(LoLo)
        for _ in range(1, nlevels):
            if LoLo.shape[0] % 4:
                LoLo = np.vstack((LoLo[:1], LoLo, LoLo[-1:]))
            if LoLo.shape[1] % 4:
                LoLo = np.hstack((LoLo[:, :1], LoLo, LoLo[:, -1:]))
            Lo = coldfilt(LoLo, h0b, h0a).T
            Hi = coldfilt(LoLo, h1b, h1a).T
            Ba = coldfilt(LoLo, q[9], q[8]).T if len(q) == 12 else None
            LoLo, yh = level(Lo, Hi, Ba, coldfilt, (h0b, h0a), (h1b, h1a),
                             (q[9], q[8]) if len(q) == 12 else None)
            Yh.append(yh)
            Ys.append(LoLo)
        return Pyramid(LoLo, tuple(Yh), tuple(Ys) if include_scale else None)

    def inverse(self, pyramid, gain_mask=None):
        b, q = self.b, self.q
        g0o, g1o = b[1], b[3]
        g0a, g0b, g1a, g1b = q[2], q[3], q[6], q[7]
        Yh = pyramid.highpasses
        n = len(Yh)
        gm = np.ones((6, n)) if gain_mask is None else np.asarray(gain_mask)
        Z = np.asarray(pyramid.lowpass, np.float64)

        def quads(lvl):
            return tuple(c2q(Yh[lvl][:, :, list(p)], gm[list(p), lvl])
                         for p in ((0, 5), (2, 3), (1, 4)))

        for lvl in range(n - 1, 0, -1):
            lh, hl, hh = quads(lvl)
            y1 = colifilt(Z, g0b, g0a) + colifilt(lh, g1b, g1a)
            if len(q) == 12:
                g2a, g2b = q[10], q[11]
                y2 = colifilt(hl, g0b, g0a)
                y2bp = colifilt(hh, g2b, g2a)
                Z = (colifilt(y1.T, g0b, g0a) + colifilt(y2.T, g1b, g1a)
                     + colifilt(y2bp.T, g2b, g2a)).T
            else:
                y2 = colifilt(hl, g0b, g0a) + colifilt(hh, g1b, g1a)
                Z = (colifilt(y1.T, g0b, g0a) + colifilt(y2.T, g1b, g1a)).T
            S = 2 * np.array(Yh[lvl - 1].shape[:2])
            if Z.shape[0] != S[0]:
                Z = Z[1:-1]
            if Z.shape[1] != S[1]:
                Z = Z[:, 1:-1]
        if n >= 1:
            lh, hl, hh = quads(0)
            y1 = colfilter(Z, g0o) + colfilter(lh, g1o)
            if len(b) == 6:
                y2, y2bp = colfilter(hl, g0o), colfilter(hh, b[5])
                Z = (colfilter(y1.T, g0o) + colfilter(y2.T, g1o)
                     + colfilter(y2bp.T, b[5])).T
            else:
                y2 = colfilter(hl, g0o) + colfilter(hh, g1o)
                Z = (colfilter(y1.T, g0o) + colfilter(y2.T, g1o)).T
        return Z


#: octant (dim-0 half, dim-1 half, dim-2 half) of each group of four 3-D
#: subbands, in storage order: HLL, LHL, HHL, LLH, HLH, LHH, HHH
OCTANTS = ((0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1), (1, 0, 1),
           (1, 1, 1))


class Transform3d:
    """3-D DTCWT with 28 directional subbands per level (odd level-1
    filters; even ones keep one extra lowpass sample per axis)."""

    def __init__(self, biort="near_sym_a", qshift="qshift_a", ext_mode=4):
        self.b = globals()["biort"](biort) if isinstance(biort, str) else biort
        self.q = (globals()["qshift"](qshift) if isinstance(qshift, str)
                  else qshift)
        self.ext_mode = ext_mode

    @staticmethod
    def _tree(X, split):
        """Separable 2x2x2 analysis: *split(v, axis)* -> (lo, hi); axes in
        the order W, H, D.  Returns {(i, j, k): octant}."""
        oct_ = {(): X}
        for axis in (2, 1, 0):
            nxt = {}
            for key, v in oct_.items():
                lo, hi = split(v, axis)
                nxt[(0,) + key] = lo
                nxt[(1,) + key] = hi
            oct_ = nxt
        return oct_

    @staticmethod
    def _synth(oct_, merge):
        """Separable 2x2x2 synthesis in the order H, D, W."""
        for axis, pos in ((1, 1), (0, 0), (2, 2)):
            nxt = {}
            for key, v in oct_.items():
                if key[pos] == 0:
                    hi_key = key[:pos] + (1,) + key[pos + 1:]
                    nxt[key[:pos] + key[pos + 1:]] = merge(v, oct_[hi_key],
                                                          axis)
            oct_ = {}
            for key, v in nxt.items():   # re-insert the merged axis slot
                oct_[key[:pos] + (0,) + key[pos:]] = v
        return oct_[(0, 0, 0)]

    def forward(self, X, nlevels=3, include_scale=False):
        h0o, h1o = self.b[0], self.b[2]
        h0a, h0b, h1a, h1b = self.q[0], self.q[1], self.q[4], self.q[5]
        Yl = np.asarray(X, np.float64)
        Yh, Ys = [], []
        for level in range(nlevels):
            if level == 0:
                oct_ = self._tree(Yl, lambda v, ax: (
                    _along(colfilter, v, ax, h0o), _along(colfilter, v, ax,
                                                          h1o)))
                trim = (h0o.size % 2 == 0)
                hp = [oct_[o][:-1, :-1, :-1] if trim else oct_[o]
                      for o in OCTANTS]
            else:
                rep = 1 if self.ext_mode == 4 else 2
                for ax in range(3):
                    if Yl.shape[ax] % self.ext_mode:
                        first = np.take(Yl, [0] * rep, axis=ax)
                        last = np.take(Yl, [-1] * rep, axis=ax)
                        Yl = np.concatenate((first, Yl, last), axis=ax)
                oct_ = self._tree(Yl, lambda v, ax: (
                    _along(coldfilt, v, ax, h0b, h0a),
                    _along(coldfilt, v, ax, h1b, h1a)))
                hp = [oct_[o] for o in OCTANTS]
            Yl = oct_[(0, 0, 0)]
            Yh.append(np.concatenate([cube2c(v) for v in hp], axis=3))
            Ys.append(Yl)
        return Pyramid(Yl, tuple(Yh), tuple(Ys) if include_scale else None)

    def inverse(self, pyramid):
        g0o, g1o = self.b[1], self.b[3]
        g0a, g0b, g1a, g1b = self.q[2], self.q[3], self.q[6], self.q[7]
        Yh = pyramid.highpasses
        Yl = np.asarray(pyramid.lowpass, np.float64)
        crop = 1 if self.ext_mode == 4 else 2

        def octants(yh):
            return {o: c2cube(yh[..., 4 * n:4 * n + 4])
                    for n, o in enumerate(OCTANTS)}

        for level in range(len(Yh) - 1, 0, -1):
            oct_ = octants(Yh[level])
            oct_[(0, 0, 0)] = Yl
            Yl = self._synth(oct_, lambda a, b_, ax: (
                _along(colifilt, a, ax, g0b, g0a)
                + _along(colifilt, b_, ax, g1b, g1a)))
            curr = Yh[level].shape[:3]
            prev = Yh[level - 1].shape[:3]
            for ax in range(3):
                if 2 * curr[ax] != prev[ax]:
                    Yl = np.delete(Yl, list(range(crop)) + list(
                        range(Yl.shape[ax] - crop, Yl.shape[ax])), axis=ax)
        if Yh:
            even = g0o.size % 2 == 0
            if even:
                Yl = Yl[:-1, :-1, :-1]
            oct_ = octants(Yh[0])
            oct_[(0, 0, 0)] = Yl
            Yl = self._synth(oct_, lambda a, b_, ax: (
                _along(colfilter, a, ax, g0o)
                + _along(colfilter, b_, ax, g1o)))
            if even:
                Yl = Yl[1:, 1:, 1:]
        return Yl


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_W0, _W1 = -3 * np.pi / 2.15, -np.pi / 2.15
DTHETA_DX_2D = np.array((_W1, _W0, _W0, _W0, _W0, _W1))
DTHETA_DY_2D = np.array((_W0, _W0, _W1, -_W1, -_W0, -_W0))


def _sample_clipped(im, xs, ys):
    sx = reflect(xs, -0.5, im.shape[1] - 0.5).astype(np.int64)
    sy = reflect(ys, -0.5, im.shape[0] - 0.5).astype(np.int64)
    return im[sy, sx]


def _expand(w, im):
    return w.reshape(w.shape + (1,) * (im.ndim - 2))


def sample(im, xs, ys, method="lanczos"):
    """Sample *im* at centre-of-pixel coordinates (xs, ys)."""
    im = np.atleast_2d(np.asarray(im))
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    method = method or "lanczos"
    if method == "nearest":
        return _sample_clipped(im, np.round(xs), np.round(ys))
    fx, fy = np.floor(xs), np.floor(ys)
    ax, ay = xs - fx, ys - fy
    if method == "bilinear":
        lo = (_expand(1 - ax, im) * _sample_clipped(im, fx, fy)
              + _expand(ax, im) * _sample_clipped(im, fx + 1, fy))
        hi = (_expand(1 - ax, im) * _sample_clipped(im, fx, fy + 1)
              + _expand(ax, im) * _sample_clipped(im, fx + 1, fy + 1))
        return (_expand(1 - ay, im) * lo + _expand(ay, im) * hi).astype(
            im.dtype)
    if method != "lanczos":
        raise NotImplementedError(method)
    a = 3

    def lanczos(x):
        x = np.asarray(x, np.float64)
        safe = np.where(x == 0, 1.0, x)
        v = a * np.sin(np.pi * safe) * np.sin(np.pi * safe / a) / (
            np.pi ** 2 * safe ** 2)
        return np.where(x == 0, 1.0, np.where(np.abs(x) < a, v, 0.0))

    out = 0.0
    for dx in range(-a + 1, a + 1):
        for dy in range(-a + 1, a + 1):
            w = lanczos(ax - dx) * lanczos(ay - dy)
            out = out + _expand(w, im) * _sample_clipped(im, fx + dx, fy + dy)
    return out


def _rescale_grid(src_shape, dst_shape):
    dxs, dys = np.meshgrid(np.arange(dst_shape[1]), np.arange(dst_shape[0]))
    sxs = (src_shape[1] / dst_shape[1]) * (dxs + 0.5) - 0.5
    sys = (src_shape[0] / dst_shape[0]) * (dys + 0.5) - 0.5
    return sxs, sys


def rescale(im, shape, method="lanczos"):
    """Resample *im* so that its half-pixel-inclusive extent maps to
    *shape*."""
    im = np.atleast_2d(np.asarray(im))
    sxs, sys = _rescale_grid(im.shape, shape)
    return sample(im, sxs, sys, method)


def _phase_image(xs, ys, unwrap, sbs):
    sign = -1.0 if unwrap else 1.0
    return np.stack([np.exp(sign * 1j * (DTHETA_DX_2D[s] * xs
                                         + DTHETA_DY_2D[s] * ys))
                     for s in sbs], axis=-1)


def sample_highpass(im, xs, ys, method="lanczos", sbs=None):
    """:func:`sample` for [H, W, 6] subbands with phase unwrap/re-wrap."""
    sbs = list(range(6)) if sbs is None else list(sbs)
    im = np.asarray(im)
    X, Y = np.meshgrid(np.arange(im.shape[1]), np.arange(im.shape[0]))
    unwrapped = im[:, :, sbs] * _phase_image(X, Y, True, sbs)
    return (_phase_image(np.asarray(xs), np.asarray(ys), False, sbs)
            * sample(unwrapped, xs, ys, method))


def rescale_highpass(im, shape, method="lanczos", sbs=None):
    """:func:`rescale` for [H, W, 6] subbands with phase unwrap/re-wrap."""
    sxs, sys = _rescale_grid(np.shape(im), shape)
    return sample_highpass(im, sxs, sys, method, sbs)


def _upsample_columns(X, method):
    M = X.shape[1]
    if method == "lanczos":
        a = 3.0
        offs = np.arange(-a, a + 1)
        las = np.sinc(-0.25 - offs) * np.sinc((-0.25 - offs) / a)
        lbs = np.sinc(0.25 - offs) * np.sinc((0.25 - offs) / a)
    elif method == "nearest":
        offs, las, lbs = [0], [1.0], [1.0]
    else:
        offs, las, lbs = [-1, 0, 1], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]
    A = np.zeros_like(X)
    B = np.zeros_like(X)
    for d, la, lb in zip(offs, las, lbs):
        cols = reflect(np.arange(M) + d, -0.5, M - 0.5).astype(np.int64)
        A = A + X[:, cols] * la
        B = B + X[:, cols] * lb
    Y = np.zeros((X.shape[0], 2 * M) + X.shape[2:], dtype=X.dtype)
    Y[:, 0::2], Y[:, 1::2] = A, B
    return Y


def upsample(im, method="lanczos"):
    """Double both image dimensions."""
    im = np.atleast_2d(np.asarray(im))
    method = method or "lanczos"
    up_rows = np.swapaxes(_upsample_columns(np.swapaxes(im, 0, 1), method),
                          0, 1)
    return _upsample_columns(up_rows, method)


def upsample_highpass(im, method="lanczos"):
    """:func:`upsample` for [H, W, 6] subbands with phase unwrap/re-wrap."""
    im = np.asarray(im)
    dxs, dys = np.meshgrid(np.arange(2 * im.shape[1]),
                           np.arange(2 * im.shape[0]))
    X, Y = np.meshgrid(np.arange(im.shape[1]), np.arange(im.shape[0]))
    up = upsample(im * _phase_image(X, Y, True, range(6)), method)
    return up * _phase_image(0.5 * (dxs + 0.5) - 0.5, 0.5 * (dys + 0.5) - 0.5,
                             False, range(6))


# ---------------------------------------------------------------------------
# registration (locally affine phase-based estimator)
# ---------------------------------------------------------------------------

EXPECTED_SHIFTS = np.array(
    ((-1, -3), (-3, -3), (-3, -1), (-3, 1), (-3, 3), (-1, 3))) * np.pi / 2.15


def phasegradient(sb1, sb2, w=(0.0, 0.0)):
    """(dy, dx, dt) phase gradients of a subband pair."""
    S = (sb1[:, 1:] * np.conj(sb1[:, :-1])
         + sb2[:, 1:] * np.conj(sb2[:, :-1])) * np.exp(-1j * w[0])
    dx = np.angle(np.hstack((S[:, :1], S[:, :-1] + S[:, 1:], S[:, -1:]))) + w[0]
    S = (sb1[1:] * np.conj(sb1[:-1])
         + sb2[1:] * np.conj(sb2[:-1])) * np.exp(-1j * w[1])
    dy = np.angle(np.vstack((S[:1], S[:-1] + S[1:], S[-1:]))) + w[1]
    return dy, dx, np.angle(sb2 * np.conj(sb1))


def confidence(sb1, sb2, epsilon=1e-6):
    """|sum of the four diagonal conjugate products|^2 over the sum of the
    cubed magnitudes (edge-replicated borders)."""
    us = np.pad(sb1, 1, mode="edge")
    vs = np.pad(sb2, 1, mode="edge")
    h, w = sb1.shape
    num = np.zeros((h, w), complex)
    den = np.full((h, w), epsilon)
    for dy in (0, 2):
        for dx in (0, 2):
            u, v = us[dy:dy + h, dx:dx + w], vs[dy:dy + h, dx:dx + w]
            num += np.conj(u) * v
            den += np.abs(u) ** 3 + np.abs(v) ** 3
    return np.abs(num) ** 2 / den


def qtildematrices(p1, p2, levels):
    """Per-pixel packed (21 upper-triangle Q, 6 q) 27-vectors per level."""
    out = []
    for level in levels:
        h1, h2 = p1.highpasses[level], p2.highpasses[level]
        h, w = h1.shape[:2]
        xs, ys = np.meshgrid(np.arange(0, 1, 1 / w), np.arange(0, 1, 1 / h))
        Qt = np.zeros((h, w, 27))
        for sb in range(h1.shape[2]):
            C = confidence(h1[:, :, sb], h2[:, :, sb])
            dy, dx, dt = phasegradient(h1[:, :, sb], h2[:, :, sb],
                                       EXPECTED_SHIFTS[sb])
            dx, dy = dx * w, dy * h
            t = (dx, dy, xs * dx, xs * dy, ys * dx, ys * dy, -dt)
            k = 0
            for i in range(6):
                for j in range(i, 6):
                    Qt[:, :, k] += C ** 2 * t[i] * t[j]
                    k += 1
            for i in range(6):
                Qt[:, :, 21 + i] += C ** 2 * t[i] * t[6]
        out.append(Qt)
    return out


def solvetransform(Qtilde):
    """a = -Q^{-1} q with only the upper triangle of Q populated."""
    Qtilde = np.asarray(Qtilde)
    lead = Qtilde.shape[:-1]
    flat = Qtilde.reshape(-1, 27)
    out = np.zeros((flat.shape[0], 6))
    iu = np.triu_indices(6)
    for n, v in enumerate(flat):
        Q = np.zeros((6, 6))
        Q[iu] = v[:21]
        out[n] = np.linalg.solve(Q, -v[21:])
    return out.reshape(lead + (6,))


def boxfilter(X, k):
    """Separable k x k mean over the first two axes, reflect boundary."""
    for axis in range(2):
        n = X.shape[axis]
        out = X.copy()
        for d in range(1, (k - 1) // 2 + 1):
            for s in (1, -1):
                idx = reflect(np.arange(n) + s * d, -0.5, n - 0.5).astype(int)
                out = out + np.take(X, idx, axis=axis)
        X = out / k
    return X


def velocityfield(avecs, shape, method=None):
    h, w = avecs.shape[:2]
    pxs, pys = np.meshgrid(np.arange(w, dtype=np.float32) / w,
                           np.arange(h, dtype=np.float32) / h)
    vxs = avecs[:, :, 0] + avecs[:, :, 2] * pxs + avecs[:, :, 4] * pys
    vys = avecs[:, :, 1] + avecs[:, :, 3] * pxs + avecs[:, :, 5] * pys
    return rescale(vxs, shape, method), rescale(vys, shape, method)


def _unit_grid(shape):
    return np.meshgrid(np.arange(shape[1], dtype=np.float32) / shape[1],
                       np.arange(shape[0], dtype=np.float32) / shape[0])


def warp(I, avecs, method=None):
    X, Y = _unit_grid(I.shape)
    vxs, vys = velocityfield(avecs, I.shape, method)
    return sample(I, (X + vxs) * I.shape[1], (Y + vys) * I.shape[0], method)


def warphighpass(Yh, avecs, method=None):
    X, Y = _unit_grid(Yh.shape)
    vxs, vys = velocityfield(avecs, Yh.shape, method)
    return sample_highpass(Yh, (X + vxs) * Yh.shape[1],
                           (Y + vys) * Yh.shape[0], method)


def estimatereg(source, reference, regshape=None, levels=None):
    """NxMx6 locally-affine registration of *source* onto *reference*."""
    n = len(source.highpasses)
    shape = (tuple(source.highpasses[3].shape[:2]) if regshape is None
             else tuple(regshape[:2]))
    if levels is None:
        levels = [[x for x in range(n - 1, n - 3, -1) if x >= 0]]
        for s in np.arange(n - 1, 0, -0.5):
            refine = [int(np.floor(s)) - x for x in range(2) if s - x >= 2]
            if len(refine) == 2:
                levels.append(refine)
    Qt = sum(x.sum(axis=(0, 1))
             for x in qtildematrices(source, reference, levels[0]))
    avecs = np.zeros(shape + (6,)) + solvetransform(Qt)
    for est in levels[1:]:
        hps = list(source.highpasses)
        for lvl in est:
            hps[lvl] = warphighpass(hps[lvl], avecs, "bilinear")
        warped = Pyramid(source.lowpass, tuple(hps), None)
        qts = sum(rescale(boxfilter(x, 3), shape, "bilinear")
                  for x in qtildematrices(warped, reference, est))
        avecs = avecs + solvetransform(qts)
    return avecs


# ---------------------------------------------------------------------------
# keypoints
# ---------------------------------------------------------------------------

def _energy_maxima(X, threshold=None, refine=True):
    """(x, y, value) of 3x3 local maxima over rows/cols 1..n-3, refined by a
    quadratic fit whose stationary point is the SVD nullspace of its
    gradient system."""
    thr = X.min() - 1 if threshold is None else threshold
    h, w = X.shape
    M = np.full_like(X, thr)
    for y in range(1, h - 2):
        for x in range(1, w - 2):
            M[y, x] = max(thr, X[y - 1:y + 2, x - 1:x + 2].max())
    cands = np.argwhere(M == X)
    if not refine:
        return [(x, y, X[y, x]) for y, x in cands]
    dXdy, dXdx = np.gradient(X)
    d2xy, d2xx = np.gradient(dXdx)
    d2yy, _ = np.gradient(dXdy)
    out = []
    for y, x in cands:
        a0, a1, a2 = d2xx[y, x], d2yy[y, x], d2xy[y, x]
        a3, a4, a5 = dXdx[y, x], dXdy[y, x], X[y, x]
        A = np.array([[2 * a0, a2, a3], [a2, 2 * a1, a4]])
        _, s, vt = np.linalg.svd(A)
        if (s >= 1e-13).sum() != 2:      # need a one-dimensional nullspace
            continue
        v = vt[-1]
        if v[2] == 0:
            continue
        xo, yo = v[0] / v[2], v[1] / v[2]
        if abs(xo) > 0.5 or abs(yo) > 0.5:
            continue
        val = a0 * xo * xo + a1 * yo * yo + a2 * xo * yo + a3 * xo + a4 * yo + a5
        out.append((x + xo, y + yo, val))
    return out


def find_keypoints(highpasses, method="fauqueur", alpha=1.0, beta=0.4,
                   kappa=1.0 / 6.0, threshold=None, max_points=None,
                   refine_positions=True, skip_levels=1):
    """(P, 4) rows (x, y, scale, energy) sorted by decreasing energy."""
    rows = []
    for scale, sb in enumerate(highpasses[skip_levels:]):
        mag = np.abs(np.asarray(sb))
        if method == "fauqueur":
            e = alpha ** (scale + 1) * np.maximum(0, np.prod(mag, axis=2)) ** beta
        elif method == "bendale":
            e = mag.min(axis=2)
        else:
            A = np.sqrt((mag * mag).sum(axis=2))
            B = (mag[:, :, :3] * mag[:, :, 3:]).sum(axis=2)
            e = np.maximum(0, B / np.maximum(1e-8, A) - kappa * A)
        ks = 2 ** (scale + 1 + skip_levels)
        for x, y, v in _energy_maxima(e, threshold, refine_positions):
            rows.append(((x + 0.5) * ks - 0.5, (y + 0.5) * ks - 0.5, ks, v))
    kps = np.array(rows, np.float64).reshape(-1, 4)
    kps = kps[np.argsort(kps[:, 3])[::-1]]
    return kps if max_points is None else kps[:max_points]


# ---------------------------------------------------------------------------
# synthetic test images
# ---------------------------------------------------------------------------

def drawedge(theta, r, w, N):
    """N x N soft step edge at *theta* degrees through point *r*, with a
    raised-cosine profile *w* pixels wide."""
    thetar = theta * np.pi / 180
    centre = (np.array([N, N]) - 1) / 2 + 1
    r = -np.array([np.cos(thetar), np.sin(thetar)]) * (np.asarray(r) - centre)
    w = max(1, w)
    ramp = np.arange(N) - (N + 1) / 2
    hgrad = -np.sin(thetar) * np.ones((N, 1))
    vgrad = -np.cos(thetar) * np.ones((1, N))
    plane = ((hgrad * ramp) - r[0]) + ((ramp * vgrad).T - r[1])
    return 0.5 + 0.5 * np.sin(np.clip(plane * (np.pi / w), -np.pi / 2,
                                      np.pi / 2))


def drawcirc(r, w, du, dv, N):
    """N x N soft-edged disc of radius *r* offset (du, dv) from the centre,
    with a cosine edge *w* pixels wide."""
    w = max(w, 1)
    x = np.ones((N, 1)) * ((np.arange(N) - (N + 1) / 2 - dv) / r)
    y = (((np.arange(N) - (N + 1) / 2 - du) / r) * np.ones((N, 1))).T
    p = 0.5 + 0.5 * np.sin(np.clip((np.exp(-0.5 * (x ** 2 + y ** 2)).T
                                    - np.exp(-0.5)) * (r * 3 / w),
                                   -np.pi / 2, np.pi / 2))
    return p
