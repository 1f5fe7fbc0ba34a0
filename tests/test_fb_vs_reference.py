"""Bit-level parity of the polyphase filter-bank primitives against the
plain NumPy reference (``tests/reference_np.py``), across every shipped
wavelet family (both m/2 parities, both signs of sum(ha*hb)), odd/even sizes
and edge cases, plus f32 parity of the axis-parameterised ops on batched
inputs, the minor axis and widths that are not powers of two."""

import numpy as np
import pytest

from dtcwt_tpu import coeffs
from dtcwt_tpu.ops import fb

from .oracle import ref as ref_ll

RNG = np.random.RandomState(42)
X64 = RNG.randn(64, 48)
X32 = RNG.randn(32, 32)

BIORTS = ["antonini", "legall", "near_sym_a", "near_sym_b"]
QSHIFTS = ["qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d"]


def _flat(v):
    return np.asarray(v, np.float64).reshape(-1)


@pytest.mark.parametrize("name", BIORTS)
@pytest.mark.parametrize("which", ["h0o", "g0o", "h1o", "g1o"])
def test_colfilter_matches(name, which):
    h0o, g0o, h1o, g1o = coeffs.biort(name)
    h = {"h0o": h0o, "g0o": g0o, "h1o": h1o, "g1o": g1o}[which]
    want = ref_ll.colfilter(X64.copy(), h)
    got = np.asarray(fb.colfilter(X64, h))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert got.shape == want.shape


@pytest.mark.parametrize("m", [2, 4, 5, 6, 7, 8, 9, 19])
def test_colfilter_sizes_and_even_taps(m):
    h = RNG.randn(m)
    want = ref_ll.colfilter(X64.copy(), h)
    got = np.asarray(fb.colfilter(X64, h))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_colfilter_filter_longer_than_signal():
    h = RNG.randn(19)
    x = RNG.randn(6, 4)
    want = ref_ll.colfilter(x.copy(), h)
    got = np.asarray(fb.colfilter(x, h))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("pair", [("h0b", "h0a"), ("h1b", "h1a"),
                                  ("g0b", "g0a"), ("g1b", "g1a")])
def test_coldfilt_matches(name, pair):
    tab = dict(zip(("h0a", "h0b", "g0a", "g0b", "h1a", "h1b", "g1a", "g1b"),
                   coeffs.qshift(name)))
    ha, hb = tab[pair[0]], tab[pair[1]]
    want = ref_ll.coldfilt(X64.copy(), ha, hb)
    got = np.asarray(fb.coldfilt(X64, ha, hb))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert got.shape == want.shape


@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("pair", [("h0b", "h0a"), ("h1b", "h1a"),
                                  ("g0b", "g0a"), ("g1b", "g1a")])
def test_colifilt_matches(name, pair):
    tab = dict(zip(("h0a", "h0b", "g0a", "g0b", "h1a", "h1b", "g1a", "g1b"),
                   coeffs.qshift(name)))
    ha, hb = tab[pair[0]], tab[pair[1]]
    for x in (X64, X32, RNG.randn(10, 6)):
        want = ref_ll.colifilt(x.copy(), ha, hb)
        got = np.asarray(fb.colifilt(x, ha, hb))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
        assert got.shape == want.shape


@pytest.mark.parametrize("m", [4, 6, 8, 10, 12, 14, 16, 18])
def test_dual_filters_random_taps(m):
    """Random even-length taps exercise both signs of sum(ha*hb) and both
    parities of m/2."""
    for sign in (+1.0, -1.0):
        ha = RNG.randn(m)
        hb = ha[::-1] * sign  # force the sum(ha*hb) sign
        if np.sum(ha * hb) * sign < 0:
            hb = -hb
        want_d = ref_ll.coldfilt(X64.copy(), ha, hb)
        got_d = np.asarray(fb.coldfilt(X64, ha, hb))
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-12)
        want_i = ref_ll.colifilt(X64.copy(), ha, hb)
        got_i = np.asarray(fb.colifilt(X64, ha, hb))
        np.testing.assert_allclose(got_i, want_i, rtol=0, atol=1e-12)


def test_coldfilt_contracts():
    ha = RNG.randn(8)
    with pytest.raises(ValueError):
        fb.coldfilt(RNG.randn(30, 4), ha, ha)      # rows not multiple of 4
    with pytest.raises(ValueError):
        fb.coldfilt(X64, RNG.randn(7), RNG.randn(7))  # odd-length filters
    with pytest.raises(ValueError):
        fb.coldfilt(X64, RNG.randn(8), RNG.randn(6))  # mismatched shapes


def test_colifilt_contracts():
    with pytest.raises(ValueError):
        fb.colifilt(RNG.randn(31, 4), RNG.randn(8), RNG.randn(8))
    with pytest.raises(ValueError):
        fb.colifilt(X64, RNG.randn(7), RNG.randn(7))


def test_row_variants_are_transposed_column_variants():
    h = coeffs.biort("near_sym_a")[0]
    np.testing.assert_allclose(
        np.asarray(fb.rowfilter(X64, h)),
        np.asarray(fb.colfilter(X64.T, h)).T, rtol=0, atol=1e-14)
    tab = coeffs.qshift("qshift_a")
    np.testing.assert_allclose(
        np.asarray(fb.rowdfilt(X64, tab[1], tab[0])),
        np.asarray(fb.coldfilt(X64.T, tab[1], tab[0])).T, rtol=0, atol=1e-14)


def test_batched_matches_loop():
    """Leading batch dims give the same answer as per-image calls."""
    h = coeffs.biort("near_sym_b")[2]
    xb = RNG.randn(3, 2, 24, 16)
    got = np.asarray(fb.filter_axis(xb, h, axis=-2))
    for i in range(3):
        for j in range(2):
            want = ref_ll.colfilter(xb[i, j].copy(), h)
            np.testing.assert_allclose(got[i, j], want, rtol=0, atol=1e-13)


def test_zero_input_gives_zero():
    tab = coeffs.qshift("qshift_b")
    z = np.zeros((16, 8))
    assert np.all(np.asarray(fb.colifilt(z, tab[4], tab[5])) == 0.0)
    assert np.all(np.asarray(fb.coldfilt(z, tab[4], tab[5])) == 0.0)


# ---------------------------------------------------------------------------
# f32 parity along any axis of batched arrays: the shapes the transforms
# feed the primitives (leading batch axes, the minor axis, widths that are
# not powers of two).  Tolerance: f32 rounding of <= 19-tap sums of O(1)
# values, against the f64 reference on the same f32-valued input.
# ---------------------------------------------------------------------------

TOL_F32 = 1e-4
H0O, _, H1O, _ = coeffs.biort("near_sym_a")
QA, QD = coeffs.qshift("qshift_a"), coeffs.qshift("qshift_d")


def _ref_along(f, x, axis, *taps):
    """Reference column filter *f* applied along *axis* of a batched x."""
    xm = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    y = f(xm.reshape(xm.shape[0], -1), *taps)
    return np.moveaxis(y.reshape((y.shape[0],) + xm.shape[1:]), 0, axis)


def _f32_err(got, want):
    got = np.asarray(got)
    assert got.dtype == np.float32
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96), (36, 128),
                                   (3, 2, 32, 32), (8, 130)])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("h", [H0O, H1O], ids=["h0o", "h1o"])
def test_filter_axis_f32_matches_reference(shape, axis, h):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = _ref_along(ref_ll.colfilter, x, axis, h)
    assert _f32_err(fb.filter_axis(x, h, axis), want) < TOL_F32


@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96), (16, 128)])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("fam", [QA, QD], ids=["qshift_a", "qshift_d"])
def test_dfilt_axis_f32_matches_reference(shape, axis, fam):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    for ha, hb in [(fam[1], fam[0]), (fam[5], fam[4])]:
        want = _ref_along(ref_ll.coldfilt, x, axis, ha, hb)
        assert _f32_err(fb.dfilt_axis(x, ha, hb, axis), want) < TOL_F32


@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96), (16, 128)])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("fam", [QA, QD], ids=["qshift_a", "qshift_d"])
def test_ifilt_axis_f32_matches_reference(shape, axis, fam):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    for ha, hb in [(fam[2], fam[3]), (fam[6], fam[7])]:
        want = _ref_along(ref_ll.colifilt, x, axis, ha, hb)
        assert _f32_err(fb.ifilt_axis(x, ha, hb, axis), want) < TOL_F32
