"""Lane-folded 1-D path == flat path, bit-for-bit (f64).

A single long signal is one column of an [N, 1] array;
``transform1d`` folds it into segments-as-lanes with neighbour-segment halos
(the single-chip analogue of the sharded signal-axis path).  The fold is a
pure re-layout: results must match the flat transform exactly.
"""

import numpy as np
import pytest

import dtcwt_tpu as dt
from dtcwt_tpu.transforms import transform1d as t1m


def _with_min_n(monkeypatch, n):
    monkeypatch.setattr(t1m, "_FOLD_MIN_N", n)


CASES = [
    ("near_sym_a", "qshift_a", 4096, 1, 6),
    ("near_sym_b", "qshift_b", 4096, 1, 6),
    ("near_sym_a", "qshift_a", 8192, 2, 8),
    ("near_sym_b", "qshift_b", 6144, 1, 5),   # non-power-of-two length
    ("near_sym_a", "qshift_a", 4096, 1, 1),   # level-1-only fold
    ("near_sym_b", "qshift_b", 4096, 3, 3),   # multi-column signals
    # Regression: 16-tap qshift_c makes the deepest folded level's segment
    # length r EQUAL the halo; the reflected edge must not use a negative-
    # step slice whose stop wraps to -1 (empty slice, trace-time TypeError).
    ("near_sym_a", "qshift_c", 16384, 1, 3),
]


@pytest.mark.parametrize("biort,qshift,N,C,nl", CASES)
def test_folded_matches_flat(monkeypatch, biort, qshift, N, C, nl):
    x = np.random.RandomState(7).rand(N, C)

    _with_min_n(monkeypatch, 1 << 60)         # force the flat path
    t_flat = dt.Transform1d(biort, qshift)
    p_flat = t_flat.forward(x, nl, include_scale=True)
    r_flat = np.asarray(t_flat.inverse(p_flat)).ravel()

    _with_min_n(monkeypatch, 1024)            # force folding
    t_fold = dt.Transform1d(biort, qshift)
    assert t1m._fold_plan(N, C, nl,
                          max(v.size // 2 for v in t_fold.biort),
                          max(v.size for v in t_fold.qshift)) is not None
    p_fold = t_fold.forward(x, nl, include_scale=True)
    r_fold = np.asarray(t_fold.inverse(p_fold)).ravel()

    for a, b in zip(p_flat.highpasses, p_fold.highpasses):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    for a, b in zip(p_flat.scales, p_fold.scales):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    assert np.abs(np.asarray(p_flat.lowpass)
                  - np.asarray(p_fold.lowpass)).max() < 1e-12
    assert np.abs(r_flat - r_fold).max() < 1e-12
    assert np.abs(r_fold - x.ravel()).max() < 1e-10   # perfect reconstruction


def test_folded_gain_mask(monkeypatch):
    """Subband selection (gain_mask) through the folded inverse."""
    x = np.random.RandomState(3).rand(4096, 1)
    gm = np.array([1.0, 0.0, 1.0, 0.0])

    _with_min_n(monkeypatch, 1 << 60)
    t_flat = dt.Transform1d()
    want = np.asarray(t_flat.inverse(t_flat.forward(x, 4), gm)).ravel()

    _with_min_n(monkeypatch, 1024)
    t_fold = dt.Transform1d()
    got = np.asarray(t_fold.inverse(t_fold.forward(x, 4), gm)).ravel()
    assert np.abs(want - got).max() < 1e-12


def test_fold_plan_rejects_short_and_wide():
    assert t1m._fold_plan(512, 1, 3, 9, 18) is None      # short signal
    assert t1m._fold_plan(1 << 20, 64, 3, 9, 18) is None  # many columns
