"""Batched/multi-channel layout adapter tests.

Parity surface: the reference TF backend's ``forward_channels`` /
``inverse_channels`` (upstream ``dtcwt/tf/transform2d.py:179-336,
422-588`` and ``tf/transform1d.py:150-215,293-371``) with the six data
formats nhw/chw/hwn/hwc/nchw/nhwc.  Since the core transform here is batched
over arbitrary leading axes, the adapters are pure layout permutations; the
tests assert (a) every format agrees with the plain batched forward and
(b) the round-trip reconstructs the input.
"""

import numpy as np
import pytest

import dtcwt_tpu as dt

RNG = np.random.RandomState(42)
IMG = RNG.rand(4, 3, 32, 48)   # n, c, h, w


def _as_format(fmt):
    """Return (array, to_nhw) for the given data format."""
    x = IMG
    if fmt in ("nhw", "chw"):
        return x[0], x[0]
    if fmt in ("hwn", "hwc"):
        return np.transpose(x[0], (1, 2, 0)), x[0]
    if fmt == "nchw":
        return x, x.reshape(-1, 32, 48)
    if fmt == "nhwc":
        return np.transpose(x, (0, 2, 3, 1)), x.reshape(-1, 32, 48)
    raise AssertionError(fmt)


@pytest.mark.parametrize("fmt", ["nhw", "chw", "hwn", "hwc", "nchw", "nhwc"])
def test_forward_channels_matches_plain(fmt):
    t = dt.Transform2d()
    arr, plain = _as_format(fmt)
    p = t.forward_channels(arr, fmt, nlevels=3, include_scale=True)
    pr = t.forward(plain, nlevels=3, include_scale=True)

    def flat_nhw(a, hp=False):
        """Bring the format's output layout back to [batch..., h, w(, 6)]."""
        a = np.asarray(a)
        if fmt in ("nhw", "chw"):
            return a[None] if a.ndim < (4 if hp else 3) else a
        if fmt in ("hwn", "hwc"):
            return np.moveaxis(a, -2 if hp else -1, 0)
        if fmt == "nchw":
            return a.reshape((-1,) + a.shape[2:])
        # nhwc
        a = np.moveaxis(a, -2 if hp else -1, 1)
        return a.reshape((-1,) + a.shape[2:])

    ref_low = np.asarray(pr.lowpass).reshape((-1,) + pr.lowpass.shape[-2:])
    got_low = flat_nhw(p.lowpass).reshape(ref_low.shape)
    assert np.abs(got_low - ref_low).max() < 1e-12
    for gh, rh in zip(p.highpasses, pr.highpasses):
        rh = np.asarray(rh).reshape((-1,) + rh.shape[-3:])
        gh = flat_nhw(gh, hp=True).reshape(rh.shape)
        assert np.abs(gh - rh).max() < 1e-12
    for gs, rs in zip(p.scales, pr.scales):
        rs = np.asarray(rs).reshape((-1,) + rs.shape[-2:])
        gs = flat_nhw(gs).reshape(rs.shape)
        assert np.abs(gs - rs).max() < 1e-12


@pytest.mark.parametrize("fmt", ["nhw", "hwc", "nchw", "nhwc"])
def test_channels_roundtrip(fmt):
    t = dt.Transform2d(biort="near_sym_b", qshift="qshift_b")
    arr, _ = _as_format(fmt)
    p = t.forward_channels(arr, fmt, nlevels=3)
    r = t.inverse_channels(p, fmt)
    assert np.asarray(r).shape == arr.shape
    assert np.abs(np.asarray(r) - arr).max() < 1e-12


def test_channels_gain_mask():
    t = dt.Transform2d()
    arr, _ = _as_format("nhwc")
    p = t.forward_channels(arr, "nhwc", nlevels=3)
    gm = np.zeros((6, 3))
    r = t.inverse_channels(p, "nhwc", gain_mask=gm)
    assert np.abs(np.asarray(r)).max() > 0   # lowpass-only reconstruction
    full = t.inverse_channels(p, "nhwc")
    assert np.abs(np.asarray(full) - arr).max() < 1e-12
    assert np.abs(np.asarray(r) - arr).max() > 1e-3   # gains did something


def test_bad_format_raises():
    t = dt.Transform2d()
    with pytest.raises(ValueError):
        t.forward_channels(IMG, "nwhc")
    with pytest.raises(ValueError):
        t.forward_channels(IMG[0], "nchw")   # 3-D input, 4-D format


def test_transform1d_channels():
    t = dt.Transform1d()
    x = RNG.rand(5, 64, 3)   # batch of matrices; transform the 2nd dim
    p = t.forward_channels(x, nlevels=3, include_scale=True)
    pr = t.forward(x, nlevels=3, include_scale=True)
    assert np.abs(np.asarray(p.lowpass) - np.asarray(pr.lowpass)).max() == 0
    r = t.inverse_channels(p)
    assert np.abs(np.asarray(r) - x).max() < 1e-12
    with pytest.raises(ValueError):
        t.forward_channels(x[0])   # 2-D input must use forward()
