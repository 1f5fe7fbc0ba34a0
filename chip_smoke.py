#!/usr/bin/env python
"""Smoke test of the DTCWT on the GPU: the main path end to end, at the
sizes the repo benchmarks, each result checked against the plain NumPy f64
reference in ``tests/reference_np.py``.

Usage::

    python chip_smoke.py               # every single-card phase, one GPU
    python chip_smoke.py --four-cards  # only the sharded paths, 4 GPUs

Before any phase it prints the card's ``nvidia-smi`` name and power limit
and the JAX version.  Each phase prints one line: its name, the shape, the
largest absolute error and the largest error relative to the reference's
largest magnitude (worst over every array the phase compares), the
tolerance with its reason, and the wall times of the library calls (first
call, compilation included) and of the reference.  The last line of
standard output is one JSON object naming the device.

The script exits non-zero, and prints no JSON line, when JAX finds no GPU or
when any phase fails: there is no CPU fallback, and no phase catches an
error and carries on.  With ``--four-cards`` it runs only the multi-device
phases (row-sharded 2-D at 8192^2, depth-sharded 3-D at 512^3, row-sharded
registration), each compared with the same transform on one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Sizes the repo benchmarks (bench.py): the smoke test runs them as is.
FULL = dict(img=4096, levels=3, batch=(100, 512), vol=256, sig=1 << 22,
            sig_levels=8, reg=512, reg_levels=6, kp_levels=4,
            big_img=8192, big_vol=512)

# Tolerances, each with its reason.  Errors are relative to the largest
# magnitude of the reference array they are measured against.
TOL_F32 = (1e-5, "f32 rounding (2^-24 per op) accumulated over <=19-tap "
                 "sums and <=8 levels, against f64: ~20 ulp of the peak")
TOL_BF16 = (3e-2, "bf16 storage keeps 8 significant bits: every stored "
                  "coefficient, each level's lowpass (which the coarser "
                  "levels filter) and the output round to 2^-9 relative")
TOL_F64 = (1e-12, "f64 round-off; the reference gates perfect "
                  "reconstruction at 1e-12")
TOL_REG = (2e-3, "phase angles of f32 subbands feed a 6x6 solve per block "
                 "whose conditioning amplifies f32 rounding ~1e3x")
TOL_KP = (1e-3, "keypoint energies and quadratic-fit positions from f32 "
                "subbands, matched to the reference point by point")
TOL_SHARD = (1e-6, "the sharded program sums the same taps on halo-"
                   "extended shards; XLA may fuse and round in another "
                   "order")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _errors(pairs):
    """Worst (absolute, relative) error over ``(got, want)`` pairs; the
    relative error divides by the reference's largest magnitude."""
    worst_abs = worst_rel = 0.0
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            raise AssertionError("shape %s != reference %s"
                                 % (got.shape, want.shape))
        if not np.all(np.isfinite(got)):
            raise AssertionError("non-finite values in a %s result"
                                 % (got.shape,))
        err = float(np.max(np.abs(got.astype(np.complex128)
                                  - want.astype(np.complex128))))
        scale = float(np.max(np.abs(want))) or 1.0
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel


def _timed(fn, *args, **kw):
    """``fn(*args, **kw)`` blocked until ready; returns (out, seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def _phase(name, shape, tol, run):
    """Run one phase.  *run()* returns ``(pairs, wall_s, ref_s)``."""
    pairs, wall_s, ref_s = run()
    abs_err, rel_err = _errors(pairs)
    limit, reason = tol
    print("phase %-22s shape=%-22s max_abs=%.3e max_rel=%.3e tol=%.0e (%s) "
          "wall_s=%.2f ref_s=%.2f"
          % (name, "x".join(str(s) for s in shape), abs_err, rel_err, limit,
             reason, wall_s, ref_s), flush=True)
    if not rel_err <= limit:
        raise AssertionError("phase %s: relative error %.3e exceeds %.0e"
                             % (name, rel_err, limit))


def _pyr_pairs(p, rp, first=0):
    """(library, reference) pairs over a pyramid's lowpass and highpasses,
    read back with plain ``np.asarray`` (complex64 included)."""
    pairs = [(np.asarray(p.lowpass), rp.lowpass)]
    pairs += [(np.asarray(h), r) for h, r in
              zip(p.highpasses[first:], rp.highpasses[first:])]
    return pairs


def _plane_pairs(p, rp):
    """Pairs over a plane-layout pyramid: band plane k of level l against
    the reference subband ``PLANE_BAND_ORDER[k]``."""
    from dtcwt_tpu import PLANE_BAND_ORDER
    f32 = lambda a: np.asarray(a.astype("float32"))
    pairs = [(f32(p.lowpass), rp.lowpass)]
    for re, im, want in zip(p.highpasses_re, p.highpasses_im,
                            rp.highpasses):
        re, im = f32(re), f32(im)
        for k, d in enumerate(PLANE_BAND_ORDER):
            pairs.append((re[..., k, :, :], want[..., d].real))
            pairs.append((im[..., k, :, :], want[..., d].imag))
    return pairs


def smooth_pair(n, seed=3, sigma=0.02, shift=(3, 2)):
    """A smooth random n x n frame in [0, 1] and the same frame rolled by
    *shift* pixels: the structure phase-based registration locks onto."""
    spec = np.fft.rfft2(np.random.RandomState(seed).rand(n, n))
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * sigma ** 2)))
    f1 = np.fft.irfft2(spec, s=(n, n)).astype(np.float32)
    f1 = (f1 - f1.min()) / (f1.max() - f1.min())
    return f1, np.roll(f1, shift, axis=(0, 1))


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------

def run_single_card(sz):
    import jax
    import jax.numpy as jnp
    import dtcwt_tpu as dt
    from dtcwt_tpu import keypoint, registration
    from tests import reference_np as R

    rng = np.random.RandomState(0)
    n, nl = sz["img"], sz["levels"]
    t2, r2 = dt.Transform2d(), R.Transform2d()
    x32 = rng.rand(n, n).astype(np.float32)
    x = x32.astype(np.float64)
    t0 = time.perf_counter()
    rp = r2.forward(x, nl)
    ref2_s = time.perf_counter() - t0
    ctx = {}

    def rt2d():
        p, s1 = _timed(t2.forward, x32, nl)
        z, s2 = _timed(t2.inverse, p)
        ctx["p"] = p
        return _pyr_pairs(p, rp) + [(z, x)], s1 + s2, ref2_s

    def rt2d_planes():
        p, s1 = _timed(t2.forward, x32, nl, layout="planes")
        z, s2 = _timed(t2.inverse, p)
        return _plane_pairs(p, rp) + [(z, x)], s1 + s2, ref2_s

    def rt2d_bf16():
        xb = jnp.asarray(x32).astype(jnp.bfloat16)
        xb64 = np.asarray(xb.astype(jnp.float32)).astype(np.float64)
        t0 = time.perf_counter()
        rpb = r2.forward(xb64, nl)
        ref_s = time.perf_counter() - t0
        p, s1 = _timed(t2.forward, xb, nl, layout="planes")
        z, s2 = _timed(t2.inverse, p)
        assert z.dtype == jnp.bfloat16, z.dtype
        return (_plane_pairs(p, rpb) + [(np.asarray(z.astype(jnp.float32)),
                                         xb64)], s1 + s2, ref_s)

    def gain_mask():
        gm = np.random.RandomState(1).rand(6, nl)
        z, s = _timed(t2.inverse, ctx["p"], gain_mask=gm)
        t0 = time.perf_counter()
        want = r2.inverse(rp, gm)
        return [(z, want)], s, time.perf_counter() - t0

    def grad():
        # The round trip is the identity (perfect reconstruction, 1e-12 in
        # f64), so the gradient of <w, inverse(forward(x))> is w itself.
        w = np.random.RandomState(2).randn(n, n).astype(np.float32)
        loss = lambda a, w: jnp.vdot(w, t2.inverse(t2.forward(a, nl)))
        g, s = _timed(jax.jit(jax.grad(loss)), x32, w)
        return [(g, w.astype(np.float64))], s, 0.0

    def batch():
        b, m = sz["batch"]
        xb = np.random.RandomState(3).rand(b, m, m).astype(np.float32)
        p, s = _timed(t2.forward, xb, nl)
        t0 = time.perf_counter()
        pairs = []
        for i in range(b):
            want = r2.forward(xb[i].astype(np.float64), nl)
            pairs.append((np.asarray(p.lowpass[i]), want.lowpass))
            pairs += [(np.asarray(h[i]), r) for h, r in
                      zip(p.highpasses, want.highpasses)]
        return pairs, s, time.perf_counter() - t0

    v = sz["vol"]
    t3, r3 = dt.Transform3d(), R.Transform3d()
    v32 = np.random.RandomState(4).rand(v, v, v).astype(np.float32)
    v64 = v32.astype(np.float64)
    ctx3 = {}

    def ref3():
        if "rp" not in ctx3:
            t0 = time.perf_counter()
            ctx3["rp"] = r3.forward(v64, nl)
            ctx3["s"] = time.perf_counter() - t0
        return ctx3["rp"], ctx3["s"]

    def vol3d():
        rp3, ref_s = ref3()
        p, s1 = _timed(t3.forward, v32, nl)
        z, s2 = _timed(t3.inverse, p)
        return _pyr_pairs(p, rp3) + [(z, v64)], s1 + s2, ref_s

    def vol3d_discard():
        # Level 1 keeps only its lowpass; the inverse equals the reference
        # inverse with zero level-1 subbands.
        rp3, ref_s = ref3()
        p, s1 = _timed(t3.forward, v32, nl, discard_level_1=True)
        assert p.highpasses[0] is None
        z, s2 = _timed(t3.inverse, p)
        t0 = time.perf_counter()
        zeroed = R.Pyramid(rp3.lowpass, (np.zeros_like(rp3.highpasses[0]),)
                           + rp3.highpasses[1:], None)
        want = r3.inverse(zeroed)
        ref_s += time.perf_counter() - t0
        return _pyr_pairs(p, rp3, first=1) + [(z, want)], s1 + s2, ref_s

    def sig1d():
        s32 = np.random.RandomState(5).rand(sz["sig"]).astype(np.float32)
        s64 = s32.astype(np.float64)
        t1, r1 = dt.Transform1d(), R.Transform1d()
        p, s1 = _timed(t1.forward, s32, sz["sig_levels"])
        z, s2 = _timed(t1.inverse, p)
        t0 = time.perf_counter()
        rp1 = r1.forward(s64, sz["sig_levels"])
        ref_s = time.perf_counter() - t0
        return _pyr_pairs(p, rp1) + [(z, s64)], s1 + s2, ref_s

    f1, f2 = smooth_pair(sz["reg"])
    rl = sz["reg_levels"]

    def estimatereg():
        def run():
            return registration.estimatereg(t2.forward(f1, rl),
                                            t2.forward(f2, rl))
        av, s = _timed(run)
        t0 = time.perf_counter()
        want = R.estimatereg(r2.forward(f1.astype(np.float64), rl),
                             r2.forward(f2.astype(np.float64), rl))
        return [(av, want)], s, time.perf_counter() - t0

    def keypoints():
        kl = sz["kp_levels"]
        p = t2.forward(f1, kl)
        kp, s = _timed(keypoint.find_keypoints, p.highpasses, max_points=200)
        t0 = time.perf_counter()
        want = R.find_keypoints(r2.forward(f1.astype(np.float64), kl)
                                .highpasses, max_points=200)
        ref_s = time.perf_counter() - t0
        if kp.shape != want.shape:
            raise AssertionError("%d keypoints, reference %d"
                                 % (len(kp), len(want)))
        # Match point by point (near-equal energies may swap rank): the
        # nearest library point of the same scale to each reference point.
        got = np.empty_like(want)
        for i, (wx, wy, ws, _) in enumerate(want):
            same = kp[kp[:, 2] == ws]
            if not len(same):
                raise AssertionError("no keypoint at scale %g" % ws)
            got[i] = same[np.argmin(np.hypot(same[:, 0] - wx,
                                             same[:, 1] - wy))]
        # positions relative to the scale's grid step, energies to the max
        pairs = [(got[:, :2] / want[:, 2:3], want[:, :2] / want[:, 2:3]),
                 (got[:, 3], want[:, 3])]
        return pairs, s, ref_s

    def f64_roundtrip():
        with jax.enable_x64(True):
            t = dt.Transform2d()
            x64 = np.random.RandomState(6).rand(n, n)
            p, s1 = _timed(t.forward, x64, nl)
            z, s2 = _timed(t.inverse, p)
            assert z.dtype == jnp.float64, z.dtype
            t0 = time.perf_counter()
            want = r2.forward(x64, nl)
            ref_s = time.perf_counter() - t0
            return _pyr_pairs(p, want) + [(z, x64)], s1 + s2, ref_s

    img, bm = (n, n), sz["batch"]
    _phase("rt2d", img, TOL_F32, rt2d)
    _phase("rt2d_planes", img, TOL_F32, rt2d_planes)
    _phase("rt2d_bf16_planes", img, TOL_BF16, rt2d_bf16)
    _phase("gain_mask_inverse", img, TOL_F32, gain_mask)
    _phase("grad_roundtrip", img, TOL_F32, grad)
    _phase("batch_forward", (bm[0], bm[1], bm[1]), TOL_F32, batch)
    _phase("vol3d", (v, v, v), TOL_F32, vol3d)
    _phase("vol3d_discard_level_1", (v, v, v), TOL_F32, vol3d_discard)
    _phase("sig1d", (sz["sig"],), TOL_F32, sig1d)
    _phase("estimatereg", f1.shape, TOL_REG, estimatereg)
    _phase("find_keypoints", f1.shape, TOL_KP, keypoints)
    _phase("rt2d_f64", img, TOL_F64, f64_roundtrip)


# ---------------------------------------------------------------------------
# four-card phases: the sharded paths against one card
# ---------------------------------------------------------------------------

def run_four_cards(sz):
    import jax
    import dtcwt_tpu as dt
    from dtcwt_tpu import registration
    from dtcwt_tpu.parallel import (make_mesh, ShardedTransform2d,
                                    ShardedTransform3d, estimatereg_sharded)

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit("--four-cards needs 4 GPUs, JAX sees %d" % len(devs))
    devs, nl = devs[:4], sz["levels"]
    one = lambda a: jax.device_put(a, devs[0])

    def sharded2d():
        n = sz["big_img"]
        x = np.random.RandomState(7).rand(1, n, n).astype(np.float32)
        st = ShardedTransform2d(make_mesh((1, 4), ("data", "rows"), devs))
        p, s1 = _timed(st.forward, x, nl)
        z, s2 = _timed(st.inverse, p)
        t = dt.Transform2d()
        want = t.forward(one(x[0]), nl)
        zw = t.inverse(want)
        pairs = [(np.asarray(p.lowpass)[0], np.asarray(want.lowpass))]
        pairs += [(np.asarray(h)[0], np.asarray(w))
                  for h, w in zip(p.highpasses, want.highpasses)]
        return pairs + [(np.asarray(z)[0], np.asarray(zw))], s1 + s2, 0.0

    def sharded3d():
        v = sz["big_vol"]
        x = np.random.RandomState(8).rand(1, v, v, v).astype(np.float32)
        st = ShardedTransform3d(make_mesh((1, 4), ("data", "depth"), devs))
        p, s1 = _timed(st.forward, x, nl)
        z, s2 = _timed(st.inverse, p)
        t = dt.Transform3d()
        want = t.forward(one(x[0]), nl)
        zw = t.inverse(want)
        pairs = [(np.asarray(p.lowpass)[0], np.asarray(want.lowpass))]
        pairs += [(np.asarray(h)[0], np.asarray(w))
                  for h, w in zip(p.highpasses, want.highpasses)]
        return pairs + [(np.asarray(z)[0], np.asarray(zw))], s1 + s2, 0.0

    def reg_sharded():
        f1, f2 = smooth_pair(sz["reg"])
        t, rl = dt.Transform2d(), sz["reg_levels"]
        p1, p2 = t.forward(one(f1), rl), t.forward(one(f2), rl)
        mesh = make_mesh((4,), ("rows",), devs)
        av, s = _timed(estimatereg_sharded, p1, p2, mesh)
        want = registration.estimatereg(p1, p2)
        return [(av, want)], s, 0.0

    big, bv = sz["big_img"], sz["big_vol"]
    _phase("sharded2d_1x4", (big, big), TOL_SHARD, sharded2d)
    _phase("sharded3d_depth4", (bv, bv, bv), TOL_SHARD, sharded3d)
    _phase("estimatereg_sharded4", (sz["reg"], sz["reg"]), TOL_REG,
           reg_sharded)


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on 4 GPUs")
    args = ap.parse_args()

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print("chip_smoke: JAX found no GPU (platform %r); this smoke test "
              "runs only on the card" % devices[0].platform, file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    from dtcwt_tpu.utils import use_compile_cache
    use_compile_cache(os.path.join(ROOT, ".jax_cache"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print("card: %s" % line.strip())
    print("jax %s, %d device(s): %s" % (jax.__version__, len(devices),
                                        devices[0].device_kind), flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        run_four_cards(FULL)
        count = 4
    else:
        run_single_card(FULL)
        count = 1
    print("all phases passed in %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
