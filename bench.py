"""North-star benchmark: 4096x4096 2-D 3-level DTCWT round trip, frames/s/chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
The headline is the full forward+inverse round trip (r1 verdict: the
forward-only number hid the weaker half); the forward-only figure is kept
as extra fields for continuity with BENCH_r01.

Baseline: the reference NumPy backend measures 57.3 ms for a 512x512
3-level forward on a Xeon E5-2660 (reference `tests/Speed Tests.ipynb`,
`large_np` cell); NumPy cost scales ~linearly in pixels, giving ~3.667
s/frame at 4096^2, i.e. 0.2727 frames/s forward-only (BASELINE.md).  The
reference's inverse (colifilt interpolation) costs at least as much as the
forward, so the round-trip baseline is conservatively 2x the forward time:
0.1364 frames/s.  vs_baseline is our round-trip frames/s divided by that.

Timing methodology: iterations are chained inside a single jitted lax.scan
(true data dependence) and the clock stops on a host readback of the
reduced result.
"""

import json
import time

import numpy as np

BASELINE_FWD_FPS = 0.2727   # reference NumPy fwd, 4096^2 3-level (BASELINE.md)
BASELINE_RT_FPS = 0.1364    # conservative fwd+inv baseline (2x forward time)


def main():
    import jax
    import jax.numpy as jnp
    import dtcwt_tpu as dt
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()
    t = dt.Transform2d()  # near_sym_a / qshift_a, as in the reference bench
    x = jnp.asarray(np.random.RandomState(0).rand(4096, 4096).astype(np.float32))
    float(x.sum())  # materialize on device

    iters = 20

    def timed(run, arg=x):
        float(run(arg))  # compile + warm
        t0 = time.time()
        float(run(arg))  # host readback forces completion
        return (time.time() - t0) / iters

    @jax.jit
    def run_fwd(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=3, include_scale=False)
            s = sum(jnp.sum(h.real) + jnp.sum(h.imag) for h in p.highpasses)
            s = s + jnp.sum(p.lowpass)
            # keep the carry alive without changing it meaningfully
            return c + s * 0.0, s
        return jax.lax.scan(body, a, None, length=iters)[1].sum()

    @jax.jit
    def run_rt(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=3, include_scale=False)
            r = t._inverse_body(p, None)
            s = jnp.sum(r)
            return c + s * 0.0, s
        return jax.lax.scan(body, a, None, length=iters)[1].sum()

    # Plane-layout roundtrip (layout='planes'): the band-major PlanePyramid
    # skips the complex [..., 6] assembly and the inverse's band re-split.
    @jax.jit
    def run_rt_planes(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=3, include_scale=False,
                                layout="planes")
            r = t._inverse_body(p, None)
            s = jnp.sum(r)
            return c + s * 0.0, s
        return jax.lax.scan(body, a, None, length=iters)[1].sum()

    # bf16 plane-layout roundtrip: bf16 is storage (half the HBM traffic of
    # f32); the filter arithmetic runs at f32.
    xbf = x.astype(jnp.bfloat16)
    float(xbf.astype(jnp.float32).sum())

    @jax.jit
    def run_rt_bf16(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=3, include_scale=False,
                                layout="planes")
            r = t._inverse_body(p, None)
            s = jnp.sum(r.astype(jnp.float32))
            return c + (s * 0.0).astype(c.dtype), s
        return jax.lax.scan(body, a, None, length=iters)[1].sum()

    # the bf16 scan carry is a bf16 elementwise pass (half the f32 carry
    # cost); subtract a matching measurement, not the f32 one
    @jax.jit
    def run_carry_bf16(a):
        def body(c, _):
            s = jnp.sum(c.astype(jnp.float32)) * 1e-9
            return c + (s * 0.0).astype(c.dtype), s
        return jax.lax.scan(body, a, None, length=iters)[1].sum()

    # subtract the scan-carry update cost (~one 4096^2 elementwise pass),
    # measured with an identity body
    @jax.jit
    def run_carry(a):
        def body(c, _):
            s = jnp.sum(c) * 1e-9
            return c + s * 0.0, s
        return jax.lax.scan(body, a, None, length=iters)[1].sum()

    # 3-D volume roundtrip: 256^3 3-level, the reference's worst-scaling case
    # (Python plane loops, numpy/transform3d.py:208-289).
    t3 = dt.Transform3d()
    v = jnp.asarray(np.random.RandomState(1).rand(256, 256, 256)
                    .astype(np.float32))
    float(v.sum())
    iters3 = 5

    @jax.jit
    def run_rt3(a):
        def body(c, _):
            p = t3._forward_body(c, nlevels=3, include_scale=False,
                                 discard_level_1=False)
            r = t3._inverse_body(p)
            return r, jnp.sum(r)
        return jax.lax.scan(body, a, None, length=iters3)[1].sum()

    # plane-layout 3-D roundtrip (band-major re/im planes)
    @jax.jit
    def run_rt3_planes(a):
        def body(c, _):
            p = t3._forward_body(c, nlevels=3, include_scale=False,
                                 discard_level_1=False, layout="planes")
            r = t3._inverse_body(p)
            return r, jnp.sum(r)
        return jax.lax.scan(body, a, None, length=iters3)[1].sum()

    def timed3(run):
        float(run(v))
        t0 = time.time()
        float(run(v))
        return (time.time() - t0) / iters3

    # Batched throughput: 100 frames of 512^2 per step — the reference TF
    # backend's flagship accelerated case (124 ms/batch on a GTX 1080,
    # `tests/Speed Tests.ipynb` `large_tf_batch`; NumPy 5.44 s).
    xb = jnp.asarray(np.random.RandomState(2).rand(100, 512, 512)
                     .astype(np.float32))
    float(xb.sum())
    itersb = 10

    @jax.jit
    def run_batch(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=3, include_scale=False)
            s = sum(jnp.sum(h.real) + jnp.sum(h.imag) for h in p.highpasses)
            s = s + jnp.sum(p.lowpass)
            return c + s * 0.0, s
        return jax.lax.scan(body, a, None, length=itersb)[1].sum()

    def timedb(run):
        float(run(xb))
        t0 = time.time()
        float(run(xb))
        return (time.time() - t0) / itersb

    # Registration (the reference's flagship algorithm, SURVEY §3.3) and
    # keypoint detection, device-resident and scan-chained like every other
    # case (r4 verdict item 5: neither was in the bench record).  The pair
    # is a smooth synthetic field and a 3-px shift of it — estimatereg's
    # solver needs correlated structure, not white noise.
    import dtcwt_tpu.registration as reg
    import dtcwt_tpu.keypoint as kp
    from jax import lax

    rs = np.random.RandomState(3)
    spec = np.fft.rfft2(rs.rand(512, 512))
    fy = np.fft.fftfreq(512)[:, None]
    fx = np.fft.rfftfreq(512)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * 0.02 ** 2)))
    f1 = np.fft.irfft2(spec).astype(np.float32)
    f1 = (f1 - f1.min()) / (f1.max() - f1.min())
    f2 = np.roll(f1, (3, 2), axis=(0, 1))

    itersr = 10

    def run_registration():
        p1 = t._forward_body(jnp.asarray(f1), nlevels=6, include_scale=False)
        p2 = t._forward_body(jnp.asarray(f2), nlevels=6, include_scale=False)
        avecs_shape = tuple(int(s) for s in p1.highpasses[3].shape[:2]) + (6,)
        levels = tuple(tuple(int(l) for l in lv)
                       for lv in reg._default_levels(len(p1.highpasses)))
        impl = reg._estimatereg_impl(avecs_shape, levels)

        @jax.jit
        def run(seed, p1, p2):
            def body(c, _):
                p1c = dt.Pyramid(p1.lowpass + 0.0 * c[0, 0], p1.highpasses)
                av = impl(p1c, p2)
                return c + 0.0 * av[:1, :1, 0], jnp.sum(av)
            return lax.scan(body, seed, None, length=itersr)[1].sum()

        seed = jnp.zeros((1, 1), jnp.float32)
        float(run(seed, p1, p2))
        t0 = time.time()
        float(run(seed, p1, p2))
        return (time.time() - t0) / itersr

    def run_keypoints():
        p1 = t._forward_body(jnp.asarray(f1), nlevels=4, include_scale=False)
        hps = tuple(p1.highpasses)

        @jax.jit
        def run(seed, hps):
            def body(c, _):
                h0 = tuple(h * (1.0 + 0.0 * c) for h in hps[1:])
                out = kp._detect(h0, 1.0, 0.4, 1.0 / 6.0, None,
                                 method="fauqueur", refine=True,
                                 skip_levels=1, upsample_scale=1,
                                 uhp=None, uke=None, max_points=200)
                v = out[:, 3]
                s = jnp.sum(jnp.where(jnp.isfinite(v), v, 0.0))
                return c + 0.0 * s, s
            return lax.scan(body, seed, None, length=itersr)[1].sum()

        seed = jnp.zeros((), jnp.float32)
        float(run(seed, hps))
        t0 = time.time()
        float(run(seed, hps))
        return (time.time() - t0) / itersr

    # Every timed case runs guarded (r2 verdict item 2: an unguarded 3-D
    # sub-case crash took down the whole JSON line, including 2-D numbers
    # already measured in-process).  A failing case nulls its fields and
    # writes the traceback to stderr; the one JSON line always prints.
    import sys as _sys
    import traceback as _tb

    def guard(name, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — report, null, go on
            print("bench case %r failed: %r" % (name, e), file=_sys.stderr)
            _tb.print_exc(file=_sys.stderr)
            return None

    fwd_s = guard("forward", lambda: timed(run_fwd))
    rt_s = guard("roundtrip", lambda: timed(run_rt))
    rtp_s = guard("roundtrip_planes", lambda: timed(run_rt_planes))
    rtb_s = guard("roundtrip_bf16_planes", lambda: timed(run_rt_bf16, xbf))
    carry_bf16_s = (None if rtb_s is None
                    else guard("carry_bf16", lambda: timed(run_carry_bf16,
                                                           xbf)))
    carry_s = guard("carry", lambda: timed(run_carry)) or 0.0
    rt3_s = guard("vol3d_256", lambda: timed3(run_rt3))
    rt3p_s = guard("vol3d_256_planes", lambda: timed3(run_rt3_planes))
    batch_s = guard("batch100_512", lambda: timedb(run_batch))
    reg_s = guard("estimatereg", run_registration)
    kpt_s = guard("find_keypoints", run_keypoints)

    def frame(s, base=carry_s):
        return None if s is None else max(s - base, 1e-9)

    fwd_frame = frame(fwd_s)
    rt_frame = frame(rt_s)
    rtp_frame = frame(rtp_s)
    rtb_frame = (None if rtb_s is None or carry_bf16_s is None
                 else frame(rtb_s, carry_bf16_s))
    rt_fps = None if rt_frame is None else 1.0 / rt_frame
    fwd_fps = None if fwd_frame is None else 1.0 / fwd_frame
    rnd = lambda v, n=2: None if v is None else round(v, n)
    ms = lambda s: None if s is None else round(s * 1e3, 2)
    print(json.dumps({
        "metric": "dtcwt2d_roundtrip_4096x4096_3level_frames_per_sec_per_chip",
        "value": rnd(rt_fps),
        "unit": "frames/s",
        "vs_baseline": (None if rt_fps is None
                        else round(rt_fps / BASELINE_RT_FPS, 1)),
        "forward_fps": rnd(fwd_fps),
        "forward_vs_baseline": (None if fwd_fps is None
                                else round(fwd_fps / BASELINE_FWD_FPS, 1)),
        "forward_ms": ms(fwd_frame),
        "inverse_ms": (None if rt_frame is None or fwd_frame is None
                       else round((rt_frame - fwd_frame) * 1e3, 2)),
        "roundtrip_ms": ms(rt_frame),
        "roundtrip_planes_ms": ms(rtp_frame),
        "roundtrip_planes_fps": (None if rtp_frame is None
                                 else round(1.0 / rtp_frame, 2)),
        "roundtrip_bf16_planes_ms": ms(rtb_frame),
        "roundtrip_bf16_planes_fps": (None if rtb_frame is None
                                      else round(1.0 / rtb_frame, 2)),
        "vol3d_256_roundtrip_ms": ms(rt3_s),
        "vol3d_256_roundtrip_mvox_per_s": (
            None if rt3_s is None else round(256 ** 3 / rt3_s / 1e6, 1)),
        "vol3d_256_roundtrip_planes_ms": ms(rt3p_s),
        "vol3d_256_roundtrip_planes_mvox_per_s": (
            None if rt3p_s is None else round(256 ** 3 / rt3p_s / 1e6, 1)),
        "batch100_512_forward_ms": ms(batch_s),
        "batch100_512_forward_fps": (None if batch_s is None
                                     else round(100.0 / batch_s, 1)),
        "estimatereg_ms_per_iter": ms(reg_s),
        "find_keypoints_ms": ms(kpt_s),
    }))


if __name__ == "__main__":
    main()
