#!/usr/bin/env python
"""Benchmark the 3-D transform (forward / roundtrip) across volume sizes.

The reference's 3-D path is its worst-scaling code (Python plane loops,
upstream ``dtcwt/numpy/transform3d.py:208-289``); this script tracks the
whole-volume path, whose hot ops are the dual-stream tree stages of
``ops/fb.py`` (both branch outputs from one read on analysis, fused
branch-pair sums on synthesis).

Timing methodology as in benchmark_transform.py: iterations chained inside
one jitted ``lax.scan`` with a true data dependence; the clock stops on a
host readback.
"""

import argparse
import time

import os
import sys

sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def bench_fwd(t, x, nlevels, iters):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=nlevels, include_scale=False,
                                discard_level_1=False)
            s = sum(jnp.sum(h.real) + jnp.sum(h.imag) for h in p.highpasses)
            return c * (1.0 + 0.0 * s), s
        _, ss = jax.lax.scan(body, a, None, length=iters)
        return ss.sum()

    float(run(x))   # warm-up / compile
    t0 = time.perf_counter()
    float(run(x))
    return (time.perf_counter() - t0) / iters


def bench_roundtrip(t, x, nlevels, iters):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=nlevels, include_scale=False,
                                discard_level_1=False)
            r = t._inverse_body(p)
            return r, jnp.sum(r)
        _, ss = jax.lax.scan(body, a, None, length=iters)
        return ss.sum()

    float(run(x))
    t0 = time.perf_counter()
    float(run(x))
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nlevels", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cases", default="128,256",
                    help="comma list of cube edge sizes (or DxHxW)")
    ap.add_argument("--family", default="near_sym_a,qshift_a")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import dtcwt_tpu as dt
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()
    print("backend:", jax.default_backend(), jax.devices()[0].device_kind)
    biort, qshift = args.family.split(",")
    t = dt.Transform3d(biort, qshift)
    rng = np.random.RandomState(0)

    for case in args.cases.split(","):
        if "x" in case:
            shape = tuple(int(v) for v in case.split("x"))
        else:
            n = int(case)
            shape = (n, n, n)
        x = jnp.asarray(rng.rand(*shape).astype(np.float32))
        float(x.sum())
        mvox = np.prod(shape) / 1e6
        f_s = bench_fwd(t, x, args.nlevels, args.iters)
        rt_s = bench_roundtrip(t, x, args.nlevels, args.iters)
        print("%-12s fwd %8.2f ms (%6.1f Mvox/s)   "
              "roundtrip %8.2f ms (%6.1f Mvox/s)"
              % (case, f_s * 1e3, mvox / f_s, rt_s * 1e3, mvox / rt_s))


if __name__ == "__main__":
    main()
