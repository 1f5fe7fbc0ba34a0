#!/usr/bin/env python
"""Benchmark the 2-D forward transform across sizes and batches.

Counterpart of the reference ``scripts/benchmark_opencl.py`` (adaptive
timeit over NumPy vs OpenCL, :32-47) and the recorded rows of
``tests/Speed Tests.ipynb``, on whatever device JAX finds.

Timing methodology: iterations are chained inside one jitted ``lax.scan``
(true data dependence) and the clock stops on a host readback.
"""

import argparse
import time

import os
import sys

# Allow running straight from a checkout (reference scripts do the
# same, scripts/benchmark_registration.py:8-11).
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def bench(t, x, nlevels, iters, layout="interleaved", roundtrip=False):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(a):
        def body(c, _):
            p = t._forward_body(c, nlevels=nlevels, include_scale=False,
                                layout=layout)
            if roundtrip:
                r = t._inverse_body(p, None)
                s = jnp.sum(r.astype(jnp.float32))
            elif layout == "planes":
                s = sum(jnp.sum(h.astype(jnp.float32))
                        for h in p.highpasses_re + p.highpasses_im)
            else:
                s = sum(jnp.sum(h.real) + jnp.sum(h.imag)
                        for h in p.highpasses)
            return c * (1.0 + 0.0 * s).astype(c.dtype), s
        _, ss = jax.lax.scan(body, a, None, length=iters)
        return ss.sum()

    float(run(x))   # warm-up / compile
    t0 = time.perf_counter()
    float(run(x))
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nlevels", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="512,4x512,4096",
                    help="comma list: SIZE or BATCHxSIZE")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="bfloat16 implies --layout planes (bf16 pyramids "
                         "exist only in the plane layout)")
    ap.add_argument("--layout", default="interleaved",
                    choices=("interleaved", "planes"))
    ap.add_argument("--roundtrip", action="store_true",
                    help="time forward+inverse instead of forward-only")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import dtcwt_tpu as dt
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()
    print("backend:", jax.default_backend(), jax.devices()[0].device_kind)
    t = dt.Transform2d()
    rng = np.random.RandomState(0)

    for case in args.cases.split(","):
        if "x" in case:
            b, n = (int(v) for v in case.split("x"))
            shape = (b, n, n)
        else:
            n = int(case)
            shape = (n, n)
        layout = args.layout
        if args.dtype == "bfloat16":
            layout = "planes"
        x = jnp.asarray(rng.rand(*shape).astype(np.float32),
                        getattr(jnp, args.dtype))
        float(x.astype(jnp.float32).sum())
        frames = shape[0] if len(shape) == 3 else 1
        dt_s = bench(t, x, args.nlevels, args.iters, layout=layout,
                     roundtrip=args.roundtrip)
        print("%-10s %8.3f ms/iter  %9.1f frames/s"
              % (case, dt_s * 1e3, frames / dt_s))


if __name__ == "__main__":
    main()
