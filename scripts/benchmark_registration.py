#!/usr/bin/env python
"""Benchmark phase-based registration on a frame pair.

Counterpart of the reference ``scripts/benchmark_registration.py:14-40``
(6-level transform of the tennis frames + repeated ``estimatereg``).  Pass
an ``.npz`` whose first two arrays (sorted by key) are the frames; without
one, a smooth random 512x512 frame and a copy shifted by (3, 2) px stand
in.

Usage: python scripts/benchmark_registration.py [frames.npz]
"""

import time

import os
import sys

# Allow running straight from a checkout (reference scripts do the
# same, scripts/benchmark_registration.py:8-11).
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def smooth_pair(n=512, seed=3, sigma=0.02, shift=(3, 2)):
    """A smooth random frame in [0, 1] and the same frame rolled by
    *shift* pixels."""
    spec = np.fft.rfft2(np.random.RandomState(seed).rand(n, n))
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * sigma ** 2)))
    f1 = np.fft.irfft2(spec, s=(n, n)).astype(np.float32)
    f1 = (f1 - f1.min()) / (f1.max() - f1.min())
    return f1, np.roll(f1, shift, axis=(0, 1))


def main():
    import dtcwt_tpu as dt
    import dtcwt_tpu.registration as reg
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()
    print("Loading datasets...")
    if len(sys.argv) > 1:
        with np.load(sys.argv[1]) as f:
            keys = sorted(f.keys())
            f1, f2 = (f[k].astype(np.float32) for k in keys[:2])
    else:
        f1, f2 = smooth_pair()

    print("Transforming datasets...")
    transform = dt.Transform2d()
    t1 = transform.forward(f1, nlevels=6)
    t2 = transform.forward(f2, nlevels=6)

    print("Registering datasets...")
    np.asarray(reg.estimatereg(t1, t2))   # warm-up / compile

    number = 20

    # Per-call host loop (includes dispatch and readback overhead):
    t0 = time.perf_counter()
    for _ in range(number):
        np.asarray(reg.estimatereg(t1, t2))
    secs = time.perf_counter() - t0
    print("host loop:   %.2fs for %d iterations => %.1f ms/iteration"
          % (secs, number, 1e3 * secs / number))

    # Device-resident timing: iterations chained inside one jitted scan
    # with a data dependence (the same methodology as bench.py).
    import jax
    import jax.numpy as jnp

    avecs_shape = tuple(np.asarray(t1.highpasses[3].shape[:2])) + (6,)
    levels = tuple(tuple(int(l) for l in lv)
                   for lv in reg._default_levels(len(t1.highpasses)))
    impl = reg._estimatereg_impl(avecs_shape, levels)

    @jax.jit
    def run(low, p1, p2):
        def body(c, _):
            p1c = dt.Pyramid(p1.lowpass + 0.0 * c[0, 0], p1.highpasses)
            av = impl(p1c, p2)
            return c + 0.0 * av[:1, :1, 0], jnp.sum(av)
        return jax.lax.scan(body, low, None, length=number)[1].sum()

    seed = jnp.zeros((1, 1), jnp.float32)
    float(run(seed, t1, t2))
    t0 = time.perf_counter()
    float(run(seed, t1, t2))
    print("device scan: %.1f ms/iteration"
          % (1e3 * (time.perf_counter() - t0) / number))


if __name__ == "__main__":
    main()
