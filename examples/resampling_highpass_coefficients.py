#!/usr/bin/env python
"""Demonstrate phase-aware resampling of DTCWT highpass subbands.

Counterpart of the reference ``examples/resampling_highpass_coefficients.py``:
upsampling a complex subband *without* phase handling smears the directional
phase ramps; :func:`dtcwt_tpu.sampling.rescale_highpass` unwraps each
subband's expected phase, interpolates the slowly-varying residual, and
rewraps (reference ``dtcwt/sampling.py:167-247``).

Saves an npz with the naive and phase-aware x2 upsamplings of a level-3
subband of a half-size image, next to the same subband of the full-size
image (a smooth random texture, seeded); prints the error comparison.
"""

import argparse

import os
import sys

# Allow running straight from a checkout (reference scripts do the
# same, scripts/benchmark_registration.py:8-11).
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", nargs="?", default="resampled_highpass.npz")
    args = ap.parse_args()

    import dtcwt_tpu as dt
    from dtcwt_tpu import sampling
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()

    # A smooth random texture: white noise low-passed by a Gaussian.
    spec = np.fft.rfft2(np.random.RandomState(0).rand(512, 512))
    fy = np.fft.fftfreq(512)[:, None]
    fx = np.fft.rfftfreq(512)[None, :]
    spec *= np.exp(-(fy ** 2 + fx ** 2) / (2 * 0.05 ** 2))
    img = np.fft.irfft2(spec, s=(512, 512)).astype(np.float32)

    t = dt.Transform2d()
    # Subband of the half-size image: the x2-rescaled subband should match
    # the same-level subband of the full-size image.
    small = img[::2, ::2]
    sb_small = np.asarray(t.forward(small, nlevels=3).highpasses[2])
    sb_big = np.asarray(t.forward(img, nlevels=3).highpasses[2])
    target_shape = sb_big.shape[:2]

    naive = np.asarray(sampling.rescale(sb_small, target_shape, "lanczos"))
    aware = np.asarray(
        sampling.rescale_highpass(sb_small, target_shape, "lanczos"))

    err_naive = np.abs(naive - sb_big).mean()
    err_aware = np.abs(aware - sb_big).mean()
    print("mean |err| vs true subband: naive=%.5f phase-aware=%.5f (%.1fx"
          " better)" % (err_naive, err_aware, err_naive / err_aware))

    np.savez_compressed(args.output, naive=naive, phase_aware=aware,
                        reference=sb_big)
    print("saved", args.output)


if __name__ == "__main__":
    main()
