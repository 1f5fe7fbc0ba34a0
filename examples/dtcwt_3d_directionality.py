#!/usr/bin/env python
"""Visualize the directional selectivity of the 28 3-D DTCWT subbands.

Counterpart of the reference ``docs/3d_dtcwt_directionality.py``: transform
a centred impulse, set one subband's centre coefficient at a time, invert,
and locate each reconstructed wavelet's dominant orientation from the
phase-gradient (centre frequency) of its analytic volume.  Prints the unit
direction vector per subband and saves the reconstructed wavelets.
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
    ap.add_argument("output", nargs="?", default="dtcwt3d_directions.npz")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--level", type=int, default=2)
    args = ap.parse_args()

    import dtcwt_tpu as dt
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()

    N, lev = args.size, args.level
    t = dt.Transform3d(biort="near_sym_a", qshift="qshift_a")
    zero = np.zeros((N, N, N), np.float32)
    pyr = t.forward(zero, nlevels=lev)

    waves = []
    dirs = []
    hp = np.zeros(pyr.highpasses[lev - 1].shape, np.complex64)
    c = tuple(s // 2 for s in hp.shape[:3])
    for band in range(28):
        hp_b = hp.copy()
        hp_b[c[0], c[1], c[2], band] = 1.0
        bands = list(pyr.highpasses[:lev - 1]) + [hp_b]
        rec = np.asarray(t.inverse(dt.Pyramid(pyr.lowpass, tuple(bands))))
        waves.append(rec)

        # Dominant orientation: centre frequency of the analytic wavelet via
        # the mean phase step of its FFT-peak neighbourhood.
        F = np.fft.fftn(rec)
        k = np.unravel_index(np.argmax(np.abs(F)), F.shape)
        freq = np.array([(ki if ki <= s // 2 else ki - s)
                         for ki, s in zip(k, F.shape)], float)
        n = np.linalg.norm(freq)
        dirs.append(freq / n if n else freq)

    dirs = np.stack(dirs)
    for band, d in enumerate(dirs):
        print("subband %2d: direction (%+.2f, %+.2f, %+.2f)"
              % (band, d[0], d[1], d[2]))

    np.savez_compressed(args.output, directions=dirs,
                        wavelets=np.stack(waves))
    print("saved", args.output)


if __name__ == "__main__":
    main()
