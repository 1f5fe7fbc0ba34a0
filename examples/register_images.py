#!/usr/bin/env python
"""Register two frames and save the inter-frame transform parameters.

Counterpart of the reference ``examples/register_images.py`` (which offered
a ``--cl`` OpenCL switch; here the one XLA code path runs on whatever device
JAX finds).

Usage:
    python examples/register_images.py <prevframe> <nextframe> <output.npz>
    python examples/register_images.py --demo <output.npz>   # synthetic pair

Frames may be ``.npz``/``.npy`` arrays or (with Pillow installed) any image
file; images are converted to grayscale in [0, 1].  The output npz holds the
per-block affine parameter field ``avecs`` plus the derived ``vxs``/``vys``
velocity field, exactly the artifact layout of the reference example
(``register_images.py:56-66``).
"""

import argparse
import logging

import os
import sys

# Allow running straight from a checkout (reference scripts do the
# same, scripts/benchmark_registration.py:8-11).
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def load_frame(path):
    if path.endswith(".npz"):
        with np.load(path) as f:
            return np.asarray(f[list(f.keys())[0]], dtype=np.float32)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from PIL import Image  # optional dependency, as in the reference
    return np.asarray(Image.open(path).convert("L"), dtype=np.float32) / 255.0


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="<prevframe> <nextframe> <output.npz>, or with "
                         "--demo just <output.npz>")
    ap.add_argument("--demo", action="store_true",
                    help="use a smooth random frame and a copy shifted by "
                         "(3, 2) px")
    ap.add_argument("--nlevels", type=int, default=5)
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)

    if args.demo:
        (out,) = args.paths
        spec = np.fft.rfft2(np.random.RandomState(3).rand(512, 512))
        fy = np.fft.fftfreq(512)[:, None]
        fx = np.fft.rfftfreq(512)[None, :]
        spec *= np.exp(-(fy ** 2 + fx ** 2) / (2 * 0.02 ** 2))
        prev_img = np.fft.irfft2(spec, s=(512, 512)).astype(np.float32)
        next_img = np.roll(prev_img, (3, 2), axis=(0, 1))
    else:
        prev_path, next_path, out = args.paths
        logging.info("Loading 'prev' image from %s", prev_path)
        prev_img = load_frame(prev_path)
        logging.info("Loading 'next' image from %s", next_path)
        next_img = load_frame(next_path)

    import dtcwt_tpu as dt
    import dtcwt_tpu.registration as reg
    from dtcwt_tpu.utils import use_compile_cache

    use_compile_cache()

    logging.info("Estimating registration (%d levels)", args.nlevels)
    t = dt.Transform2d()
    t1 = t.forward(prev_img, nlevels=args.nlevels)
    t2 = t.forward(next_img, nlevels=args.nlevels)
    avecs = np.asarray(reg.estimatereg(t1, t2))

    logging.info("Calculating velocity field")
    vxs, vys = reg.velocityfield(avecs, avecs.shape[:2], method="bilinear")

    logging.info("Saving result to %s", out)
    np.savez_compressed(out, avecs=avecs, vxs=np.asarray(vxs),
                        vys=np.asarray(vys))


if __name__ == "__main__":
    main()
