#!/usr/bin/env python
"""Profile the 2-D forward and inverse transforms on the device: per-kernel
device time next to the bytes each kernel reads and writes.

The reference has no in-library tracing (SURVEY.md §5); this is the
package's observability harness.  It writes one TensorBoard-loadable trace
per direction (``tensorboard --logdir <outdir>`` -> Profile tab), each of
``--reps`` warm calls, then prints, for every kernel on the device planes,
its device time per call, its bytes (operands + outputs, from the optimized
HLO; see ``tools/xprof.py``), the implied bandwidth and its output type.

Usage: python scripts/profile_transform.py [outdir] [--size 4096]
           [--nlevels 3] [--layout interleaved|planes] [--reps 5]
"""

import argparse
import glob
import os
import sys

ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np


def report(trace_dir, nbytes, reps, top, line=None):
    """Print the per-kernel table of the newest trace under *trace_dir*."""
    import xprof
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    for name, per_line, per_op, count in xprof.summarize(files[-1],
                                                         line_filter=line):
        print("== plane %s" % name)
        for ln, us in per_line.most_common(8):
            print("   line %-40s %10.1f us/call" % (ln[:40], us / reps))
        print("   %10s %5s %12s %9s  %s" % ("us/call", "n", "bytes", "GB/s",
                                            "kernel | output"))
        for (ln, op), us in per_op.most_common(top):
            us /= reps
            b, typ = nbytes.get(op, (None, ""))
            print("   %10.1f %5d %12s %9s  %s | %s" % (
                us, count[(ln, op)] // reps, "-" if b is None else b,
                "-" if b is None or not us else "%.0f" % (b / us / 1e3),
                op[:60], typ[:48]))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("outdir", nargs="?",
                    default=os.path.join(ROOT, "profile_out"))
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--nlevels", type=int, default=3)
    ap.add_argument("--layout", default="interleaved",
                    choices=("interleaved", "planes"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=60)
    ap.add_argument("--line", default=None,
                    help="only trace lines whose name contains this")
    args = ap.parse_args()

    import jax
    import dtcwt_tpu as dt
    from dtcwt_tpu.utils import use_compile_cache
    import xprof

    use_compile_cache()
    t = dt.Transform2d()
    x = jax.device_put(np.random.RandomState(0)
                       .rand(args.size, args.size).astype(np.float32))
    kw = dict(nlevels=args.nlevels, include_scale=False, layout=args.layout)
    pyr = jax.block_until_ready(t._fwd(x, **kw))      # compile outside
    jax.block_until_ready(t._inv(pyr, None))          # the traces

    for label, run, lowered in (
            ("forward", lambda: t._fwd(x, **kw), t._fwd.lower(x, **kw)),
            ("inverse", lambda: t._inv(pyr, None), t._inv.lower(pyr, None))):
        out = os.path.join(args.outdir, label)
        with jax.profiler.trace(out):
            for _ in range(args.reps):
                jax.block_until_ready(run())
        print("## %s %dx%d, %d levels, %s: trace in %s"
              % (label, args.size, args.size, args.nlevels, args.layout, out))
        nbytes = xprof.hlo_fusion_bytes(lowered.compile().as_text())
        report(out, nbytes, args.reps, args.top, args.line)


if __name__ == "__main__":
    main()
