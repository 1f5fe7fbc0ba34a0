#!/usr/bin/env python
"""Frame-to-frame registration of a video, parallel over groups of frames.

Redesign of the reference's MPI example
(``examples/register_video.py:93-180``: rank 0 reads the video, *scatters*
groups-of-frames over MPI workers, *gathers* affine parameters into HDF5
EArrays).  The same GOP (group-of-frames) decomposition maps onto the JAX
runtime without any message-passing code:

* **Multi-process**: GOPs are sharded round-robin over
  ``jax.process_count()`` processes (launch one process per GPU with
  ``--coordinator``/``--num-processes``/``--process-id``, and bind each to
  its own card with ``--local-device-id``); each process decodes and
  registers only its own GOPs — the analogue of the MPI scatter at
  reference :144.
* **Per-host**: each GOP's frames go through ONE batched forward transform;
  the per-pair registration refinement (a host-side schedule over jitted
  stages) then reuses the same compiled programs for every pair.
* **Checkpoint/resume**: each finished GOP is written to its own
  ``<output>.gopNNNN.npz`` part file and skipped on restart — the
  append-only restartable layout the reference got from HDF5 EArrays
  (reference :106-121,152-170).  ``--merge`` consolidates the parts.

Input is an ``.npz`` stack of frames ``[T, H, W]``; a real video decoder can
be substituted in ``read_frames``.

Usage:
    python examples/register_video.py <input.npz> <output.npz> \
        [--gop-size 8] [--nlevels 5] [--merge]
"""

import argparse
import glob
import logging
import os
import sys

# Allow running straight from a checkout (reference scripts do the
# same, scripts/benchmark_registration.py:8-11).
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def read_frames(path):
    """[T, H, W] float32 frame stack from an npz (stacks per-key frames)."""
    with np.load(path) as f:
        keys = sorted(f.keys())
        arrs = [np.asarray(f[k], dtype=np.float32) for k in keys]
    if len(arrs) == 1 and arrs[0].ndim == 3:
        return arrs[0]
    return np.stack(arrs)


def register_gop(frames, nlevels):
    """Affine parameter fields for every neighbouring pair in one GOP.

    Fully batched: one forward transform of the whole frame stack, then one
    vmapped estimatereg over the (frames[:-1], frames[1:]) pair views — a
    GOP is two compiled programs on the chip, not a Python loop.
    """
    import jax
    import dtcwt_tpu as dt
    import dtcwt_tpu.registration as reg

    t = dt.Transform2d()
    pyr = t.forward(frames, nlevels=nlevels)   # batched [T, ...] transform
    take = lambda sl: jax.tree_util.tree_map(lambda x: x[sl], pyr)
    av = reg.estimatereg_batched(take(slice(None, -1)), take(slice(1, None)))
    return np.asarray(av)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--gop-size", type=int, default=8)
    ap.add_argument("--nlevels", type=int, default=5)
    ap.add_argument("--merge", action="store_true",
                    help="merge part files into <output> and exit")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the jax.distributed coordinator; "
                         "launch one process per host with matching "
                         "--num-processes/--process-id")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-device-id", type=int, default=None,
                    help="the one GPU of this host this process uses "
                         "(e.g. the process's rank on the host)")
    args = ap.parse_args()

    import jax
    from dtcwt_tpu.utils import use_compile_cache

    if args.coordinator is not None:
        # One process per GPU: bind each process to its own card, so that
        # processes sharing a host do not each reserve every card.
        gpu = args.local_device_id
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=None if gpu is None else [gpu])
    use_compile_cache()

    rank = jax.process_index()
    size = jax.process_count()
    logging.basicConfig(level=logging.INFO,
                        format="Host %d: %%(message)s" % rank)

    if args.merge:
        parts = sorted(p for p in glob.glob(args.output + ".gop*.npz")
                       if not p.endswith(".tmp.npz"))
        pairs, avecs = [], []
        for p in parts:
            with np.load(p) as f:
                pairs.append(f["frame_idx_pairs"])
                avecs.append(f["affine_parameters"])
        np.savez_compressed(args.output,
                            frame_idx_pairs=np.concatenate(pairs),
                            affine_parameters=np.concatenate(avecs),
                            videopath=np.asarray(args.input))
        logging.info("merged %d parts, %d frame pairs",
                     len(parts), sum(len(p) for p in pairs))
        return

    frames = read_frames(args.input)
    T = frames.shape[0]
    gop = max(args.gop_size, 2)
    # GOPs overlap by one frame so every neighbouring pair is covered.
    starts = list(range(0, T - 1, gop - 1))
    logging.info("%d frames -> %d GOPs of <=%d frames; %d host(s)",
                 T, len(starts), gop, size)

    for gi, s in enumerate(starts):
        if gi % size != rank:
            continue   # another host's GOP (the MPI scatter analogue)
        part = "%s.gop%04d.npz" % (args.output, gi)
        if os.path.exists(part):
            logging.info("GOP %d already done, skipping (resume)", gi)
            continue
        chunk = frames[s:s + gop]
        logging.info("registering GOP %d: frames [%d, %d)", gi, s,
                     s + chunk.shape[0])
        av = register_gop(chunk, args.nlevels)
        idxs = np.stack([np.arange(s, s + av.shape[0]),
                         np.arange(s + 1, s + 1 + av.shape[0])], axis=1)
        tmp = part + ".tmp.npz"   # np.savez appends .npz to bare names
        np.savez_compressed(tmp, frame_idx_pairs=idxs, affine_parameters=av)
        os.replace(tmp, part)   # atomic: a crash never leaves a half GOP
        logging.info("GOP %d done (%d pairs)", gi, av.shape[0])

    logging.info("all GOPs for this host complete; run with --merge to "
                 "consolidate")


if __name__ == "__main__":
    main()
