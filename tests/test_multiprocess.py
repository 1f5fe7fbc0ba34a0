"""Multi-process GOP pipeline smoke test.

Launches the video-registration example across TWO local CPU processes
connected through ``jax.distributed.initialize`` (the JAX analogue
of the reference's MPI scatter/gather,
upstream ``examples/register_video.py:93-180``), asserting that

* the two ranks process disjoint GOPs (round-robin sharding),
* per-GOP part files checkpoint/resume,
* the merged multi-process output equals a single-process run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.realpath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLE = os.path.join(REPO, "examples", "register_video.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_video(path, T=9, N=64):
    rng = np.random.RandomState(0)
    base = rng.rand(N, N).astype(np.float32)
    frames = np.stack([np.roll(base, t, axis=1) for t in range(T)])
    np.savez(path, frames=frames)


def _run(args, env, timeout=600):
    return subprocess.run(
        [sys.executable, EXAMPLE] + args, env=env, timeout=timeout,
        capture_output=True, text=True)


def test_two_process_gop_pipeline(tmp_path):
    video = str(tmp_path / "video.npz")
    _make_video(video)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)    # plain single-device CPU per process
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))

    # --- single-process reference run ---------------------------------
    out1 = str(tmp_path / "single.npz")
    r = _run([video, out1, "--gop-size", "4", "--nlevels", "4"], env)
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run([video, out1, "--merge"], env)
    assert r.returncode == 0, r.stderr[-2000:]

    # --- two-process run ----------------------------------------------
    out2 = str(tmp_path / "multi.npz")
    port = _free_port()
    common = [video, out2, "--gop-size", "4", "--nlevels", "4",
              "--coordinator", "localhost:%d" % port,
              "--num-processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, EXAMPLE] + common + ["--process-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    # 3 GOPs round-robin over 2 ranks: rank 0 -> gop 0, 2; rank 1 -> gop 1
    parts = sorted(os.path.basename(p) for p in
                   __import__("glob").glob(out2 + ".gop*.npz"))
    assert parts == ["multi.npz.gop0000.npz", "multi.npz.gop0001.npz",
                     "multi.npz.gop0002.npz"]
    assert "registering GOP 1" in outs[1][1] or "GOP 1" in outs[1][1]

    # resume: a (single-process) re-run over the same parts skips every
    # finished GOP
    r = _run([video, out2, "--gop-size", "4", "--nlevels", "4"], env)
    assert r.returncode == 0
    assert "skipping (resume)" in (r.stderr + r.stdout)

    r = _run([video, out2, "--merge"], env)
    assert r.returncode == 0, r.stderr[-2000:]

    with np.load(out1) as f1, np.load(out2) as f2:
        np.testing.assert_array_equal(f1["frame_idx_pairs"],
                                      f2["frame_idx_pairs"])
        np.testing.assert_allclose(f1["affine_parameters"],
                                   f2["affine_parameters"],
                                   rtol=0, atol=1e-12)
