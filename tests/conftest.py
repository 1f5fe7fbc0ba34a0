"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding paths are validated on host-platform fake devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8) as the single-machine
stand-in for a multi-GPU host; f64 is required for the 1e-12
perfect-reconstruction gates carried over from the reference test suite.
"""

import os

# Force the CPU platform even on a GPU host: the tests validate f64
# semantics and virtual multi-device meshes, both of which are CPU-host
# features.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Also through the config, in case jax was imported before this file ran.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The persistent compilation cache stays off for the suite, even when
# JAX_COMPILATION_CACHE_DIR is set: with it on, XLA's CPU compiler crashed
# the pytest process inside the cache's read and write paths.  Repeat-run
# speed is not worth a flaky signal.
jax.config.update("jax_enable_compilation_cache", False)
