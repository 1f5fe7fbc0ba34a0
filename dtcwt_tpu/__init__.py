"""dtcwt_tpu — a dual-tree complex wavelet transform framework in JAX.

A from-scratch JAX/XLA implementation with the capabilities of the
reference ``dtcwt`` library (rjw57/dtcwt): forward/inverse 1-D, 2-D and 3-D
DTCWT for every published biort/qshift wavelet family (including the
rotationally-symmetric bandpass variants), phase-aware subband resampling,
multiscale keypoint detection, and phase-based image/video registration —
one functional, jit-compiled, vmap-able, mesh-shardable code path instead of
swappable NumPy/OpenCL/TF backends.
"""

from dtcwt_tpu._version import __version__
from dtcwt_tpu.coeffs import biort, qshift, BIORT_NAMES, QSHIFT_NAMES
from dtcwt_tpu.transforms.pyramid import (
    Pyramid, PlanePyramid, PLANE_BAND_ORDER)
from dtcwt_tpu.transforms.transform1d import Transform1d
from dtcwt_tpu.transforms.transform2d import Transform2d

__all__ = [
    "__version__",
    "Pyramid", "PlanePyramid", "PLANE_BAND_ORDER",
    "Transform1d", "Transform2d", "Transform3d",
    "biort", "qshift", "BIORT_NAMES", "QSHIFT_NAMES",
    "backend_name", "push_backend", "pop_backend", "preserve_backend_stack",
]

# The reference exposes a mutable backend stack (numpy/opencl/tf).  There is
# exactly one backend here (XLA), but the stack API is preserved so code
# written against the reference keeps working; device/precision placement is
# owned by JAX (jax.default_device, jax.config) rather than by this switch.
# Parity surface: upstream dtcwt/__init__.py:50-143.
backend_name = "xla"


def __getattr__(name):
    if name == "Transform3d":
        from dtcwt_tpu.transforms.transform3d import Transform3d
        return Transform3d
    raise AttributeError(name)


def push_backend(name: str):
    """Compatibility no-op: the only backend is XLA ('xla').  Accepts the
    reference names for drop-in compatibility."""
    from dtcwt_tpu.compat_backend import push_backend as _pb
    _pb(name)


def pop_backend():
    from dtcwt_tpu.compat_backend import pop_backend as _pb
    _pb()


def preserve_backend_stack():
    from dtcwt_tpu.compat_backend import preserve_backend_stack as _pbs
    return _pbs()
