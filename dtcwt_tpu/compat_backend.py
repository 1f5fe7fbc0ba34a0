"""Backend-stack compatibility layer.

The reference library dispatches between numpy/opencl/tf backends with a
mutable module-attribute stack (upstream ``dtcwt/__init__.py:50-131``).
This framework has one backend — XLA — so the stack is retained purely as an
API-compatible shim: pushing any known backend name succeeds and is recorded,
popping the base entry raises, and :func:`preserve_backend_stack` restores
the stack on exit even when the body raises.
"""

from __future__ import annotations

import contextlib

__all__ = ["backend_name", "push_backend", "pop_backend",
           "preserve_backend_stack", "KNOWN_BACKENDS"]

KNOWN_BACKENDS = ("xla", "numpy", "opencl", "tf")

_STACK = ["xla"]


def backend_name() -> str:
    return _STACK[-1]


def push_backend(name: str):
    if name not in KNOWN_BACKENDS:
        raise KeyError("No such backend: {!r}".format(name))
    _STACK.append(name)
    _sync()


def pop_backend():
    if len(_STACK) == 1:
        raise IndexError("Cannot pop base backend")
    _STACK.pop()
    _sync()


@contextlib.contextmanager
def preserve_backend_stack():
    saved = list(_STACK)
    try:
        yield
    finally:
        _STACK[:] = saved
        _sync()


def _sync():
    import dtcwt_tpu
    dtcwt_tpu.backend_name = _STACK[-1]
