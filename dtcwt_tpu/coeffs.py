"""Named wavelet coefficient tables for the DTCWT.

The numeric filter tables (``data/*.npz``) are Nick Kingsbury's published
wavelet coefficients, identical to the ones shipped by the reference library
(parity surface: upstream ``dtcwt/coeffs.py:27-90``).  They are loaded
once per process and returned as immutable numpy float64 arrays; inside the
transforms they become trace-time constants, so every data-dependent branch in
the reference (filter-parity tests, ``sum(ha*hb)`` sign checks) resolves at
JIT trace time here.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

__all__ = ["biort", "qshift", "BIORT_NAMES", "QSHIFT_NAMES"]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

#: Names accepted by :func:`biort` (level-1 odd-length biorthogonal banks).
BIORT_NAMES = ("antonini", "legall", "near_sym_a", "near_sym_b", "near_sym_b_bp")

#: Names accepted by :func:`qshift` (level>=2 quarter-shift even-length banks).
QSHIFT_NAMES = ("qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
                "qshift_b_bp", "qshift_32")

_BIORT_KEYS = ("h0o", "g0o", "h1o", "g1o")
_BIORT_BP_KEYS = _BIORT_KEYS + ("h2o", "g2o")
_QSHIFT_KEYS = ("h0a", "h0b", "g0a", "g0b", "h1a", "h1b", "g1a", "g1b")
_QSHIFT_BP_KEYS = _QSHIFT_KEYS + ("h2a", "h2b", "g2a", "g2b")


@functools.lru_cache(maxsize=None)
def _load_npz(name: str):
    path = os.path.join(_DATA_DIR, name + ".npz")
    if not os.path.exists(path):
        raise IOError("Unknown wavelet family: {!r}".format(name))
    with np.load(path) as f:
        return {k: np.array(f[k], dtype=np.float64) for k in f.files
                if not k.startswith("__")}


@functools.lru_cache(maxsize=None)
def _load(name: str, keys: Tuple[str, ...]):
    tab = _load_npz(name)
    try:
        out = tuple(tab[k] for k in keys)
    except KeyError as e:
        raise ValueError(
            "Wavelet {!r} does not define coefficient {}".format(name, e))
    for a in out:
        a.setflags(write=False)
    return out


def biort(name: str):
    """Load a level-1 (biorthogonal, odd-length) filter bank by name.

    Returns ``(h0o, g0o, h1o, g1o)`` column vectors, or the six-tuple
    ``(h0o, g0o, h1o, g1o, h2o, g2o)`` for the rotationally-symmetric
    bandpass variant ``near_sym_b_bp``.
    """
    if name == "near_sym_b_bp":
        return _load(name, _BIORT_BP_KEYS)
    if name in ("qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
                "qshift_b_bp", "qshift_32"):
        raise ValueError("{!r} is a qshift wavelet, not a biort one".format(name))
    return _load(name, _BIORT_KEYS)


def qshift(name: str):
    """Load a level>=2 (quarter-sample-shift, even-length) filter bank by name.

    Returns ``(h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b)`` column vectors, or
    the twelve-tuple with ``(h2a, h2b, g2a, g2b)`` appended for the bandpass
    variant ``qshift_b_bp``.
    """
    if name == "qshift_b_bp":
        return _load(name, _QSHIFT_BP_KEYS)
    if name in ("antonini", "legall", "near_sym_a", "near_sym_b",
                "near_sym_b_bp"):
        raise ValueError("{!r} is a biort wavelet, not a qshift one".format(name))
    return _load(name, _QSHIFT_KEYS)
