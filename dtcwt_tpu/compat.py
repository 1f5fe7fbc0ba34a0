"""MATLAB-toolbox-style functional API.

Thin wrappers mirroring the reference compatibility layer
(upstream ``dtcwt/compat.py:32-288``): ``dtwavexfm``/``dtwaveifm``
(1-D), ``dtwavexfm2``/``dtwaveifm2`` (+ ``...2b`` aliases, 2-D) and
``dtwavexfm3``/``dtwaveifm3`` (3-D).  They unpack the :class:`Pyramid` into
``(Yl, Yh[, Yscale])`` tuples for script-style use.  Prefer the Transform
classes in new code — these wrappers rebuild the transform object per call.
"""

from __future__ import absolute_import

from dtcwt_tpu.transforms.pyramid import Pyramid
from dtcwt_tpu.transforms.transform1d import Transform1d
from dtcwt_tpu.transforms.transform2d import (
    DEFAULT_BIORT, DEFAULT_QSHIFT, Transform2d)
from dtcwt_tpu.transforms.transform3d import Transform3d

__all__ = [
    "dtwavexfm", "dtwaveifm",
    "dtwavexfm2", "dtwaveifm2", "dtwavexfm2b", "dtwaveifm2b",
    "dtwavexfm3", "dtwaveifm3",
]


def dtwavexfm(X, nlevels=3, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
              include_scale=False):
    """n-level 1-D DTCWT of a vector (or the columns of a matrix).
    Returns ``(Yl, Yh)`` or ``(Yl, Yh, Yscale)``."""
    res = Transform1d(biort, qshift).forward(X, nlevels, include_scale)
    if include_scale:
        return res.lowpass, res.highpasses, res.scales
    return res.lowpass, res.highpasses


def dtwaveifm(Yl, Yh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
              gain_mask=None):
    """Inverse of :func:`dtwavexfm`."""
    return Transform1d(biort, qshift).inverse(Pyramid(Yl, Yh),
                                              gain_mask=gain_mask)


def dtwavexfm2(X, nlevels=3, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               include_scale=False):
    """n-level 2-D DTCWT. Returns ``(Yl, Yh)`` or ``(Yl, Yh, Yscale)``."""
    res = Transform2d(biort, qshift).forward(X, nlevels, include_scale)
    if include_scale:
        return res.lowpass, res.highpasses, res.scales
    return res.lowpass, res.highpasses


def dtwaveifm2(Yl, Yh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               gain_mask=None):
    """Inverse of :func:`dtwavexfm2`."""
    return Transform2d(biort, qshift).inverse(Pyramid(Yl, Yh),
                                              gain_mask=gain_mask)


# The MATLAB toolbox's bandpass ('b') variants are folded into the main
# functions (select them via the wavelet names); aliases kept for script
# compatibility (reference compat.py:183-187).
dtwavexfm2b = dtwavexfm2
dtwaveifm2b = dtwaveifm2


def dtwavexfm3(X, nlevels=3, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               include_scale=False, ext_mode=4, discard_level_1=False):
    """n-level 3-D DTCWT with 28 directional subbands per level."""
    res = Transform3d(biort, qshift, ext_mode).forward(
        X, nlevels, include_scale, discard_level_1)
    if include_scale:
        return res.lowpass, res.highpasses, res.scales
    return res.lowpass, res.highpasses


def dtwaveifm3(Yl, Yh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               ext_mode=4):
    """Inverse of :func:`dtwavexfm3`."""
    return Transform3d(biort, qshift, ext_mode).inverse(Pyramid(Yl, Yh))
