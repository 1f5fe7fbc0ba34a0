"""Test oracle: the plain NumPy reference (``tests/reference_np.py``) plus
seeded synthetic stand-ins for the upstream test images.

The upstream suite drew its inputs from image files (mandrill, a quantized
band-limited noise volume, traffic frames).  Those files are not part of
this repository, so the tests here use generated inputs of the same kind:
a textured 512x512 image, a band-limited noise volume and a smooth frame
pair related by a known shift.  Golden cases whose expected values were
computed from the original files skip with a reason (``test_golden.py``).
"""

import numpy as np

from tests import reference_np as ref  # noqa: F401  (re-exported)


def _band_limited(shape, sigma, rng):
    """White noise low-passed by a Gaussian of *sigma* cycles/sample."""
    spec = np.fft.fftn(rng.rand(*shape))
    r2 = sum(np.fft.fftfreq(n).reshape((-1,) + (1,) * (len(shape) - 1 - i))
             ** 2 for i, n in enumerate(shape))
    out = np.real(np.fft.ifftn(spec * np.exp(-r2 / (2 * sigma ** 2))))
    return (out - out.min()) / (out.max() - out.min())


def textured_image(shape=(512, 512), seed=0):
    """Textured float64 image in [0, 1]: a smooth field plus finer detail,
    so every subband of every level carries energy."""
    rng = np.random.RandomState(seed)
    x = (0.7 * _band_limited(shape, 0.02, rng)
         + 0.3 * _band_limited(shape, 0.15, rng))
    return (x - x.min()) / (x.max() - x.min())


def mandrill():
    """The 512x512 test image used where the upstream suite used mandrill."""
    return textured_image((512, 512), seed=0)


def qbgn(n=32, seed=0):
    """Quantized band-limited Gaussian noise volume, n^3, integer levels."""
    rng = np.random.RandomState(seed)
    return np.round(255 * _band_limited((n, n, n), 0.1, rng))


def smooth_pair(shape=(256, 384), shift=(3, 2), seed=3, sigma=0.02):
    """A smooth random frame and the same frame rolled by *shift* pixels —
    the structure a phase-based registration can lock onto."""
    f1 = _band_limited(shape, sigma, np.random.RandomState(seed))
    return f1, np.roll(f1, shift, axis=(0, 1))


def summarise_mat(M, apron=8):
    """Summary matrix: keep the four apron-sized corners exactly, replace
    edge strips by their means along the interior axis and the interior by
    its scalar mean — the MATLAB-verification storage scheme of the
    upstream suite."""
    M = np.asarray(M)
    c = M[apron:-apron, apron:-apron, ...]
    centre = c.mean(axis=0, keepdims=True).mean(axis=1, keepdims=True)[0, 0]
    top = M[:apron, apron:-apron, ...].mean(axis=1)
    bot = M[-apron:, apron:-apron, ...].mean(axis=1)
    left = M[apron:-apron, :apron, ...].mean(axis=0)
    right = M[apron:-apron, -apron:, ...].mean(axis=0)
    return np.vstack((
        np.hstack((M[:apron, :apron, ...], top[:, None, ...],
                   M[:apron, -apron:, ...])),
        np.hstack((left[None, :, ...], centre[None, None, ...],
                   right[None, :, ...])),
        np.hstack((M[-apron:, :apron, ...], bot[:, None, ...],
                   M[-apron:, -apron:, ...])),
    ))


def summarise_cube(M, apron=4):
    """Per-plane :func:`summarise_mat` over the third axis."""
    M = np.asarray(M)
    return np.dstack([summarise_mat(M[:, :, i, ...], apron)
                      for i in range(M.shape[2])])
