"""Golden-data verification: summary matrices for the MATLAB toolbox cases.

Mirrors the upstream ``tests/test_againstmatlab.py`` (summary-matrix scheme
described at :15-35, tolerance 1e-5 at :38).  The golden file
``tests/golden/verification.npz`` holds summaries computed from the upstream
test images (mandrill, the qbgn volume).  Those image files are not part of
this repository, so every case that needs one skips with that reason; the
same transforms are checked against the NumPy reference on synthetic inputs
in test_transform2d/3d and test_fb_vs_reference.
"""

import os

import numpy as np
import pytest

import dtcwt_tpu as dt
from dtcwt_tpu.compat import dtwavexfm2, dtwavexfm2b
from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops.fb import coldfilt, colifilt
from dtcwt_tpu.sampling import rescale_highpass

from tests.oracle import summarise_mat, summarise_cube

TOLERANCE = 1e-5

needs_image = pytest.mark.skip(
    reason="golden summaries were computed from the upstream mandrill/qbgn "
           "image files, which this repository does not ship")


def mandrill():
    raise AssertionError("unreachable: mandrill golden cases are skipped")


qbgn = mandrill

_VERIF = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "verification.npz"))


def _close_to_summary(a, key, tol=TOLERANCE):
    got = summarise_mat(np.asarray(a))
    want = _VERIF[key]
    assert got.shape == want.shape, (key, got.shape, want.shape)
    md = float(np.abs(got - want).max())
    assert md <= tol, "%s differs by %g > %g" % (key, md, tol)


def _close_to_summary_cube(a, key, tol=TOLERANCE):
    got = summarise_cube(np.asarray(a))
    want = _VERIF[key]
    assert got.shape == want.shape, (key, got.shape, want.shape)
    md = float(np.abs(got - want).max())
    assert md <= tol, "%s differs by %g > %g" % (key, md, tol)


def test_verif_loaded():
    assert "mandrill_coldfilt" in _VERIF


@needs_image
def test_coldfilt():
    q = qshift("qshift_d")
    h1a, h1b = q[4], q[5]
    _close_to_summary(coldfilt(mandrill(), h1b, h1a), "mandrill_coldfilt")


@needs_image
def test_colifilt():
    q = qshift("qshift_d")
    g0a, g0b = q[2], q[3]
    _close_to_summary(colifilt(mandrill(), g0b, g0a), "mandrill_colifilt")


@needs_image
def test_dtwavexfm2():
    Yl, Yh, Yscale = dtwavexfm2(mandrill(), 4, "near_sym_a", "qshift_a",
                                include_scale=True)
    _close_to_summary(Yl, "mandrill_Yl")
    for i, a in enumerate(Yh):
        _close_to_summary(a, "mandrill_Yh_%d" % i)
    for i, a in enumerate(Yscale):
        _close_to_summary(a, "mandrill_Yscale_%d" % i)


@needs_image
def test_dtwavexfm2b():
    Yl, Yh, Yscale = dtwavexfm2b(mandrill(), 4, "near_sym_b_bp",
                                 "qshift_b_bp", include_scale=True)
    _close_to_summary(Yl, "mandrill_Ylb")
    for i, a in enumerate(Yh):
        _close_to_summary(a, "mandrill_Yhb_%d" % i)
    for i, a in enumerate(Yscale):
        _close_to_summary(a, "mandrill_Yscaleb_%d" % i)


@needs_image
def test_rescale_highpass():
    Yl, Yh = dtwavexfm2b(mandrill(), 3, "near_sym_a", "qshift_a")
    X = np.asarray(Yh[2])
    up = rescale_highpass(X, (X.shape[0] * 3, X.shape[1] * 3), "bilinear")
    got = summarise_mat(np.asarray(up))
    want = _VERIF["mandrill_upsample"]
    # Percentile comparison as in the reference (interpolation differences
    # can move individual pixels; test_againstmatlab.py:110-118).
    md = float(np.percentile(np.abs(got - want), 60))
    assert md <= TOLERANCE


@needs_image
def test_transform3d():
    t3 = dt.Transform3d(biort="near_sym_b", qshift="qshift_b")
    p = t3.forward(qbgn(), nlevels=3, include_scale=True)
    _close_to_summary_cube(p.lowpass, "qbgn_Yl")
    for i, a in enumerate(p.highpasses):
        _close_to_summary_cube(a, "qbgn_Yh_%d" % i)
    for i, a in enumerate(p.scales):
        _close_to_summary_cube(a, "qbgn_Yscale_%d" % i)
