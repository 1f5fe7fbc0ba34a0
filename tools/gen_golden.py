"""Regenerate the golden verification summaries from the upstream test images.

The upstream test suite compares against ``tests/verification.npz``, a file
of MATLAB-derived *summary matrices* rebuilt by ``matlab/regen_verification.sh``
(upstream ``matlab/gen_verif.m:26-71``).  Without a MATLAB installation the
practical re-derivation (SURVEY.md section 4) is to run a plain NumPy
implementation of the transform over exactly the same inputs and store the
same summary keys.  This script does that with ``tests/reference_np.py``;
the output is committed at ``tests/golden/verification.npz`` and consumed by
``tests/test_golden.py``.  The input images (``mandrill.npz``, ``qbgn.npz``
from the upstream ``tests/`` directory) are not part of this repository.

Run from the repo root:  python tools/gen_golden.py <dir with the images>
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests import reference_np as R  # noqa: E402
from tests.oracle import summarise_mat, summarise_cube  # noqa: E402


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    refdir = sys.argv[1]
    mandrill = np.load(os.path.join(refdir, "mandrill.npz"))["mandrill"]
    mandrill = mandrill.astype(np.float64)
    qbgn = np.load(os.path.join(refdir, "qbgn.npz"))["qbgn"].astype(np.float64)

    out = {}

    # Dual filters with the longest published family (gen_verif.m:33-36)
    h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b = R.qshift("qshift_d")
    out["mandrill_coldfilt"] = summarise_mat(R.coldfilt(mandrill, h1b, h1a))
    out["mandrill_colifilt"] = summarise_mat(R.colifilt(mandrill, g0b, g0a))

    # 4-level standard 2-D transform (gen_verif.m:38-44)
    Yl, Yh, Yscale = R.Transform2d("near_sym_a", "qshift_a").forward(
        mandrill, 4, include_scale=True)
    out["mandrill_Yl"] = summarise_mat(Yl)
    for i, a in enumerate(Yh):
        out["mandrill_Yh_%d" % i] = summarise_mat(a)
    for i, a in enumerate(Yscale):
        out["mandrill_Yscale_%d" % i] = summarise_mat(a)

    # 4-level bandpass (rotationally symmetric) variant (gen_verif.m:46-52)
    Ylb, Yhb, Yscaleb = R.Transform2d("near_sym_b_bp", "qshift_b_bp").forward(
        mandrill, 4, include_scale=True)
    out["mandrill_Ylb"] = summarise_mat(Ylb)
    for i, a in enumerate(Yhb):
        out["mandrill_Yhb_%d" % i] = summarise_mat(a)
    for i, a in enumerate(Yscaleb):
        out["mandrill_Yscaleb_%d" % i] = summarise_mat(a)

    # x3 bilinear highpass rescale (gen_verif.m:54-58 / cpxinterp2b)
    X = R.Transform2d("near_sym_a", "qshift_a").forward(mandrill, 3)[1][2]
    out["mandrill_upsample"] = summarise_mat(
        R.rescale_highpass(X, (X.shape[0] * 3, X.shape[1] * 3), "bilinear"))

    # 3-level 3-D transform on the qbgn volume (gen_verif.m:60-71)
    t3 = R.Transform3d(biort="near_sym_b", qshift="qshift_b")
    p3 = t3.forward(qbgn, nlevels=3, include_scale=True)
    out["qbgn_Yl"] = summarise_cube(p3.lowpass)
    for i, a in enumerate(p3.highpasses):
        out["qbgn_Yh_%d" % i] = summarise_cube(a)
    for i, a in enumerate(p3.scales):
        out["qbgn_Yscale_%d" % i] = summarise_cube(a)

    dest = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                        "verification.npz")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    np.savez_compressed(dest, **out)
    print("wrote %s with %d keys" % (dest, len(out)))


if __name__ == "__main__":
    main()
