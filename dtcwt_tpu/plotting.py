"""Plotting conveniences for DTCWT coefficients.

Parity surface: upstream ``dtcwt/plotting.py:15-72``
(``overlay_quiver``).  matplotlib is an optional dependency: importing this
module without it raises only when the plot function is called.
"""

from __future__ import absolute_import

import numpy as np

__all__ = ("overlay_quiver",)


def overlay_quiver(image, vectorField, level, offset):
    """Overlay a coloured quiver plot of complex subband coefficients on a
    grayscale image (values in [0, 255]) — a phase visualisation.

    :param image: grayscale background image, values in [0, 255]
    :param vectorField: an ``[M, N, 6]`` complex coefficient array
    :param level: 1-indexed transform level of *vectorField*
    :param offset: subband grid offset in units of ``2**level`` (typ. 0.5)
    :returns: the last quiver handle
    """
    import matplotlib.pyplot as plt
    from matplotlib import cm

    vectorField = np.array(vectorField)  # host copy (it is mutated below)
    plt.imshow(np.asarray(image), cmap=cm.gray, clim=(0, 255))

    rows, cols = vectorField.shape[0], vectorField.shape[1]
    g1, g2 = np.mgrid[0:rows, 0:cols]

    # 'spectral' was removed from modern matplotlib; nipy_spectral is its
    # successor with the same mapping.
    cmap = getattr(cm, "spectral", None) or cm.nipy_spectral
    scalefactor = np.abs(vectorField).max()
    vectorField[-1, -1, :] = scalefactor

    sc = 2 ** level
    hq = None
    for sb in range(vectorField.shape[2]):
        colour = cmap(sb / float(vectorField.shape[2]))
        hq = plt.quiver(g2 * sc + offset * sc, g1 * sc + offset * sc,
                        np.real(vectorField[:, :, sb]),
                        np.imag(vectorField[:, :, sb]),
                        color=colour, scale=scalefactor * sc)
        plt.quiverkey(hq, 1.05, 1.00 - 0.035 * sb, 0, "subband %d" % sb,
                      coordinates="axes", color=colour, labelcolor=colour,
                      labelpos="E")
    return hq
