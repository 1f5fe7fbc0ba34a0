"""Library-wide default wavelet families (reference:
upstream ``dtcwt/defaults.py:1-3``)."""

DEFAULT_BIORT = "near_sym_a"
DEFAULT_QSHIFT = "qshift_a"
