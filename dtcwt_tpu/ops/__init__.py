"""Low-level compute primitives (filter banks, subband packing)."""

from dtcwt_tpu.ops.fb import (
    colfilter, rowfilter, coldfilt, rowdfilt, colifilt, rowifilt,
    filter_axis, dfilt_axis, ifilt_axis, symmetric_extend,
)
from dtcwt_tpu.ops.packing import q2c, c2q, q2c1d, c2q1d

__all__ = [
    "colfilter", "rowfilter", "coldfilt", "rowdfilt", "colifilt", "rowifilt",
    "filter_axis", "dfilt_axis", "ifilt_axis", "symmetric_extend",
    "q2c", "c2q", "q2c1d", "c2q1d",
]
