"""Halo exchange for spatially-sharded filter banks.

Every filter primitive consumes a symmetric extension of its input
(``symmetric_extend``); when the filtered axis is sharded across a mesh axis,
interior shard boundaries must be fed the *neighbouring shard's* edge samples
instead of a local reflection, while the two physical edges keep the
reflect-with-repeated-end-samples rule.  The exchange is a pair of
``lax.ppermute`` shifts over the mesh axis, which XLA lowers to
collective permutes between neighbouring shards (cf. the plan in SURVEY.md §2 "Parallelism inventory"; the
boundary rule being preserved is upstream ``dtcwt/utils.py:136-153``).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["halo_exchange"]


def _norm_axis(axis: int, ndim: int) -> int:
    return axis if axis >= 0 else axis + ndim


def _edge(x, n: int, axis: int, front: bool):
    r = x.shape[axis]
    sl = lax.slice_in_dim(x, 0, n, axis=axis) if front else \
        lax.slice_in_dim(x, r - n, r, axis=axis)
    return sl


def halo_exchange(x, n: int, axis_name: str, axis_size: int, axis: int = -2):
    """Extend the locally-sharded *axis* of *x* by *n* samples per side.

    Interior sides receive the neighbour shard's edge rows
    (``ppermute``); the first/last shard's outer side applies symmetric
    reflection of its own edge, reproducing the unsharded
    ``symmetric_extend(global_x, n)`` exactly.  Requires ``n`` not larger
    than the local axis length.  Must run inside ``shard_map`` over a mesh
    with axis *axis_name* of size *axis_size*.
    """
    axis = _norm_axis(axis, x.ndim)
    if n == 0:
        return x
    if n > x.shape[axis]:
        raise ValueError(
            "halo width %d exceeds local extent %d of axis %d; use fewer "
            "shards or gather the axis" % (n, x.shape[axis], axis))

    if axis_size == 1:
        # Degenerate mesh: plain symmetric extension.
        from dtcwt_tpu.ops.fb import symmetric_extend
        return symmetric_extend(x, n, axis)

    my_last = _edge(x, n, axis, front=False)
    my_first = _edge(x, n, axis, front=True)

    # Shard i receives i-1's trailing rows (its upper halo) and i+1's
    # leading rows (its lower halo).
    upper = lax.ppermute(my_last, axis_name,
                         [(i, i + 1) for i in range(axis_size - 1)])
    lower = lax.ppermute(my_first, axis_name,
                         [(i + 1, i) for i in range(axis_size - 1)])

    idx = lax.axis_index(axis_name)
    reflect_top = lax.rev(my_first, (axis,))
    reflect_bot = lax.rev(my_last, (axis,))
    top = jnp.where(idx == 0, reflect_top, upper)
    bot = jnp.where(idx == axis_size - 1, reflect_bot, lower)
    return jnp.concatenate([top, x, bot], axis=axis)
