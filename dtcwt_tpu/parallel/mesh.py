"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "rows"),
              devices=None) -> Mesh:
    """Build a :class:`jax.sharding.Mesh` over the available devices.

    ``shape=None`` puts every device on the leading (batch/data) axis.  The
    canonical layout for the sharded transforms is ``('data', 'rows')``:
    batch-parallel over ``data``, image rows spatially sharded over ``rows``.
    The cards of one GPU host are joined all to all, so the mesh shape
    follows the algorithm, not a physical ring.
    """
    devices = list(jax.devices() if devices is None else devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError("Mesh shape %r does not match %d devices"
                         % (shape, len(devices)))
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))
