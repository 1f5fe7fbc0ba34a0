"""Batch data-parallelism for any transform over a device mesh.

The reference TF backend's scaling story is "fold images into the batch
dimension" (upstream ``dtcwt/tf/transform2d.py:252-276``,
``docs/backends.rst``).  The JAX equivalent is one sharding
annotation: every transform here is batched over arbitrary leading axes, so
data parallelism is just placing the batch axis on a mesh axis and letting
XLA partition the program — no per-device code, no gather/scatter.

:class:`BatchSharded` wraps any of Transform1d/2d/3d (or in fact any object
with ``forward``/``inverse`` taking/returning pytrees whose leaves share a
leading batch axis).  Works on a multi-GPU host and on virtual CPU meshes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["BatchSharded", "shard_batch"]


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place every array leaf of *tree* with its leading axis sharded over
    *axis* of *mesh* (remaining axes replicated)."""
    def place(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(place, tree)


class BatchSharded:
    """Run a transform data-parallel over the ``axis`` mesh axis.

    >>> mesh = make_mesh((8,), ("data",))
    >>> t = BatchSharded(Transform2d(), mesh)
    >>> pyr = t.forward(frames, nlevels=3)      # frames: [N, H, W], N % 8 == 0
    >>> recon = t.inverse(pyr)

    The compiled program is identical to the single-device one; XLA
    partitions it over the batch axis with no cross-device communication
    (the transform is pointwise in the batch dimension).
    """

    def __init__(self, transform, mesh: Mesh, axis: str = "data"):
        self.transform = transform
        self.mesh = mesh
        self.axis = axis

    def _check(self, n: int):
        size = self.mesh.shape[self.axis]
        if n % size != 0:
            raise ValueError(
                "Batch size %d is not divisible by mesh axis %r of size %d"
                % (n, self.axis, size))

    def forward(self, X, *args, **kwargs):
        X = jnp.asarray(X)
        self._check(X.shape[0])
        X = shard_batch(X, self.mesh, self.axis)
        return self.transform.forward(X, *args, **kwargs)

    def inverse(self, pyramid, *args, **kwargs):
        pyramid = shard_batch(pyramid, self.mesh, self.axis)
        return self.transform.inverse(pyramid, *args, **kwargs)
