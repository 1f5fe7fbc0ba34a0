"""Multi-chip execution: device meshes, halo exchange, sharded transforms.

The reference library is single-device (its only distributed component is an
MPI scatter/gather example, upstream ``examples/register_video.py``).
Here parallelism is first-class: batch data-parallelism and spatial
row-sharding over a ``jax.sharding.Mesh``, with filter-support halos
exchanged between neighbouring shards via ``lax.ppermute`` and global
reductions via ``psum``.
"""

from dtcwt_tpu.parallel.mesh import make_mesh
from dtcwt_tpu.parallel.halo import halo_exchange
from dtcwt_tpu.parallel.transform2d_dist import ShardedTransform2d
from dtcwt_tpu.parallel.batch import BatchSharded, shard_batch
from dtcwt_tpu.parallel.transform1d_dist import ShardedTransform1d
from dtcwt_tpu.parallel.transform3d_dist import ShardedTransform3d
from dtcwt_tpu.parallel.registration_dist import (estimatereg_sharded,
                                                  shard_pyramid_rows)

__all__ = ["make_mesh", "halo_exchange", "ShardedTransform1d",
           "ShardedTransform2d", "ShardedTransform3d", "BatchSharded",
           "shard_batch", "estimatereg_sharded", "shard_pyramid_rows"]
