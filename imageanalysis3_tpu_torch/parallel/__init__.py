"""Process-group parallelism: the data mesh, the per-rank input pipeline
and (``parallel.spatial``) one FOV sharded along x over the ranks."""

from .mesh import make_mesh, data_sharding
from .input_pipeline import (shard_fovs, FovPrefetcher, PrefetchItem,
                             assemble_global_batch, prefetch_to_device)

__all__ = ["make_mesh", "data_sharding",
           "shard_fovs", "FovPrefetcher", "PrefetchItem",
           "assemble_global_batch", "prefetch_to_device"]
