from .data import data_iterator, global_batch
from .halo import ShardedEllpack, shard_ellpack, shard_ellpack_cached
from .mesh import Mesh, NamedSharding, P, batch_sharding, make_mesh, replicated
from .sharded_ops import ShardConfig, sharded_poly_conv

__all__ = [
    "global_batch",
    "data_iterator",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "Mesh",
    "NamedSharding",
    "P",
    "ShardConfig",
    "sharded_poly_conv",
    "ShardedEllpack",
    "shard_ellpack",
    "shard_ellpack_cached",
]
