"""Mesh-parallel indexes: corpus sharding with a top-k merge over shards."""

from tpuvec_torch.parallel.sharding import (
    ShardedHnsw,
    load_sharded,
    make_mesh,
    save_sharded,
)

__all__ = ["ShardedHnsw", "load_sharded", "make_mesh", "save_sharded"]
