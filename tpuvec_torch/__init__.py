"""tpuvec_torch: the tpuvec HNSW vector index in PyTorch, with its
level-0 beam update as a hand-written CUDA kernel for Hopper.

The JAX package ``tpuvec`` is the reference; this package keeps its module
and public names and imports nothing of it.

Public surface:
    tpuvec_torch.types      -- VectorType / DistanceMetric / IndexQuantization / errors
    tpuvec_torch.codec      -- JSON <-> little-endian blob codecs
    tpuvec_torch.quantize   -- int8 / binary quantizers
    tpuvec_torch.ops        -- distances, the beam kernels, rerank
    tpuvec_torch.index      -- HNSW build / search / delete + the exact scan
    tpuvec_torch.store      -- VecTable + snapshots, followers, autosave
    tpuvec_torch.parallel   -- ShardedHnsw over a mesh of shards + its snapshots
    tpuvec_torch.sql        -- the vec0 SQL dialect: Database, vec_* functions
"""

from tpuvec_torch.types import (
    DistanceMetric,
    IndexQuantization,
    VectorType,
    TpuVecError,
    DimensionMismatch,
    InvalidVectorFormat,
    InvalidVectorType,
    InvalidDistanceMetric,
    InvalidParameter,
    InvalidState,
)

__version__ = "0.1.0"

__all__ = [
    "DistanceMetric",
    "IndexQuantization",
    "VectorType",
    "TpuVecError",
    "DimensionMismatch",
    "InvalidVectorFormat",
    "InvalidVectorType",
    "InvalidDistanceMetric",
    "InvalidParameter",
    "InvalidState",
    "__version__",
]
