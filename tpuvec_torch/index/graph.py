"""Device-resident HNSW graph state: structure of arrays in device memory.

Layout (cap = node capacity, Dp = dim padded to a multiple of 128), the
same field names, dtypes and shapes as the JAX package's GraphState:

  vectors     [cap, Dp]        index copy of each vector (normalized for
                               cosine)
  adj0        i32 [cap, M0]    level-0 adjacency, -1 padded
  adj0_dist   f32 [cap, M0]    stored internal edge distances
  levels      i32 [cap]        node level; -1 = absent
  upper_slot  i32 [cap]        compact-slot id for nodes with level >= 1
  upper_nodes i32 [cap_u]      slot -> node id (-1 = unused)
  upper_adj   i32 [cap_u, LU*M]   adjacency at levels 1..LU (level l at
  upper_dist  f32 [cap_u, LU*M]   columns [(l-1)*M, l*M))
  entry_point / entry_level / count / upper_count   0-d i32 tensors

Only ~1/M of nodes have level >= 1, so the upper graph is stored compactly
(cap_u = cap/8 slots) and construction selects upper-level neighbors by
an exact scan over all upper nodes. The build updates these tensors in
place.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuvec_torch.device import resolve
from tpuvec_torch.index.params import HnswParams
from tpuvec_torch.ops.distance import internal_needs_normalize
from tpuvec_torch.types import DistanceMetric, IndexQuantization, VectorType

__all__ = [
    "HnswConfig", "GraphState", "allocate", "config_for", "prepare_vectors",
    "prepare_queries",
]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _float_path_only(vec_type: VectorType, quantization: IndexQuantization) -> None:
    if vec_type is not VectorType.FLOAT32 or quantization is not IndexQuantization.NONE:
        raise NotImplementedError(
            f"{vec_type.value} vectors with {quantization.value} index quantization "
            "are not ported yet; only float32 without quantization is"
        )


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Static graph configuration."""

    dim: int                      # logical dimensions
    padded_dim: int               # storage width
    metric: DistanceMetric
    vec_type: VectorType          # user element type
    quantization: IndexQuantization
    normalized: bool              # index copy is L2-normalized (cosine trick)
    cap: int
    cap_u: int
    m: int
    max_m0: int
    lu: int                       # number of stored upper levels
    ef_construction: int
    ef_search: int
    rng_seed: int
    level_factor: float
    simple_prune: bool = False    # False = RNG diversity heuristic
    build_max_iters: int | None = None  # construction-beam iteration cap

    @property
    def store_dtype(self) -> torch.dtype:
        _float_path_only(self.vec_type, self.quantization)
        return torch.float32

    @property
    def internal_metric_is_hamming(self) -> bool:
        return (
            self.vec_type is VectorType.BIT
            or self.quantization is IndexQuantization.BINARY
        )

    @property
    def graph_metric(self) -> DistanceMetric:
        """Metric used for internal graph distances."""
        if self.internal_metric_is_hamming:
            return DistanceMetric.HAMMING
        return self.metric


def config_for(
    dim: int,
    *,
    metric: DistanceMetric = DistanceMetric.COSINE,
    vec_type: VectorType = VectorType.FLOAT32,
    quantization: IndexQuantization = IndexQuantization.NONE,
    params: HnswParams | None = None,
    cap: int = 1024,
) -> HnswConfig:
    """Build an HnswConfig (default metric cosine). Rounds cap, cap_u and
    the padded width exactly as the JAX package does."""
    params = params or HnswParams()
    params.validate()
    if vec_type is VectorType.BIT or quantization is IndexQuantization.BINARY:
        padded = _ceil_to(_ceil_to(max(dim, 1), 32) // 32, 8)  # packed uint32 words
    else:
        padded = _ceil_to(dim, 128)
    cap = max(_ceil_to(cap, 128), 128)
    cap_u = max(_ceil_to(cap // 8, 128), 128)
    lu = min(6, params.max_level)
    return HnswConfig(
        dim=dim,
        padded_dim=padded,
        metric=metric,
        vec_type=vec_type,
        quantization=quantization,
        normalized=(
            internal_needs_normalize(metric, vec_type)
            and quantization is not IndexQuantization.BINARY
        ),
        cap=cap,
        cap_u=cap_u,
        m=params.m,
        max_m0=params.max_m0,
        lu=lu,
        ef_construction=params.ef_construction,
        ef_search=params.ef_search,
        rng_seed=params.rng_seed,
        level_factor=params.level_factor,
        simple_prune=params.simple_prune,
        build_max_iters=params.build_max_iters,
    )


@dataclasses.dataclass
class GraphState:
    vectors: torch.Tensor       # [cap, Dp] store dtype
    adj0: torch.Tensor          # [cap, M0] i32
    adj0_dist: torch.Tensor     # [cap, M0] f32
    levels: torch.Tensor        # [cap] i32 (-1 absent)
    upper_slot: torch.Tensor    # [cap] i32 (-1 none)
    upper_nodes: torch.Tensor   # [cap_u] i32 (-1 unused)
    upper_adj: torch.Tensor     # [cap_u, LU*M] i32
    upper_dist: torch.Tensor    # [cap_u, LU*M] f32
    entry_point: torch.Tensor   # [] i32
    entry_level: torch.Tensor   # [] i32
    count: torch.Tensor         # [] i32
    upper_count: torch.Tensor   # [] i32


def allocate(config: HnswConfig, *, device: str | torch.device = "cuda") -> GraphState:
    """Fresh empty graph on ``device``."""
    c = config
    dev = resolve(device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    i32 = torch.int32
    return GraphState(
        vectors=torch.zeros((c.cap, c.padded_dim), dtype=c.store_dtype, device=dev),
        adj0=full((c.cap, c.max_m0), -1, i32),
        adj0_dist=full((c.cap, c.max_m0), float("inf"), torch.float32),
        levels=full((c.cap,), -1, i32),
        upper_slot=full((c.cap,), -1, i32),
        upper_nodes=full((c.cap_u,), -1, i32),
        upper_adj=full((c.cap_u, c.lu * c.m), -1, i32),
        upper_dist=full((c.cap_u, c.lu * c.m), float("inf"), torch.float32),
        entry_point=full((), -1, i32),
        entry_level=full((), -1, i32),
        count=full((), 0, i32),
        upper_count=full((), 0, i32),
    )


def prepare_vectors(
    config: HnswConfig, v, *, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """Raw user vectors [B, dim] (numpy or tensor) -> index/store form
    [B, Dp] on ``device``: normalized if cosine, zero-padded to Dp.
    Queries go through the same transform."""
    c = config
    _float_path_only(c.vec_type, c.quantization)
    dev = resolve(device)
    vf = torch.as_tensor(v, dtype=torch.float32, device=dev)
    if c.normalized:
        norm = torch.linalg.vector_norm(vf, dim=-1, keepdim=True)
        ok = norm > 0
        vf = torch.where(ok, vf / torch.where(ok, norm, torch.ones_like(norm)), vf)
    return torch.nn.functional.pad(vf, (0, c.padded_dim - vf.shape[-1]))


# Queries use the identical transform.
prepare_queries = prepare_vectors
