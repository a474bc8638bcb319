"""Device-resident HNSW graph state: structure of arrays in device memory.

Layout (cap = node capacity, Dp = dim padded to a multiple of 128, or
for packed bits the word count padded to a multiple of 8), the
same field names, dtypes and shapes as the JAX package's GraphState:

  vectors     [cap, Dp]        index copy of each vector in the store dtype:
                               f32 (normalized for cosine), int8, or packed
                               bit words held as int32 (the JAX package's
                               uint32, bit for bit)
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

import numpy as np
import torch

from tpuvec_torch.device import resolve
from tpuvec_torch.index.params import HnswParams
from tpuvec_torch.ops.distance import internal_needs_normalize
from tpuvec_torch.quantize import pack_bits_to_words, quantize_int8_for_index
from tpuvec_torch.types import DistanceMetric, IndexQuantization, VectorType

__all__ = [
    "HnswConfig", "GraphState", "allocate", "grow_state", "config_for", "prepare_vectors",
    "prepare_queries", "as_store_tensor",
]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


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
        """f32, int8, or int32 for packed bit words (uint32 in the JAX
        package: torch's uint32 has no indexing or shift kernels)."""
        if self.quantization is IndexQuantization.INT8:
            return torch.int8
        if self.quantization is IndexQuantization.BINARY:
            return torch.int32
        if self.vec_type is VectorType.FLOAT32:
            return torch.float32
        if self.vec_type is VectorType.INT8:
            return torch.int8
        return torch.int32  # BIT: packed words

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


def grow_state(state: GraphState, cap: int, cap_u: int) -> GraphState:
    """``state`` padded to ``cap`` node rows and ``cap_u`` upper slots, the
    new rows filled as ``allocate`` fills them (0 / -1 / +inf). The graph
    carries over: adjacency holds slot ids, which a larger capacity leaves
    as they are."""

    def pad_rows(t, rows, fill):
        out = torch.full((rows, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
        out[: t.shape[0]] = t
        return out

    inf = float("inf")
    s = state
    return GraphState(
        vectors=pad_rows(s.vectors, cap, 0),
        adj0=pad_rows(s.adj0, cap, -1),
        adj0_dist=pad_rows(s.adj0_dist, cap, inf),
        levels=pad_rows(s.levels, cap, -1),
        upper_slot=pad_rows(s.upper_slot, cap, -1),
        upper_nodes=pad_rows(s.upper_nodes, cap_u, -1),
        upper_adj=pad_rows(s.upper_adj, cap_u, -1),
        upper_dist=pad_rows(s.upper_dist, cap_u, inf),
        entry_point=s.entry_point,
        entry_level=s.entry_level,
        count=s.count,
        upper_count=s.upper_count,
    )


def as_store_tensor(v, *, device: str | torch.device = "cuda") -> torch.Tensor:
    """v (numpy or tensor) as a tensor on ``device``; uint32 words become
    int32 with the same bits (a view, never a value cast)."""
    if isinstance(v, np.ndarray) and v.dtype == np.uint32:
        v = v.view(np.int32)
    t = torch.as_tensor(v, device=resolve(device))
    if t.dtype == getattr(torch, "uint32", None):
        t = t.view(torch.int32)
    return t


def prepare_vectors(
    config: HnswConfig, v, *, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """Raw user vectors [B, dim] (numpy or tensor) -> index/store form
    [B, Dp] on ``device``: normalize-if-cosine, then quantize-for-index,
    zero-padded to Dp. Queries go through the same transform."""
    c = config
    dev = resolve(device)
    if c.vec_type is VectorType.BIT:
        # already packed words; pad to padded_dim
        w = as_store_tensor(v, device=dev).to(torch.int32)
        return torch.nn.functional.pad(w, (0, c.padded_dim - w.shape[-1]))

    vf = torch.as_tensor(v, device=dev).to(torch.float32)
    if c.normalized:
        norm = torch.linalg.vector_norm(vf, dim=-1, keepdim=True)
        ok = norm > 0
        vf = torch.where(ok, vf / torch.where(ok, norm, torch.ones_like(norm)), vf)

    if c.quantization is IndexQuantization.BINARY:
        d32 = _ceil_to(c.dim, 32)
        vf = torch.nn.functional.pad(vf, (0, d32 - vf.shape[-1]))
        # pad bits replicate the mean-threshold of real dims only, then
        # are zeroed
        mean = torch.mean(vf[:, : c.dim], dim=-1, keepdim=True)
        mask = (torch.arange(d32, device=dev) < c.dim)[None, :]
        words = pack_bits_to_words((vf >= mean) & mask)
        return torch.nn.functional.pad(words, (0, c.padded_dim - words.shape[-1]))

    pad = c.padded_dim - vf.shape[-1]
    vf = torch.nn.functional.pad(vf, (0, pad))
    if c.quantization is IndexQuantization.INT8:
        return quantize_int8_for_index(vf)
    if c.vec_type is VectorType.INT8:
        vi = torch.as_tensor(v, device=dev).to(torch.int8)
        return torch.nn.functional.pad(vi, (0, pad))
    return vf


# Queries use the identical transform.
prepare_queries = prepare_vectors
