"""Exact (ENN) brute-force k-NN: tiled matrix product + running top-k.

Distances for a whole [B queries x chunk] tile come from one product
(exact integer products for int8 rows and, through the +-1 expansion, for
packed words under Hamming), and the running top-k is merged per chunk
with ``torch.topk``. Doubles as the
ground-truth oracle for HNSW recall, and as the exact upper-level
neighbor selection of the build.
"""

from __future__ import annotations

import torch

from tpuvec_torch.ops.distance import internal_pairwise, internal_to_output
from tpuvec_torch.types import DistanceMetric

__all__ = ["bruteforce_knn", "bruteforce_knn_internal"]

_INF = float("inf")


def bruteforce_knn_internal(
    q: torch.Tensor,
    x: torch.Tensor,
    valid: torch.Tensor,
    *,
    metric: DistanceMetric,
    k: int,
    chunk: int = 16384,
    normalized: bool = False,
    slot_codes: torch.Tensor | None = None,
    q_codes: torch.Tensor | None = None,
):
    """Exact k-NN in *internal* distance space.

    q [B, D]; x [N, D] (padded rows allowed: mask them via `valid`);
    valid [N] bool. Returns (internal_dists [B, k] ascending, ids [B, k]
    i32); masked and missing slots come back as (+inf, -1).

    ``slot_codes`` i32 [N] with ``q_codes`` i32 [B] filter per query in the
    same scan (multi-tenant serving: each query its own partition): row n
    is eligible for query b iff slot_codes[n] == q_codes[b]. Rows with no
    code hold -1; a query code of -2 matches nothing.
    """
    if (slot_codes is None) != (q_codes is None):
        raise ValueError("bruteforce_knn_internal: slot_codes and q_codes go together")
    b = q.shape[0]
    n = x.shape[0]
    run_d = torch.full((b, k), _INF, dtype=torch.float32, device=q.device)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for start in range(0, n, chunk):
        d = internal_pairwise(metric, q, x[start : start + chunk], normalized=normalized)
        d = torch.where(valid[start : start + chunk][None, :], d, _INF)
        if slot_codes is not None:
            same = slot_codes[start : start + chunk][None, :] == q_codes[:, None]
            d = torch.where(same, d, _INF)
        cd, ci = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
        run_d, pos = torch.topk(
            torch.cat([run_d, cd], dim=1), k, dim=1, largest=False, sorted=True
        )
        run_i = torch.gather(torch.cat([run_i, ci + start], dim=1), 1, pos)
    run_i = torch.where(torch.isfinite(run_d), run_i, -1)
    return run_d, run_i.to(torch.int32)


def bruteforce_knn(
    q: torch.Tensor,
    x: torch.Tensor,
    valid: torch.Tensor,
    *,
    metric: DistanceMetric,
    k: int,
    chunk: int = 16384,
    normalized: bool = False,
):
    """Exact k-NN returning user-metric distances (ascending) and ids."""
    d, i = bruteforce_knn_internal(
        q, x, valid, metric=metric, k=k, chunk=chunk, normalized=normalized
    )
    out = internal_to_output(metric, d, normalized=normalized)
    return torch.where(torch.isfinite(d), out, _INF), i
