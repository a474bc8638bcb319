"""Device-side exact rerank for coarse (binary / int8) search results: the
port of ``tpuvec/ops/rerank.py``.

The coarse candidate slots stay on the device: one gather from a
device-resident shadow of the original vectors (f32, or int8 cast to f32),
the distance in the *user* metric, and a stable sort for the top k. No
candidate matrix crosses to the host. Plain torch: the JAX package
computes this in XLA.
"""

from __future__ import annotations

import torch

from tpuvec_torch.types import DistanceMetric
from tpuvec_torch.utils import timing

__all__ = ["rerank_topk", "expand_rerank_topk"]

_INF = float("inf")
_SENTINEL = 2**31 - 1

# Past this many bytes of gathered [B, C, D] f32 candidates, the candidate
# axis is processed in chunks (the JAX package's default,
# TPUVEC_RERANK_CHUNK_MB=512): the result is the same, the working set one
# chunk.
RERANK_CHUNK_BYTES = 512 << 20


def _exact_dists(shadow, slots, ok, qf, metric: DistanceMetric):
    """Exact distances in the user metric over gathered candidate rows:
    [B, C] (invalid -> inf), chunked over C past ``RERANK_CHUNK_BYTES``."""
    b, c = slots.shape
    d = shadow.shape[1]
    limit = RERANK_CHUNK_BYTES
    if b * c * d * 4 > limit:
        cw = max(128, limit // (b * d * 4))
        if cw < c:
            return torch.cat(
                [
                    _exact_dists_block(shadow, slots[:, s : s + cw], ok[:, s : s + cw], qf, metric)
                    for s in range(0, c, cw)
                ],
                dim=1,
            )
    return _exact_dists_block(shadow, slots, ok, qf, metric)


def _exact_dists_block(shadow, slots, ok, qf, metric: DistanceMetric):
    with timing.span("rerank.gather", device=shadow):
        corpus = shadow[slots.clamp_min(0)].to(torch.float32)  # [B, C, D]
    qf = qf.to(torch.float32)
    if metric is DistanceMetric.L2:
        diff = corpus - qf[:, None, :]
        dd = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 0.0))
    elif metric is DistanceMetric.L1:
        dd = (corpus - qf[:, None, :]).abs().sum(-1)
    else:  # cosine distance on raw vectors
        dots = torch.bmm(corpus, qf[:, :, None])[:, :, 0]
        cn = torch.sqrt((corpus * corpus).sum(-1))
        qn = torch.sqrt((qf * qf).sum(-1))[:, None]
        dd = 1.0 - dots / torch.clamp_min(cn * qn, 1e-30)
    return torch.where(ok, dd, _INF)


def _smallest(d, ids, k: int):
    """The k smallest (d, id) pairs per row, ascending (stable), padded
    with (+inf, -1) when a row holds fewer than k; ids -1 past the finite."""
    sd, order = torch.sort(d, dim=1, stable=True)
    si = torch.gather(ids, 1, order)
    if sd.shape[1] < k:
        pad = k - sd.shape[1]
        sd = torch.nn.functional.pad(sd, (0, pad), value=_INF)
        si = torch.nn.functional.pad(si, (0, pad), value=-1)
    sd, si = sd[:, :k], si[:, :k]
    return sd, torch.where(torch.isfinite(sd), si, -1)


def rerank_topk(
    shadow: torch.Tensor,   # [cap, D] originals (f32 or int8)
    slots: torch.Tensor,    # [B, C] coarse candidate slots (-1 = invalid)
    ok: torch.Tensor,       # [B, C] bool validity (mask filters folded in)
    qf: torch.Tensor,       # [B, D] f32 queries (original space)
    *,
    metric: DistanceMetric,
    k: int,
):
    """Exact top-k over gathered candidates in the output metric.

    Returns (dists [B, k] ascending in the user metric, slots [B, k]).
    Traced (``utils/timing.py``), the call is span ``rerank.topk`` and each
    chunk's gather a device span ``rerank.gather``.
    """
    with timing.span("rerank.topk"):
        dd = _exact_dists(shadow, slots, ok, qf, metric)
        return _smallest(dd, slots, k)


def _dedup_smallest(dd, ids, k: int):
    """Top-k by distance with duplicate ids removed, exact.

    Sort the whole candidate set by id (stable), mask every element equal
    to its left neighbour, then take the k smallest distances. Duplicate
    ids carry identical distances (the same row reranked twice), so keeping
    one occurrence is exact. Deduping before the top-k matters: one node
    can neighbour most of the coarse candidates.
    """
    keys = torch.where(torch.isfinite(dd), ids, _SENTINEL)  # invalid -> end
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    dd_s = torch.gather(dd, 1, order)
    dup = torch.zeros_like(keys_s, dtype=torch.bool)
    dup[:, 1:] = keys_s[:, 1:] == keys_s[:, :-1]
    dd_s = torch.where(dup, _INF, dd_s)
    ids_s = torch.where(keys_s == _SENTINEL, -1, keys_s)
    return _smallest(dd_s, ids_s, k)


def expand_rerank_topk(
    shadow: torch.Tensor,   # [cap, D] originals (f32 or int8)
    adj0: torch.Tensor,     # [cap, M0] level-0 adjacency (graph slots)
    slots: torch.Tensor,    # [B, C] coarse candidate slots (-1 = invalid)
    ok: torch.Tensor,       # [B, C] bool validity
    qf: torch.Tensor,       # [B, D] f32 queries (original space)
    *,
    metric: DistanceMetric,
    k: int,
    filter_mask: torch.Tensor | None = None,  # [cap] bool (live & filters)
):
    """One-hop neighbour expansion + exact rerank: top-k over the coarse
    candidates AND their level-0 graph neighbours.

    Quantized coarse search ranks in the quantized space, so a true
    neighbour just outside the coarse top-C is usually adjacent to one
    inside it; reranking the C*(M0+1) expanded candidates in exact space
    recovers it. Duplicates (shared neighbours) are removed in the final
    selection. Returns (dists [B, k], slots [B, k]).
    """
    b, c = slots.shape
    nbrs = adj0[slots.clamp_min(0)]                       # [B, C, M0]
    nbrs = torch.where(ok[:, :, None], nbrs, -1).reshape(b, -1)
    cand = torch.cat([torch.where(ok, slots, -1), nbrs], dim=1)
    okc = cand >= 0
    if filter_mask is not None:
        # expanded neighbours must re-check liveness and filters: the
        # coarse slots were filtered by the beam, their neighbours not
        okc &= filter_mask[cand.clamp(0, filter_mask.shape[0] - 1)]
    dd = _exact_dists(shadow, cand, okc, qf, metric)
    return _dedup_smallest(dd, cand, k)
