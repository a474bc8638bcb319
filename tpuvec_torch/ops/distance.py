"""Batched distances in torch: the float metrics of ``tpuvec/ops/distance.py``.

* ``*_pairwise(q, x)``: [B, D] x [N, D] -> [B, N]  (matrix-product forms)
* ``gathered_internal(q, nbrs)``: [B, D] x [B, M, D] -> [B, M]  (beam form)

Distance semantics:
  L2      sqrt(sum((a-b)^2))
  L1      sum(|a-b|)
  COSINE  1 - a.b/(|a| |b|)

Graph traversal uses *internal* distances that are monotone transforms of
the user metric (squared L2 instead of L2; cosine runs on normalized
vectors as squared L2, converted on output as cos = L2^2/2).
``internal_to_output`` converts internal values to user-facing ones.

The int8 (exact int32 accumulation) and Hamming branches are not ported
yet and raise NotImplementedError. On CUDA the products run in full
float32: ``tpuvec_torch.device.resolve`` turns TF32 off.
"""

from __future__ import annotations

import torch

from tpuvec_torch.types import DistanceMetric, VectorType

__all__ = [
    "sq_l2_pairwise",
    "l2_pairwise",
    "l1_pairwise",
    "cosine_pairwise",
    "internal_pairwise",
    "gathered_internal",
    "internal_to_output",
    "internal_needs_normalize",
]

_F32 = torch.float32


def _float_only(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_floating_point():
            raise NotImplementedError(
                f"{t.dtype} distances (int8 / packed bits) are not ported yet"
            )


def sq_l2_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2: [B, D] x [N, D] -> [B, N] via |q|^2 + |x|^2 - 2 q.x."""
    _float_only(q, x)
    qf, xf = q.to(_F32), x.to(_F32)
    qx = qf @ xf.T
    qn = (qf * qf).sum(-1)[:, None]
    xn = (xf * xf).sum(-1)[None, :]
    return torch.clamp_min(qn + xn - 2.0 * qx, 0.0)  # guard fp cancellation


def l2_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_l2_pairwise(q, x))


def l1_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L1 via broadcast [B, N, D] reduce: callers chunk N to bound memory."""
    _float_only(q, x)
    return (q.to(_F32)[:, None, :] - x.to(_F32)[None, :, :]).abs().sum(-1)


def _cosine_from_dots(dots, qn, xn):
    denom = qn * xn
    ok = denom > 0
    sim = torch.where(ok, dots / torch.where(ok, denom, torch.ones_like(denom)), 0.0)
    return 1.0 - sim


def cosine_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine distance 1 - sim, zero-norm guarded (-> distance 1)."""
    _float_only(q, x)
    qf, xf = q.to(_F32), x.to(_F32)
    qn = torch.sqrt((qf * qf).sum(-1))[:, None]
    xn = torch.sqrt((xf * xf).sum(-1))[None, :]
    return _cosine_from_dots(qf @ xf.T, qn, xn)


def internal_needs_normalize(metric: DistanceMetric, vec_type: VectorType) -> bool:
    """Cosine + float32 stores normalized vectors and runs L2 internally."""
    return metric is DistanceMetric.COSINE and vec_type is VectorType.FLOAT32


def internal_pairwise(
    metric: DistanceMetric,
    q: torch.Tensor,
    x: torch.Tensor,
    *,
    normalized: bool = False,
) -> torch.Tensor:
    """Internal distance matrix for graph ops. Monotone in the user metric.

    L2 -> squared L2; COSINE with `normalized=True` -> squared L2 of the
    normalized vectors; COSINE otherwise -> 1-sim; L1 -> L1.
    """
    if metric is DistanceMetric.L2 or (metric is DistanceMetric.COSINE and normalized):
        return sq_l2_pairwise(q, x)
    if metric is DistanceMetric.COSINE:
        return cosine_pairwise(q, x)
    if metric is DistanceMetric.L1:
        return l1_pairwise(q, x)
    if metric is DistanceMetric.HAMMING:
        raise NotImplementedError("Hamming distances are not ported yet")
    raise ValueError(f"unsupported metric {metric}")


def gathered_internal(
    metric: DistanceMetric,
    q: torch.Tensor,
    nbrs: torch.Tensor,
    *,
    normalized: bool = False,
) -> torch.Tensor:
    """Internal distances q [B, D] vs gathered nbrs [B, M, D] -> [B, M]."""
    if metric is DistanceMetric.HAMMING:
        raise NotImplementedError("Hamming distances are not ported yet")
    _float_only(q, nbrs)
    qf, nf = q.to(_F32), nbrs.to(_F32)
    if metric is DistanceMetric.L1:
        return (qf[:, None, :] - nf).abs().sum(-1)
    qx = torch.bmm(nf, qf[:, :, None])[:, :, 0]
    if metric is DistanceMetric.L2 or normalized:
        d = (qf * qf).sum(-1)[:, None] + (nf * nf).sum(-1) - 2.0 * qx
        return torch.clamp_min(d, 0.0)
    if metric is DistanceMetric.COSINE:
        qn = torch.sqrt((qf * qf).sum(-1))[:, None]
        nn = torch.sqrt((nf * nf).sum(-1))
        return _cosine_from_dots(qx, qn, nn)
    raise ValueError(f"unsupported metric {metric}")


def internal_to_output(
    metric: DistanceMetric, internal: torch.Tensor, *, normalized: bool = False
) -> torch.Tensor:
    """Convert internal distances to the user-facing metric: L2 output is
    sqrt; cosine output for normalized internal squared L2 is sq/2."""
    if metric is DistanceMetric.L2:
        return torch.sqrt(internal)
    if metric is DistanceMetric.COSINE and normalized:
        return internal / 2.0
    return internal
