"""Batched distances in torch: the port of ``tpuvec/ops/distance.py``.

* ``*_pairwise(q, x)``: [B, D] x [N, D] -> [B, N]  (matrix-product forms)
* ``gathered_internal(q, nbrs)``: [B, D] x [B, M, D] -> [B, M]  (beam form)

Distance semantics:
  L2      sqrt(sum((a-b)^2))
  L1      sum(|a-b|)
  COSINE  1 - a.b/(|a| |b|)
  HAMMING popcount(a XOR b)   (packed words, int32 holding uint32 bits)

Graph traversal uses *internal* distances that are monotone transforms of
the user metric (squared L2 instead of L2; cosine runs on normalized
vectors as squared L2, converted on output as cos = L2^2/2).
``internal_to_output`` converts internal values to user-facing ones.

int8 inputs give exact integers, as the JAX package's int32 accumulation
does: ``torch.matmul`` has no integer form on CUDA, so integer products
run in float32 over column chunks small enough that every partial sum is
an exactly representable integer, and the chunks are summed in int32.
Hamming is exact integer counts. On CUDA the float products run in full
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
    "hamming_pairwise",
    "unpack_pm1",
    "internal_pairwise",
    "gathered_internal",
    "internal_to_output",
    "internal_needs_normalize",
]

_F32 = torch.float32
_I32 = torch.int32

# Columns per float32 partial product of int8 rows: |a*b| <= 2^14, so a
# partial sum of 512 products stays within 2^23 and is exact in float32
# in any summation order (int8 values and +-1 are exact even in TF32).
_INT_CHUNK = 512


def _both_int8(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == torch.int8 and b.dtype == torch.int8


def _int_dot(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact integer a [..., B, D] @ b_t [..., D, N] -> int32 [..., B, N]."""
    d = a.shape[-1]
    out = None
    for s in range(0, d, _INT_CHUNK):
        part = torch.matmul(a[..., s : s + _INT_CHUNK].to(_F32), b_t[..., s : s + _INT_CHUNK, :].to(_F32))
        part = part.to(_I32)
        out = part if out is None else out + part
    return out


def _int_sq_norms(x: torch.Tensor) -> torch.Tensor:
    xi = x.to(_I32)
    return (xi * xi).sum(-1, dtype=_I32)


def sq_l2_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2: [B, D] x [N, D] -> [B, N] via |q|^2 + |x|^2 - 2 q.x."""
    if _both_int8(q, x):
        d = _int_sq_norms(q)[:, None] + _int_sq_norms(x)[None, :] - 2 * _int_dot(q, x.T)
        return d.to(_F32)
    qf, xf = q.to(_F32), x.to(_F32)
    qx = qf @ xf.T
    qn = (qf * qf).sum(-1)[:, None]
    xn = (xf * xf).sum(-1)[None, :]
    return torch.clamp_min(qn + xn - 2.0 * qx, 0.0)  # guard fp cancellation


def l2_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_l2_pairwise(q, x))


def l1_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L1: [B, D] x [N, D] -> [B, N], without the [B, N, D] broadcast."""
    return torch.cdist(q.to(_F32), x.to(_F32), p=1.0)


def _cosine_from_dots(dots, qn, xn):
    denom = qn * xn
    ok = denom > 0
    sim = torch.where(ok, dots / torch.where(ok, denom, torch.ones_like(denom)), 0.0)
    return 1.0 - sim


def cosine_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine distance 1 - sim, zero-norm guarded (-> distance 1)."""
    if _both_int8(q, x):
        qn = torch.sqrt(_int_sq_norms(q).to(_F32))[:, None]
        xn = torch.sqrt(_int_sq_norms(x).to(_F32))[None, :]
        return _cosine_from_dots(_int_dot(q, x.T).to(_F32), qn, xn)
    qf, xf = q.to(_F32), x.to(_F32)
    qn = torch.sqrt((qf * qf).sum(-1))[:, None]
    xn = torch.sqrt((xf * xf).sum(-1))[None, :]
    return _cosine_from_dots(qf @ xf.T, qn, xn)


def unpack_pm1(w: torch.Tensor) -> torch.Tensor:
    """Packed words [..., W] (int32) -> [..., W*32] int8 in {-1, +1},
    LSB-first within each word (the codec's packing order). Reads the
    words as little-endian bytes, as both the CPU and the card store them."""
    by = w.contiguous().view(torch.uint8)  # [..., 4W]
    shifts = torch.arange(8, dtype=torch.uint8, device=w.device)
    bits = (by[..., :, None] >> shifts) & 1  # [..., 4W, 8]
    pm1 = bits.to(torch.int8) * 2 - 1
    return pm1.reshape(*w.shape[:-1], w.shape[-1] * 32)


def hamming_pairwise(qw: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """Hamming over packed words: [..., B, W] x [..., N, W] -> [..., B, N]
    (f32), as one exact product of the +-1 expansions:
    s_a . s_b = Dp - 2*hamming(a, b) (zero pad bits agree on both sides
    and cancel)."""
    dp = qw.shape[-1] * 32
    dot = _int_dot(unpack_pm1(qw), unpack_pm1(xw).transpose(-1, -2))
    return ((dp - dot) >> 1).to(_F32)


def _popcount_words(w: torch.Tensor) -> torch.Tensor:
    """Set bits per row of words [..., W] -> int32 [...], bytewise."""
    x = w.contiguous().view(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(-1, dtype=_I32)


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
    normalized vectors; COSINE otherwise -> 1-sim; L1 -> L1; HAMMING -> counts.
    """
    if metric is DistanceMetric.L2 or (metric is DistanceMetric.COSINE and normalized):
        return sq_l2_pairwise(q, x)
    if metric is DistanceMetric.COSINE:
        return cosine_pairwise(q, x)
    if metric is DistanceMetric.L1:
        return l1_pairwise(q, x)
    if metric is DistanceMetric.HAMMING:
        return hamming_pairwise(q, x)
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
        return _popcount_words(torch.bitwise_xor(q[:, None, :], nbrs)).to(_F32)
    if _both_int8(q, nbrs):  # exact integers, then f32
        qi, ni = q.to(_I32)[:, None, :], nbrs.to(_I32)
        if metric is DistanceMetric.L1:
            return (qi - ni).abs().sum(-1, dtype=_I32).to(_F32)
        if metric is DistanceMetric.L2 or normalized:
            diff = qi - ni
            return (diff * diff).sum(-1, dtype=_I32).to(_F32)
        if metric is DistanceMetric.COSINE:
            qx = (qi * ni).sum(-1, dtype=_I32).to(_F32)
            qn = torch.sqrt(_int_sq_norms(q).to(_F32))[:, None]
            nn = torch.sqrt(_int_sq_norms(nbrs).to(_F32))
            return _cosine_from_dots(qx, qn, nn)
        raise ValueError(f"unsupported metric {metric}")
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
