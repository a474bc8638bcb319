"""The plain reference's arithmetic: an exact cosine top-k over the raw
rows, in blocks, and cosine distances of given pairs in float64.

Everything here works from the raw rows the benchmark made, never from
what the program derived from them: the reference normalises the rows
itself. Float32 products run with TF32 off. ``tf32=True`` gives the
control instead: the same arithmetic with every product operand rounded
to TF32's 10-bit mantissa (what the card's tensor cores read), emulated
so that it is the same on the card and on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["tf32_round", "unit", "cosine_topk", "pair_cosine64", "pair_sq_l2", "INT8_LEVELS",
           "INT4_LEVELS", "codes", "pair_code_sq_l2", "code_sq_l2_topk"]

# the fixed-scale symmetric quantizer of an int8 index (the upstream's
# vec_quantize_int8: a unit row's components clamped to [-1, 1] times 127,
# rounded), and the control's int4 one (times 7)
INT8_LEVELS = 127
INT4_LEVELS = 7
# rows of the corpus in one product block, and queries in one block: a
# [4096, 131072] float32 block of scores is 2 GB
_ROWS = 1 << 17
_QUERIES = 1 << 12


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def unit(x: torch.Tensor) -> torch.Tensor:
    """Rows of x scaled to unit length (float32; zero rows stay zero)."""
    x = x.to(torch.float32)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-30)


def _no_tf32():
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def cosine_topk(q: torch.Tensor, x: torch.Tensor, k: int, *, valid: torch.Tensor | None = None,
                tf32: bool = False):
    """Exact top-k by cosine of raw queries q [B, D] over raw rows x [N, D]
    (``valid`` [N] bool limits the rows). Returns (cosine distance [B, k]
    ascending, float32; row ids [B, k] int64, -1 where fewer than k rows
    are valid)."""
    _no_tf32()
    rnd = tf32_round if tf32 else (lambda t: t)
    out_d, out_i = [], []
    for qs in range(0, q.shape[0], _QUERIES):
        qn = rnd(unit(q[qs:qs + _QUERIES]))
        best_s = torch.full((qn.shape[0], k), -float("inf"), device=q.device)
        best_i = torch.full((qn.shape[0], k), -1, dtype=torch.int64, device=q.device)
        for xs in range(0, x.shape[0], _ROWS):
            s = qn @ rnd(unit(x[xs:xs + _ROWS])).T
            if valid is not None:
                s = torch.where(valid[xs:xs + _ROWS][None, :], s, -float("inf"))
            bs, bi = torch.topk(s, min(k, s.shape[1]), dim=1)
            best_s, pos = torch.topk(torch.cat([best_s, bs], 1), k, dim=1)
            best_i = torch.gather(torch.cat([best_i, bi + xs], 1), 1, pos)
        out_d.append(1.0 - best_s)
        out_i.append(torch.where(torch.isfinite(best_s), best_i, -1))
    return torch.cat(out_d), torch.cat(out_i)


def pair_cosine64(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Cosine distance in float64 between q[b] and x[ids[b, j]]: [B, K]
    (NaN where an id is out of range)."""
    ok = (ids >= 0) & (ids < x.shape[0])
    rows = x[ids.clamp(0, x.shape[0] - 1)].to(torch.float64)  # [B, K, D]
    q64 = q.to(torch.float64)
    dots = torch.einsum("bkd,bd->bk", rows, q64)
    norms = torch.linalg.vector_norm(rows, dim=2) * torch.linalg.vector_norm(q64, dim=1)[:, None]
    d = 1.0 - dots / norms.clamp_min(1e-300)
    return torch.where(ok, d, float("nan"))


def pair_sq_l2(a: torch.Tensor, b: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """Squared L2 between the unit rows of a [P, D] and b [P, D], pair by
    pair: in float64, or (``tf32``) as |a|^2 + |b|^2 - 2 a.b with the
    product's operands rounded to TF32 and float32 sums, as a matrix
    product would give it."""
    if not tf32:
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        a64 = a64 / torch.linalg.vector_norm(a64, dim=1, keepdim=True).clamp_min(1e-300)
        b64 = b64 / torch.linalg.vector_norm(b64, dim=1, keepdim=True).clamp_min(1e-300)
        return ((a64 - b64) ** 2).sum(1)
    ua, ub = unit(a), unit(b)
    dot = (tf32_round(ua) * tf32_round(ub)).sum(1)
    return ((ua * ua).sum(1) + (ub * ub).sum(1) - 2.0 * dot).clamp_min(0.0).to(torch.float64)


def codes(x: torch.Tensor, levels: int = INT8_LEVELS) -> torch.Tensor:
    """The reference's quantization of raw rows x [N, D]: unit length in
    float64, clamped to [-1, 1], times ``levels``, rounded to nearest
    (int8)."""
    x64 = x.to(torch.float64)
    x64 = x64 / torch.linalg.vector_norm(x64, dim=1, keepdim=True).clamp_min(1e-300)
    return torch.round(x64.clamp(-1.0, 1.0) * levels).to(torch.int8)


def pair_code_sq_l2(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                    levels: int = INT8_LEVELS) -> torch.Tensor:
    """Exact squared L2 between the reference's codes of the raw rows q[b]
    and x[ids[b, j]]: [B, K] float64 (NaN where an id is out of range)."""
    ok = (ids >= 0) & (ids < x.shape[0])
    b, k = ids.shape
    xc = codes(x[ids.clamp(0, x.shape[0] - 1)].reshape(b * k, -1), levels).reshape(b, k, -1)
    diff = codes(q, levels).to(torch.int32)[:, None, :] - xc.to(torch.int32)
    d = (diff * diff).sum(-1, dtype=torch.int64).to(torch.float64)
    return torch.where(ok, d, float("nan"))


def code_sq_l2_topk(qc: torch.Tensor, xc: torch.Tensor, k: int):
    """Exact top-k of the codes qc [B, D] over the codes xc [N, D] by
    squared L2: (float32 distances [B, k] ascending, ids [B, k] int64).
    The products run in float32 on integers small enough to be exact
    (int4 codes)."""
    _no_tf32()
    out_d, out_i = [], []
    xn = (xc.to(torch.float32) ** 2).sum(1)
    for qs in range(0, qc.shape[0], _QUERIES):
        qf = qc[qs:qs + _QUERIES].to(torch.float32)
        qn = (qf * qf).sum(1)[:, None]
        best_d = torch.full((qf.shape[0], k), float("inf"), device=qc.device)
        best_i = torch.full((qf.shape[0], k), -1, dtype=torch.int64, device=qc.device)
        for xs in range(0, xc.shape[0], _ROWS):
            d = qn + xn[None, xs:xs + _ROWS] - 2.0 * (qf @ xc[xs:xs + _ROWS].to(torch.float32).T)
            bd, bi = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            best_d, pos = torch.topk(torch.cat([best_d, bd], 1), k, dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, bi + xs], 1), 1, pos)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)
