"""A frozen copy of the plain HNSW search: the greedy descent and the
level-0 beam loop in plain torch (f32 and int8 rows, unmasked and
masked), as ``tpuvec_torch/index/search.py`` and ``tpuvec_torch/ops/beam.py``
(``beam_loop_plain``) had them when this benchmark was written.

Two uses, both on the program's graph, which they only read:

* ``loop_rows`` replays one launch of the level-0 loop kernel plainly and
  records the rows it reads, for ``loop_roofline``'s least time
  (``loop_bound``: the arithmetic of the port's ``chip_smoke.py``);
* ``search`` walks a grown graph over the reference's own unit rows, to
  judge the graph that the ingest cell built.

It is a copy on purpose: a later change to the program's plain loop does
not move the yardstick.
"""

from __future__ import annotations

import torch

from portbench.reference import peaks

__all__ = ["frontier", "beam_update", "beam_loop", "descend", "search", "loop_rows", "loop_bound"]

_INF = float("inf")
_ACTIVE_CHECK_EVERY = 8


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def node_dist(vectors: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 q[b] -> vectors[ids[b, m]] ([B, M]; ids < 0 -> inf): exact
    integers for int8 rows, float32 otherwise."""
    rows = vectors[ids.clamp_min(0)]
    if q.dtype == torch.int8:
        diff = q.to(torch.int32)[:, None, :] - rows.to(torch.int32)
        d = (diff * diff).sum(-1, dtype=torch.int32).to(torch.float32)
    else:
        qf, nf = q.to(torch.float32), rows.to(torch.float32)
        qx = torch.bmm(nf, qf[:, :, None])[:, :, 0]
        d = torch.clamp_min((qf * qf).sum(-1)[:, None] + (nf * nf).sum(-1) - 2.0 * qx, 0.0)
    return torch.where(ids >= 0, d, _INF)


def frontier(sd, si, sx, n_expand):
    """(sel [B, EF], cand [B, E], active [B]) of a sorted beam."""
    b, efp = sd.shape
    finite = torch.isfinite(sd)
    unexp = ~sx & finite
    rank = torch.cumsum(unexp.to(torch.int32), dim=1)
    cd_best = torch.where(unexp, sd, _INF).amin(dim=1)
    worst = sd[:, efp - 1]
    active = torch.isfinite(cd_best) & ((cd_best <= worst) | ~torch.isfinite(worst))
    sel = unexp & (rank <= n_expand) & active[:, None]
    col = torch.where(sel, rank - 1, n_expand).to(torch.int64)
    cand = torch.full((b, n_expand + 1), -1, dtype=torch.int32, device=sd.device)
    cand.scatter_(1, col, torch.where(sel, si, -1))
    return sel, cand[:, :n_expand].contiguous(), active


def fresh(beam_i, nbrs, n_expand):
    """nbrs[b, w] is an id, not in the beam and (E > 1) not an earlier
    window entry."""
    dup = (nbrs[:, :, None] == beam_i[:, None, :]).any(-1)
    if n_expand > 1:
        pos = torch.arange(nbrs.shape[1], device=nbrs.device)
        earlier = (pos[:, None] > pos[None, :])[None]
        dup |= ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(-1)
    return (nbrs >= 0) & ~dup


def _merge_smallest(d, i, new_d, new_i, keep):
    sd, order = torch.sort(torch.cat([d, new_d], dim=1), dim=1, stable=True)
    order = order[:, :keep]
    return sd[:, :keep].contiguous(), torch.gather(torch.cat([i, new_i], dim=1), 1, order), order


def beam_update(beam_d, beam_i, beam_x, nbrs, nd, *, n_expand=1):
    efp = beam_d.shape[1]
    ok = fresh(beam_i, nbrs, n_expand)
    sd, si, order = _merge_smallest(
        beam_d, beam_i, torch.where(ok, nd, _INF), torch.where(ok, nbrs, -1), efp)
    x = torch.cat([beam_x, torch.zeros_like(ok)], dim=1)
    sx = torch.gather(x, 1, order) | ~torch.isfinite(sd)
    sel, cand, active = frontier(sd, si, sx, n_expand)
    return sd, si, sx | sel, cand, active


def beam_loop(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d=None, res_i=None,
              *, max_iters, node_mask=None, record=None):
    """The whole level-0 loop in lock step. With ``record`` (a list), each
    iteration appends (fresh window ids, active frontier ids): the vector
    rows and adjacency rows it reads."""
    b, e = cand.shape
    w = e * adj0.shape[1]
    kp = 0 if node_mask is None else res_d.shape[1]
    for it in range(max_iters):
        if it % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        ok = (cand >= 0) & active[:, None]
        nbrs = adj0[cand.clamp_min(0)]
        nbrs = torch.where(ok[:, :, None], nbrs, -1).reshape(b, w)
        nd = node_dist(vectors, q, nbrs)
        if record is not None:
            record.append((nbrs[fresh(beam_i, nbrs, e)], cand[ok]))
        if node_mask is not None:
            allow = fresh(beam_i, nbrs, e) & node_mask[nbrs.clamp_min(0)]
            res_d, res_i, _ = _merge_smallest(
                res_d, res_i, torch.where(allow, nd, _INF), torch.where(allow, nbrs, -1), kp)
        beam_d, beam_i, beam_x, cand, active = beam_update(beam_d, beam_i, beam_x, nbrs, nd,
                                                           n_expand=e)
    if node_mask is None:
        return beam_d, beam_i
    pos = torch.arange(kp, device=q.device)
    earlier = (pos[:, None] > pos[None, :])[None]
    dup = ((res_i[:, :, None] == res_i[:, None, :]) & earlier).any(-1) & (res_i >= 0)
    res_d, order = torch.sort(torch.where(dup, _INF, res_d), dim=1, stable=True)
    return res_d, torch.gather(torch.where(dup, -1, res_i), 1, order)


def descend(graph: dict, vectors: torch.Tensor, q: torch.Tensor, *, max_steps: int = 64):
    """Greedy descent from the entry point to level 1: (cur [B], cur_d [B]).
    ``graph`` holds the program's graph fields (entry_point, entry_level,
    upper_slot, upper_adj) and its ``m`` and ``lu``."""
    b = q.shape[0]
    cur = graph["entry_point"].to(torch.int32).reshape(1).expand(b).clone()
    cur_d = node_dist(vectors, q, cur[:, None])[:, 0]
    m = graph["m"]
    for lev in range(min(graph["lu"], int(graph["entry_level"])), 0, -1):
        for _ in range(max_steps):
            slots = graph["upper_slot"][cur.clamp_min(0)]
            nbrs = graph["upper_adj"][slots.clamp_min(0), (lev - 1) * m: lev * m]
            nbrs = torch.where(slots[:, None] >= 0, nbrs, -1)
            nd = node_dist(vectors, q, nbrs)
            bd, best = torch.min(nd, dim=1)
            move = bd < cur_d
            cur = torch.where(move, torch.gather(nbrs, 1, best[:, None])[:, 0], cur)
            cur_d = torch.where(move, bd, cur_d)
            if not bool(move.any()):
                break
    return cur, cur_d


def search(graph: dict, vectors: torch.Tensor, q: torch.Tensor, *, k: int, ef: int):
    """Plain HNSW search (descent, then the level-0 beam with E = 1) of
    queries q over ``vectors`` along the graph's edges: ids [B, k]."""
    efp = _next_pow2(max(ef, k))
    seed, seed_d = descend(graph, vectors, q)
    b = q.shape[0]
    beam_d = torch.full((b, efp), _INF, device=q.device)
    beam_i = torch.full((b, efp), -1, dtype=torch.int32, device=q.device)
    beam_x = torch.ones((b, efp), dtype=torch.bool, device=q.device)
    beam_d[:, 0] = torch.where(seed >= 0, seed_d, _INF)
    beam_i[:, 0] = seed
    beam_x[:, 0] = seed < 0
    sel, cand, active = frontier(beam_d, beam_i, beam_x, 1)
    beam_x |= sel
    max_iters = -(-3 * max(ef, k) // 2) + 8
    _, ids = beam_loop(q, vectors, graph["adj0"], beam_d, beam_i, beam_x, cand, active,
                       max_iters=max_iters)
    return ids[:, :k]


def loop_rows(args: tuple, kwargs: dict):
    """Replay one launch of the level-0 loop kernel plainly from the
    arguments it was given (``ops/beam.py:beam_loop``'s): (the fresh ids
    of every iteration, the active frontier ids of every iteration)."""
    q, vectors, adj0, beam_d, beam_i, beam_x, cand, active = args[:8]
    res_d, res_i = (args[8], args[9]) if len(args) > 9 else (kwargs.get("res_d"), kwargs.get("res_i"))
    record = []
    beam_loop(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d, res_i,
              max_iters=kwargs["max_iters"], node_mask=kwargs.get("node_mask"), record=record)
    empty = torch.zeros(0, dtype=torch.int32, device=q.device)
    if not record:
        return empty, empty
    return torch.cat([f for f, _ in record]), torch.cat([a for _, a in record])


def loop_bound(args: tuple, kwargs: dict, outs: tuple, fresh_ids, adj_ids) -> dict:
    """The least time of one loop launch: the larger of its bytes over the
    HBM rate and its operations over the compute rate.

    Bytes: each distinct vector row and adjacency row the plain loop read
    once (masked: and the mask byte of each distinct fresh id), plus the
    queries, the beam, frontier and result buffer in, and the outputs.
    Operations: two multiply-adds an element of every fresh row (int8 rows
    at the int8 rate, f32 rows at the float32 rate)."""
    q, vectors, adj0 = args[:3]
    masked = kwargs.get("node_mask") is not None
    row_v = vectors.shape[1] * vectors.element_size() + (1 if masked else 0)
    row_a = adj0.shape[1] * adj0.element_size()
    small = [q, *[a for a in args[3:] if isinstance(a, torch.Tensor)],
             *[t for t in outs if isinstance(t, torch.Tensor)]]
    small_bytes = sum(t.numel() * t.element_size() for t in small)
    distinct = (torch.unique(fresh_ids).numel() * row_v
                + torch.unique(adj_ids).numel() * row_a + small_bytes)
    rate = peaks.INT8_OPS_PER_S if vectors.dtype == torch.int8 else peaks.F32_OPS_PER_S
    ops = fresh_ids.numel() * 4 * vectors.shape[1]
    t_bytes, t_ops = distinct / peaks.HBM_BYTES_PER_S, ops / rate
    return {"bound_s": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": distinct, "ops": ops}
