"""Batched HNSW search: greedy upper-level descent + level-0 beam.

A whole batch of queries advances in lock step:

* the candidate and result heaps are one fixed-width sorted beam
  [B, EF] (EF = next power of two of ef);
* there is no visited set: the beam only ever improves, so an evicted node
  can never re-qualify, and membership in the current beam is a complete
  visited test;
* each iteration gathers the frontier's adjacency rows and their vectors,
  computes their distances in torch, and hands them to ``beam_update``
  (dedup + merge + next frontier: one CUDA kernel launch on the card).

``n_expand`` (E) expands the E best unexpanded candidates per iteration.
"""

from __future__ import annotations

import torch

from tpuvec_torch.index.graph import GraphState, HnswConfig
from tpuvec_torch.ops.beam import beam_update, frontier
from tpuvec_torch.ops.distance import gathered_internal, internal_to_output

__all__ = [
    "search_graph", "search", "descend_to_level1", "beam_search_level0",
    "default_max_iters",
]

_INF = float("inf")

# The level-0 loop reads `active.any()` back to the host only every this
# many iterations. Iterating past the point where every query went
# inactive changes nothing (an inactive query's update is a fixed point,
# see ops/beam.py), so the result equals a loop that checks every time.
_ACTIVE_CHECK_EVERY = 8


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _node_dist(config: HnswConfig, state: GraphState, q: torch.Tensor, ids: torch.Tensor):
    """Internal distance q[b] -> node ids[b, M]; invalid ids -> inf."""
    vecs = state.vectors[ids.clamp_min(0)]  # clamp: ids may be -1
    d = gathered_internal(config.graph_metric, q, vecs, normalized=config.normalized)
    return torch.where(ids >= 0, d, _INF)


def descend_to_level1(
    config: HnswConfig,
    state: GraphState,
    q: torch.Tensor,
    *,
    max_steps: int = 64,
):
    """Greedy-descend every query from the entry point down to level 1.

    Returns (cur [B] i32, cur_d [B] f32): the best node found per query,
    used to seed the level-0 beam. The entry level is read to the host
    once per call, and whether any query moved once per step: a level
    above the entry level runs no step.
    """
    b = q.shape[0]
    cur = state.entry_point.expand(b).clone()
    cur_d = _node_dist(config, state, q, cur[:, None])[:, 0]
    top = min(config.lu, int(state.entry_level))
    m = config.m
    for lev in range(top, 0, -1):
        for _ in range(max_steps):
            slots = state.upper_slot[cur.clamp_min(0)]
            nbrs = state.upper_adj[slots.clamp_min(0), (lev - 1) * m : lev * m]
            nbrs = torch.where(slots[:, None] >= 0, nbrs, -1)
            nd = _node_dist(config, state, q, nbrs)
            bd, best = torch.min(nd, dim=1)
            move = bd < cur_d
            cur = torch.where(move, torch.gather(nbrs, 1, best[:, None])[:, 0], cur)
            cur_d = torch.where(move, bd, cur_d)
            if not bool(move.any()):
                break
    return cur, cur_d


def beam_search_level0(
    config: HnswConfig,
    state: GraphState,
    q: torch.Tensor,
    seed_ids: torch.Tensor,
    seed_dists: torch.Tensor,
    *,
    ef: int,
    max_iters: int,
    n_expand: int = 1,
):
    """Best-first beam search at level 0.

    q [B, Dp]; seed_ids/seed_dists [B] from the descent. Returns
    (beam_d [B, EF] ascending, beam_i [B, EF], iters) in internal
    distance, with EF = next_pow2(ef); iters counts the iterations run.
    """
    b = q.shape[0]
    e = n_expand
    w = e * config.max_m0
    efp = _next_pow2(ef)
    dev = q.device

    beam_d = torch.full((b, efp), _INF, dtype=torch.float32, device=dev)
    beam_i = torch.full((b, efp), -1, dtype=torch.int32, device=dev)
    beam_x = torch.ones((b, efp), dtype=torch.bool, device=dev)  # padding = expanded
    beam_d[:, 0] = torch.where(seed_ids >= 0, seed_dists, _INF)
    beam_i[:, 0] = seed_ids
    beam_x[:, 0] = seed_ids < 0

    sel, cand, active = frontier(beam_d, beam_i, beam_x, e)
    beam_x |= sel
    it = 0
    if not bool(active.any()):
        return beam_d, beam_i, it
    while it < max_iters:
        ok = (cand >= 0) & active[:, None]
        nbrs = state.adj0[cand.clamp_min(0)]  # [B, E, M0]
        nbrs = torch.where(ok[:, :, None], nbrs, -1).reshape(b, w)
        nd = _node_dist(config, state, q, nbrs)
        beam_d, beam_i, beam_x, cand, active = beam_update(
            beam_d, beam_i, beam_x, nbrs, nd, n_expand=e
        )
        it += 1
        if it % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
    return beam_d, beam_i, it


def default_max_iters(ef: int, n_expand: int) -> int:
    return -(-3 * ef // (2 * n_expand)) + 8


def search_graph(
    config: HnswConfig,
    state: GraphState,
    q: torch.Tensor,
    *,
    k: int,
    ef: int | None = None,
    max_iters: int | None = None,
    n_expand: int = 1,
):
    """Batched k-NN over the graph in *internal* distance space.

    q [B, Dp] must already be prepared (prepare_queries) and lie on the
    graph's device. Returns (dists [B, k], ids [B, k]) ascending; empty
    index -> (inf, -1). ef defaults to max(ef_search, k).
    """
    ef = max(ef or config.ef_search, k)
    if max_iters is None:
        max_iters = default_max_iters(ef, n_expand)
    seed_ids, seed_d = descend_to_level1(config, state, q)
    beam_d, beam_i, _ = beam_search_level0(
        config, state, q, seed_ids, seed_d,
        ef=ef, max_iters=max_iters, n_expand=n_expand,
    )
    empty = state.entry_point < 0
    out_d = torch.where(empty, _INF, beam_d[:, :k])
    out_i = torch.where(empty, -1, beam_i[:, :k])
    return out_d, out_i


def search(
    config: HnswConfig,
    state: GraphState,
    q: torch.Tensor,
    *,
    k: int,
    ef: int | None = None,
    n_expand: int = 1,
):
    """User-facing search: internal distances converted to the output
    metric."""
    d, i = search_graph(config, state, q, k=k, ef=ef, n_expand=n_expand)
    out = internal_to_output(config.metric, d, normalized=config.normalized)
    return torch.where(torch.isfinite(d), out, _INF), i
