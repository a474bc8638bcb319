"""Batched HNSW search: greedy upper-level descent + level-0 beam.

A whole batch of queries advances in lock step through the descent:

* the candidate and result heaps are one fixed-width sorted beam
  [B, EF] (EF = next power of two of ef);
* there is no visited set: the beam only ever improves, so an evicted node
  can never re-qualify, and membership in the current beam is a complete
  visited test;
* the level-0 loop (adjacency gather, vector gather, distance, dedup +
  merge + next frontier) is ``ops/beam.py:beam_loop``: one CUDA kernel
  launch per batch on the card, each query in its own block, in the form
  of the graph's rows (f32, int8, or packed words under Hamming).

Queries are prepared into the graph's store dtype (``prepare_queries``),
so the descent and the loop compute the graph's internal distances on
rows of one dtype: exact integers for int8 and packed words.

``n_expand`` (E) expands the E best unexpanded candidates per iteration.

Filtered search (``filter_mask`` [cap] bool) restricts the *results*, not
the traversal: filtered nodes still route, and a result buffer of
KP = next_pow2(max(2 k, 4)) slots collects the mask-passing nodes of every
expanded window (``ops/beam.py``), so it sees every window's candidates,
not only the beam's survivors.
"""

from __future__ import annotations

import torch

from tpuvec_torch.index.graph import GraphState, HnswConfig
from tpuvec_torch.ops.beam import beam_loop, frontier, node_dist
from tpuvec_torch.ops.distance import internal_to_output

__all__ = [
    "search_graph", "search", "descend_to_level1", "beam_search_level0",
    "seed_beam", "default_max_iters",
]

_INF = float("inf")


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _node_dist(config: HnswConfig, state: GraphState, q: torch.Tensor, ids: torch.Tensor):
    """Internal distance q[b] -> node ids[b, M]; invalid ids -> inf."""
    return node_dist(config.graph_metric, config.normalized, state.vectors, q, ids)


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
    node_mask: torch.Tensor | None = None,
    k_out: int | None = None,
):
    """Best-first beam search at level 0.

    q [B, Dp] in the store dtype; seed_ids/seed_dists [B] from the
    descent. Returns
    (beam_d [B, EF] ascending, beam_i [B, EF], iters) in internal
    distance, with EF = next_pow2(ef); iters is the most iterations any
    query ran while active.

    With ``node_mask`` [cap] bool (filtered search) returns
    (res_d [B, KP], res_i [B, KP], iters) instead: the mask-passing nodes
    met, deduplicated and ascending, KP = next_pow2(max(2 k_out, 4));
    ``k_out`` is then required.
    """
    beam = seed_beam(seed_ids, seed_dists, ef=ef, n_expand=n_expand,
                     node_mask=node_mask, k_out=k_out)
    return beam_loop(
        q.contiguous(), state.vectors, state.adj0, *beam,
        metric=config.graph_metric, normalized=config.normalized, max_iters=max_iters,
        node_mask=node_mask,
    )


def seed_beam(seed_ids: torch.Tensor, seed_dists: torch.Tensor, *, ef: int, n_expand: int,
              node_mask: torch.Tensor | None = None, k_out: int | None = None):
    """The level-0 beam before its first iteration: the seed in slot 0 and
    +inf padding (marked expanded), with the first frontier selected and
    marked. Returns (beam_d, beam_i, beam_x [B, EF], cand [B, E], active [B]),
    the state ``beam_loop`` starts from. With ``node_mask`` it also returns
    the seeded result buffer (res_d, res_i [B, KP],
    KP = next_pow2(max(2 k_out, 4)): twice k, since a node evicted from
    the beam can be collected twice): the seed in slot 0 if it passes the
    mask, else (+inf, -1). ``k_out`` is required with ``node_mask``."""
    if node_mask is not None and k_out is None:
        raise ValueError("seed_beam: a node_mask needs k_out, the results wanted")
    b = seed_ids.shape[0]
    efp = _next_pow2(ef)
    dev = seed_ids.device
    beam_d = torch.full((b, efp), _INF, dtype=torch.float32, device=dev)
    beam_i = torch.full((b, efp), -1, dtype=torch.int32, device=dev)
    beam_x = torch.ones((b, efp), dtype=torch.bool, device=dev)  # padding = expanded
    beam_d[:, 0] = torch.where(seed_ids >= 0, seed_dists, _INF)
    beam_i[:, 0] = seed_ids
    beam_x[:, 0] = seed_ids < 0
    sel, cand, active = frontier(beam_d, beam_i, beam_x, n_expand)
    beam_x |= sel
    if node_mask is None:
        return beam_d, beam_i, beam_x, cand, active
    kp = _next_pow2(max(2 * k_out, 4))
    seed_ok = (seed_ids >= 0) & node_mask[seed_ids.clamp_min(0)]
    res_d = torch.full((b, kp), _INF, dtype=torch.float32, device=dev)
    res_i = torch.full((b, kp), -1, dtype=torch.int32, device=dev)
    res_d[:, 0] = torch.where(seed_ok, seed_dists, _INF)
    res_i[:, 0] = torch.where(seed_ok, seed_ids, -1)
    return beam_d, beam_i, beam_x, cand, active, res_d, res_i


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
    filter_mask: torch.Tensor | None = None,
):
    """Batched k-NN over the graph in *internal* distance space.

    q [B, Dp] must already be prepared (prepare_queries: the graph's store
    dtype) and lie on the graph's device. Returns (dists [B, k], ids [B, k]) ascending; empty
    index -> (inf, -1). ef defaults to max(ef_search, k).
    ``filter_mask`` [cap] bool restricts the results (not the traversal)
    to mask-passing nodes; slots past the ones found are (inf, -1).
    """
    ef = max(ef or config.ef_search, k)
    if max_iters is None:
        max_iters = default_max_iters(ef, n_expand)
    seed_ids, seed_d = descend_to_level1(config, state, q)
    beam_d, beam_i, _ = beam_search_level0(
        config, state, q, seed_ids, seed_d,
        ef=ef, max_iters=max_iters, n_expand=n_expand, node_mask=filter_mask, k_out=k,
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
