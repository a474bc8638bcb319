"""Batched HNSW construction.

Inserts land in mini-batches, each in four stages (``insert_batch``):

* write: vectors and levels, compact upper-level slots;
* candidates: greedy descent plus the level-0 construction beam over the
  pre-batch graph (``beam_search_level0``, so through the beam kernel);
* upper: exact upper-level neighbor selection over the compact upper pool
  (only ~1/M of nodes reach level 1) with reverse edges;
* connect: level-0 forward selection by the RNG diversity heuristic, then
  reverse edges with a protected-prefix prune, entry point and count.

Batch members do not see each other in the level-0 graph; the doubling
batch schedule keeps each batch no larger than the graph it joins. Levels
are a pure function of the node id (``utils/prng.py``), computed on the
host. The stages update the graph's tensors in place, and so does
``delete_ids``.

Every write aimed at a padding row (id -1, an overflowing upper slot, a
non-leader reverse row) is masked explicitly in ``_write_rows``, and
every gather index that can be -1 or out of range is clamped first.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvec_torch.device import resolve
from tpuvec_torch.index.bruteforce import bruteforce_knn_internal
from tpuvec_torch.index.graph import GraphState, HnswConfig, allocate, as_store_tensor
from tpuvec_torch.index.search import (
    beam_search_level0,
    default_max_iters,
    descend_to_level1,
)
from tpuvec_torch.ops.distance import hamming_pairwise
from tpuvec_torch.types import DistanceMetric
from tpuvec_torch.utils import timing
from tpuvec_torch.utils.prng import sample_levels_np

__all__ = ["insert_batch", "build_graph", "delete_ids", "plan_batch_sizes", "heuristic_select"]

_INF = float("inf")
_I32 = torch.int32


def _write_rows(dst: torch.Tensor, rows: torch.Tensor, values: torch.Tensor, ok: torch.Tensor):
    """dst[rows[ok]] = values[ok], in place: the one masked row write
    (rows may hold padding targets where ``ok`` is false)."""
    dst[rows[ok].long()] = values[ok]


def _smallest(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest (d, id) pairs per row, ascending; (+inf, -1) past
    the valid ones. Stable, so ties keep their column order."""
    sd, order = torch.sort(d, dim=1, stable=True)
    sd = sd[:, :k]
    si = torch.gather(ids, 1, order[:, :k])
    return sd, torch.where(torch.isfinite(sd), si, -1)


def _pairwise_cands(config: HnswConfig, cvecs: torch.Tensor) -> torch.Tensor:
    """Pairwise internal-metric distances among candidates:
    [nb, C, Dp] -> [nb, C, C], in the units of the beam's distances
    (heuristic_select compares the two directly)."""
    metric = config.graph_metric
    if metric is DistanceMetric.HAMMING:
        return hamming_pairwise(cvecs, cvecs)  # batched: one exact product
    ci = cvecs.to(torch.float32)  # int8 rows too, as the JAX package does
    if metric is DistanceMetric.L1:
        # no [nb, C, C, Dp] broadcast: at the build's batch that is tens of GB
        return torch.cdist(ci, ci, p=1.0)
    dots = torch.bmm(ci, ci.transpose(1, 2))
    if metric is DistanceMetric.COSINE and not config.normalized:
        norms = torch.sqrt((ci * ci).sum(-1))
        denom = norms[:, :, None] * norms[:, None, :]
        ok = denom > 0
        sim = torch.where(ok, dots / torch.where(ok, denom, torch.ones_like(denom)), 0.0)
        return 1.0 - sim
    norms = (ci * ci).sum(-1)  # L2 / normalized cosine: squared L2
    return torch.clamp_min(norms[:, :, None] + norms[:, None, :] - 2.0 * dots, 0.0)


def heuristic_select(
    config: HnswConfig,
    cand_d: torch.Tensor,   # [nb, C] ascending (inf = invalid)
    cand_i: torch.Tensor,   # [nb, C]
    cvecs: torch.Tensor,    # [nb, C, Dp]
    max_conn: int,
):
    """RNG diversity neighbor selection, batched.

    Walk candidates in distance order and keep c only if it is closer to
    the new node than to every already-kept neighbor; then fill the
    remaining slots with the closest rejected candidates. Runs as
    max_conn next-survivor steps over [nb, C] masks with a precomputed
    candidate-pairwise matrix: kept positions strictly increase, every
    candidate before the next survivor is rejected against a mind[] that
    only shrinks afterwards, so this equals the per-candidate scan.
    Returns (sel_d, sel_i) [nb, max_conn]: kept by distance, then
    rejected by distance, then (+inf, -1).
    """
    nb, c = cand_d.shape
    pair = _pairwise_cands(config, cvecs)
    valid = torch.isfinite(cand_d)
    iota_c = torch.arange(c, device=cand_d.device).expand(nb, c)
    rows = torch.arange(nb, device=cand_d.device)
    mask = torch.zeros((nb, c), dtype=torch.bool, device=cand_d.device)
    mind = torch.full((nb, c), _INF, dtype=torch.float32, device=cand_d.device)
    for _ in range(min(max_conn, c)):
        alive = valid & (cand_d < mind) & ~mask
        p = torch.where(alive, iota_c, c).amin(dim=1)  # first alive
        has = p < c
        pc = p.clamp_max(c - 1)
        mask |= has[:, None] & (iota_c == pc[:, None])
        mind = torch.where(has[:, None], torch.minimum(mind, pair[rows, pc]), mind)
    # kept first, then rejected, then invalid, each by distance: the keys
    # are unique, so any sort gives the same order
    group = torch.where(mask, 0, torch.where(valid, 1, 2))
    order = torch.argsort(group * c + iota_c, dim=1)[:, :max_conn]
    sel_d = torch.gather(cand_d, 1, order)
    sel_i = torch.gather(cand_i, 1, order)
    return sel_d, torch.where(torch.isfinite(sel_d), sel_i, -1)


def _stage_write(
    config: HnswConfig,
    state: GraphState,
    new_ids: torch.Tensor,
    new_vecs: torch.Tensor,
    new_levels: torch.Tensor,
) -> GraphState:
    """Stage 1: write vectors + levels, allocate compact upper slots.
    Nodes that find no free upper slot are demoted to level 0."""
    c = config
    ok_new = new_ids >= 0
    new_levels = torch.where(ok_new, new_levels.clamp_max(c.lu), -1)
    is_up = ok_new & (new_levels >= 1)
    slot_off = torch.cumsum(is_up.to(_I32), dim=0, dtype=_I32) - 1
    slot = torch.where(is_up, state.upper_count + slot_off, -1)
    overflow = slot >= c.cap_u
    slot = torch.where(overflow, -1, slot)
    new_levels = torch.where(overflow, 0, new_levels)
    _write_rows(state.vectors, new_ids, new_vecs.to(state.vectors.dtype), ok_new)
    _write_rows(state.levels, new_ids, new_levels.clamp_min(0), ok_new)
    _write_rows(state.upper_slot, new_ids, slot, ok_new)
    _write_rows(state.upper_nodes, slot, new_ids, slot >= 0)
    state.upper_count = state.upper_count + (is_up & ~overflow).sum(dtype=_I32)
    return state


def _batch_levels(config: HnswConfig, state: GraphState, new_ids: torch.Tensor):
    """Recover the (possibly demoted) levels of this batch from state."""
    return torch.where(new_ids >= 0, state.levels[new_ids.clamp_min(0)], -1)


def _build_iter_budget(cap: int, efc: int, n_expand: int) -> int:
    """Construction-beam iteration budget: the generic default, capped by
    ceil(7*ln(cap)) + 8, since navigation work grows with graph depth
    (57 at 1K, 89 at 100K, 105 at 1M)."""
    depth_budget = int(np.ceil(7.0 * np.log(max(cap, 2)))) + 8
    return min(default_max_iters(efc, n_expand), depth_budget)


def _stage_candidates(config: HnswConfig, state: GraphState, new_vecs: torch.Tensor):
    """Stage 2: level-0 candidate beam over the pre-batch graph
    (EF = next_pow2(ef_construction), E = 2)."""
    c = config
    seed_ids, seed_d = descend_to_level1(config, state, new_vecs)
    efc = max(c.ef_construction, c.max_m0)
    cand_d, cand_i, _ = beam_search_level0(
        config,
        state,
        new_vecs,
        seed_ids,
        seed_d,
        ef=efc,
        max_iters=c.build_max_iters or _build_iter_budget(c.cap, efc, 2),
        n_expand=2,
    )
    return cand_d, cand_i


def _stage_upper(
    config: HnswConfig,
    state: GraphState,
    new_ids: torch.Tensor,
    new_vecs: torch.Tensor,
    *,
    width: int | None = None,
) -> GraphState:
    """Stage 3: upper-level edges by exact selection over the compact
    upper pool, plus reverse edges (no protected prefix).

    The batch is compacted to its level >= 1 members, in batch order, and
    only the first ``k_up`` of them get upper edges, as in the JAX package
    (``tpuvec/index/build.py:266-276``): k_up = width if width <= 256 else
    max(256, width // 4), where ``width`` is the JAX package's padded batch
    width (``build_graph``'s ``max_batch``; default the batch's length).
    The rows past k_up keep their level and upper slot but get no upper
    out-edges and cause no reverse edges. The members' top level is read to
    the host once: a level no member reaches runs nothing.
    """
    c = config
    width = new_ids.shape[0] if width is None else width
    k_up = width if width <= 256 else max(256, width // 4)
    new_levels = _batch_levels(config, state, new_ids)
    sub = torch.nonzero((new_ids >= 0) & (new_levels >= 1))[:k_up, 0]
    if sub.numel() == 0:
        return state
    new_ids, new_vecs, new_levels = new_ids[sub], new_vecs[sub], new_levels[sub]
    top = int(new_levels.max())
    slot = state.upper_slot[new_ids]

    nodes = state.upper_nodes
    pool_vecs = state.vectors[nodes.clamp_min(0)]  # [cap_u, Dp]
    pool_levels = torch.where(nodes >= 0, state.levels[nodes.clamp_min(0)], -1)
    heur = not c.simple_prune
    kc = (2 * c.m + 1) if heur else (c.m + 1)
    for lev in range(1, top + 1):
        at_lev = new_levels >= lev
        d_sel, slot_sel = bruteforce_knn_internal(
            new_vecs, pool_vecs, pool_levels >= lev,
            metric=c.graph_metric, k=kc, normalized=c.normalized,
        )  # ids are slot indices
        nbr_ids = torch.where(slot_sel >= 0, nodes[slot_sel.clamp_min(0)], -1)
        is_self = nbr_ids == new_ids[:, None]
        d_sel = torch.where(is_self, _INF, d_sel)
        nbr_ids = torch.where(is_self, -1, nbr_ids)
        if heur:
            cvecs = state.vectors[nbr_ids.clamp_min(0)]
            sel_d, sel_i = heuristic_select(config, d_sel, nbr_ids, cvecs, c.m)
        else:
            sel_d, sel_i = _smallest(d_sel, nbr_ids, c.m)

        lo, hi = (lev - 1) * c.m, lev * c.m
        adj_l = state.upper_adj[:, lo:hi]  # views: writes land in state
        dist_l = state.upper_dist[:, lo:hi]
        _write_rows(adj_l, slot, sel_i, at_lev)
        _write_rows(dist_l, slot, sel_d, at_lev)
        s_slots = torch.where(sel_i >= 0, state.upper_slot[sel_i.clamp_min(0)], -1)
        tgt, rows, rowsd = _reverse_compute(
            adj_l, dist_l, new_ids, s_slots, sel_d, at_lev, c.cap_u, c.m, protect=0
        )
        _write_rows(adj_l, tgt, rows, tgt < c.cap_u)
        _write_rows(dist_l, tgt, rowsd, tgt < c.cap_u)
    return state


def _reverse_compute(adj, adj_dist, new_ids, fwd_i, fwd_d, ok_new, cap, max_conn, protect):
    """Reverse-edge insertion with protected-prefix pruning.

    The first `protect` slots of each row hold the row owner's own
    heuristic-selected forward edges and are never evicted by reverse
    edges; without that, closest-only reverse pruning turns every row
    into its local kNN set and level 0 falls apart into small components.

    For every (neighbor s <- new u) pair: group the pairs by s (stable
    sort by distance, then stable sort by s), and let each group's leader
    merge its first `keep` entrants into s's suffix, keeping the smallest
    `keep`. Keep-smallest is order-independent, so this equals inserting
    the entrants one at a time. Returns (tgt, rows, rowsd): only leaders
    have tgt < cap, and their s are unique.
    """
    nb, m0 = fwd_i.shape
    keep = max_conn - protect
    p_n = nb * m0
    dev = fwd_i.device

    s = fwd_i.reshape(p_n)
    u = new_ids.repeat_interleave(m0)
    d = fwd_d.reshape(p_n)
    ok = (s >= 0) & torch.isfinite(d) & ok_new.repeat_interleave(m0)
    big = cap + 1
    s_key = torch.where(ok, s, big)

    # stable group-by on (s, d): a stable sort by the minor key, then a
    # stable sort by the major key
    by_d = torch.sort(d, stable=True).indices
    order = by_d[torch.sort(s_key[by_d], stable=True).indices]
    s_s, d_s, u_s = s_key[order], d[order], u[order]

    # (the reference also ranks each entrant within its group with a
    # cummax of group starts, but never reads the rank: only leaders act)
    start = torch.ones(p_n, dtype=torch.bool, device=dev)
    start[1:] = s_s[1:] != s_s[:-1]
    leader = start & (s_s < big)

    # entrant window per leader: positions [i, i + keep)
    pos = torch.arange(p_n, device=dev)[:, None] + torch.arange(keep, device=dev)[None, :]
    win = pos.clamp_max(p_n - 1)
    win_same = (s_s[win] == s_s[:, None]) & (pos < p_n)
    ent_d = torch.where(win_same, d_s[win], _INF)
    ent_i = torch.where(win_same, u_s[win], -1)

    # merge with the old suffix and keep the smallest `keep`
    row = s_s.clamp_max(cap - 1)
    cat_i = torch.cat([adj[row][:, protect:], ent_i], dim=1)
    cat_d = torch.cat([adj_dist[row][:, protect:], ent_d], dim=1)
    new_rowsd, new_rows = _smallest(cat_d, cat_i, keep)
    tgt = torch.where(leader, s_s, cap)  # only leaders write
    return tgt, new_rows, new_rowsd


def _stage_connect(
    config: HnswConfig,
    state: GraphState,
    new_ids: torch.Tensor,
    cand_d: torch.Tensor,
    cand_i: torch.Tensor,
) -> GraphState:
    """Stage 4: level-0 forward selection (diversity heuristic), reverse
    edges with a protected prefix, entry point + count update."""
    c = config
    ok_new = new_ids >= 0
    new_levels = _batch_levels(config, state, new_ids)

    # candidates come from the pre-batch graph, so a node cannot find
    # itself; the self mask is defense in depth
    self_hit = cand_i == new_ids[:, None]
    cand_d = torch.where(self_hit, _INF, cand_d)
    cand_i = torch.where(self_hit, -1, cand_i)
    if not c.simple_prune:
        cw = min(cand_d.shape[1], 192)  # bounds the pairwise matrix
        cvecs = state.vectors[cand_i[:, :cw].clamp_min(0)]
        fwd_d, fwd_i = heuristic_select(
            config, cand_d[:, :cw], cand_i[:, :cw], cvecs, c.max_m0
        )
    else:
        fwd_d, fwd_i = _smallest(cand_d, cand_i, c.max_m0)
    _write_rows(state.adj0, new_ids, fwd_i, ok_new)
    _write_rows(state.adj0_dist, new_ids, fwd_d, ok_new)

    protect = min(c.m, c.max_m0 // 2)
    tgt, rows, rowsd = _reverse_compute(
        state.adj0, state.adj0_dist, new_ids, fwd_i, fwd_d, ok_new,
        c.cap, c.max_m0, protect,
    )
    _write_rows(state.adj0[:, protect:], tgt, rows, tgt < c.cap)
    _write_rows(state.adj0_dist[:, protect:], tgt, rowsd, tgt < c.cap)

    lv_masked = torch.where(ok_new, new_levels, -1)
    new_max = lv_masked.max()
    best = new_ids[torch.argmax(lv_masked)]
    upgrade = new_max > state.entry_level
    state.entry_point = torch.where(upgrade, best, state.entry_point)
    state.entry_level = torch.where(upgrade, new_max, state.entry_level)
    state.count = state.count + ok_new.sum(dtype=_I32)
    return state


def _sync_if_timed(state: GraphState) -> None:
    """Wait for the card when timing is on, so a stage's timer holds its
    device time; no cost when timing is off."""
    if timing.enabled() and state.count.is_cuda:
        torch.cuda.synchronize(state.count.device)


def insert_batch(
    config: HnswConfig,
    state: GraphState,
    new_ids: torch.Tensor,     # [nb] i32, -1 = padding
    new_vecs: torch.Tensor,    # [nb, Dp] already prepared (prepare_vectors)
    new_levels: torch.Tensor,  # [nb] i32 (from sample_levels_np; ignored for pads)
    *,
    width: int | None = None,
) -> GraphState:
    """Insert a mini-batch of nodes, updating ``state`` in place (and
    returning it). The candidate search runs against the pre-batch graph:
    new upper slots exist but have no in-edges yet. ``width`` is the JAX
    package's padded batch width, which caps the upper stage (``_stage_upper``);
    it defaults to the batch's length. Each stage runs under a
    ``utils/timing.py`` timer (``insert.write``, ``.candidates``, ``.upper``,
    ``.connect``)."""
    with timing.timer("insert.write"):
        state = _stage_write(config, state, new_ids, new_vecs, new_levels)
        _sync_if_timed(state)
    with timing.timer("insert.candidates"):
        cand_d, cand_i = _stage_candidates(config, state, new_vecs)
        _sync_if_timed(state)
    with timing.timer("insert.upper"):
        state = _stage_upper(config, state, new_ids, new_vecs, width=width)
        _sync_if_timed(state)
    with timing.timer("insert.connect"):
        state = _stage_connect(config, state, new_ids, cand_d, cand_i)
        _sync_if_timed(state)
    return state


def plan_batch_sizes(total: int, max_batch: int = 1024, start: int = 1) -> list[int]:
    """Doubling schedule of live batch sizes: 1, 1, 2, 4, ... up to
    max_batch, so every batch is no larger than the graph it is inserted
    into (bounds within-batch staleness). ``start`` seeds the schedule
    with the current graph size for incremental inserts."""
    sizes = []
    done = 0
    b = max(1, min(start, max_batch))
    while done < total:
        take = min(b, total - done)
        sizes.append(take)
        done += take
        b = min(max(b * 2, 1), max_batch)
    return sizes


def build_graph(
    config: HnswConfig,
    vectors_prepared,
    ids: np.ndarray | None = None,
    *,
    max_batch: int = 1024,
    state: GraphState | None = None,
    start_size: int = 1,
    device: str | torch.device = "cuda",
) -> GraphState:
    """Build a graph over prepared vectors [N, Dp] (numpy or tensor; packed
    words may come as uint32 and are viewed as int32) on ``device``, in doubling mini-batches. ``start_size`` seeds the
    schedule with the current graph size when inserting into an existing
    ``state``. Batches are not padded to one shape: torch runs eagerly and
    has nothing to recompile. Each batch's upper stage is capped as for the
    JAX package's padded width ``max_batch`` (``_stage_upper``)."""
    dev = resolve(device)
    x = as_store_tensor(vectors_prepared, device=dev).to(config.store_dtype)
    n = x.shape[0]
    ids = np.arange(n, dtype=np.int32) if ids is None else np.asarray(ids, dtype=np.int32)
    if state is None:
        state = allocate(config, device=dev)
    levels = sample_levels_np(
        np.maximum(ids, 0), config.rng_seed, config.level_factor, config.lu
    )
    ids_t = torch.as_tensor(ids, device=dev)
    levels_t = torch.as_tensor(levels, device=dev)
    pos = 0
    for take in plan_batch_sizes(n, max_batch, start=start_size):
        sl = slice(pos, pos + take)
        state = insert_batch(config, state, ids_t[sl], x[sl], levels_t[sl], width=max_batch)
        pos += take
    return state


def delete_ids(config: HnswConfig, state: GraphState, ids: torch.Tensor) -> GraphState:
    """Delete nodes (ids i32 [n], -1 = padding), in place on the state's
    device, as ``tpuvec/index/build.py:delete_ids`` does: each node loses
    its level, upper slot and level-0 and upper rows (-1 / +inf); its upper
    slot is freed in ``upper_nodes`` (``upper_count`` stays: slots are not
    reused); every edge to it is scrubbed; a deleted entry point is
    replaced by the first live node of the highest level (or -1 when none
    is live). ``count`` drops by the ids that were live, counted per entry
    of ``ids``: as in the JAX package, an id listed twice is subtracted
    twice. Returns ``state``."""
    c = config
    if ids.numel() == 0:
        return state
    ok = ids >= 0
    safe = ids.clamp_min(0)
    was_live = ok & (state.levels[safe] >= 0)
    slots = torch.where(ok, state.upper_slot[safe], -1)
    entry_deleted = (ok & (ids == state.entry_point)).any()

    _write_rows(state.levels, ids, torch.full_like(ids, -1), ok)
    _write_rows(state.upper_slot, ids, torch.full_like(ids, -1), ok)
    _write_rows(state.upper_nodes, slots, torch.full_like(slots, -1), slots >= 0)
    state.adj0[ids[ok].long()] = -1
    state.adj0_dist[ids[ok].long()] = _INF
    state.upper_adj[slots[slots >= 0].long()] = -1
    state.upper_dist[slots[slots >= 0].long()] = _INF

    # scrub inbound edges: a sorted search per cell, no [cap, M0, n] broadcast
    deleted = torch.sort(torch.where(ok, ids, torch.iinfo(torch.int32).max)).values
    for adj, dist in ((state.adj0, state.adj0_dist), (state.upper_adj, state.upper_dist)):
        pos = torch.searchsorted(deleted, adj).clamp_max(deleted.numel() - 1)
        hit = (deleted[pos] == adj) & (adj >= 0)
        adj.masked_fill_(hit, -1)
        dist.masked_fill_(hit, _INF)

    # argmax gives the first live node of the highest level (absent: -1)
    any_live = (state.levels >= 0).any()
    new_entry = torch.argmax(state.levels).to(_I32)
    new_level = state.levels.max()
    state.entry_point = torch.where(
        entry_deleted, torch.where(any_live, new_entry, -1), state.entry_point
    ).to(_I32)
    state.entry_level = torch.where(
        entry_deleted, torch.where(any_live, new_level, -1), state.entry_level
    ).to(_I32)
    state.count = state.count - was_live.sum(dtype=_I32)
    return state
