"""Ingest traffic: one client in a closed loop inserts rows of the seeded
corpus into the port's HNSW graph, ``rows_per_call`` rows a call, and waits
for each call to finish on the card (the insert is then acknowledged).

The traffic mix (``traffic/<name>.json``) gives ``rows_per_call``,
``graph_cap`` (the graph's capacity; the corpus holds that many rows),
``max_batch`` (``build_graph``'s), and what the reference checks:
``judge_queries`` fresh queries searched plainly over the grown graph at
``judge_ef``, and the edges of ``judge_nodes`` nodes drawn from the seed;
``assumed`` (optional) says in words what the mix assumes and is not read.

Each call is ``prepare_vectors`` + ``build_graph(rows, ids=, state=,
start_size=count, max_batch=)``, so the port's own doubling schedule opens
an empty graph. When the graph is full, a fresh empty graph takes the
next rows (the corpus from its first row again), inside the window.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference import checks, exact, plain_loop
from portbench.reference.data import Manifold, subseed

UNIT = "rows"
# the traffic mix's keys this driver reads (the harness refuses others)
MIX_KEYS = {"driver", "rows_per_call", "graph_cap", "max_batch", "judge_queries", "judge_ef", "judge_nodes",
            "assumed"}
SPANS = [
    ("tpuvec_torch.index.build", "_stage_write", "insert.write", False),
    ("tpuvec_torch.index.build", "_stage_candidates", "insert.candidates", False),
    ("tpuvec_torch.index.build", "_stage_upper", "insert.upper", False),
    ("tpuvec_torch.index.build", "_stage_connect", "insert.connect", False),
]
# judge queries a plain search and an exact scan take at once
_JUDGE_BLOCK = 4096


@dataclass
class State:
    env: object
    manifold: Manifold
    corpus: torch.Tensor
    cfg: object
    graphs: list = field(default_factory=list)  # [graph state, rows in it]


def _hnsw_config(config: dict, mix: dict):
    from tpuvec_torch.index.graph import config_for
    from tpuvec_torch.index.params import HnswParams
    from tpuvec_torch.types import DistanceMetric, IndexQuantization

    if config["metric"] != "cosine" or config["quantization"] != "none":
        raise ValueError("ingest serves float32 cosine configurations")
    h = config["hnsw"]
    params = HnswParams(m=h["m"], max_m0=h["max_m0"], ef_construction=h["ef_construction"])
    return config_for(config["dim"], metric=DistanceMetric.COSINE,
                      quantization=IndexQuantization.NONE, params=params, cap=mix["graph_cap"])


def setup(env) -> State:
    """The corpus, one warm-up call of the cell's shape into a graph that is
    then dropped, and the window's first, empty graph."""
    from tpuvec_torch.index.graph import allocate

    config, mix, dev = env.config, env.mix, env.device
    if mix["graph_cap"] % mix["rows_per_call"]:
        raise ValueError("ingest: rows_per_call must divide graph_cap")
    manifold = Manifold(config["dim"], config["data"], dev)
    corpus = manifold.rows(mix["graph_cap"], subseed(env.seed, "corpus"))
    cfg = _hnsw_config(config, mix)
    state = State(env, manifold, corpus, cfg)
    state.graphs = [[allocate(cfg, device=dev), 0]]
    serve(state, request(state, 0))
    state.graphs = [[allocate(cfg, device=dev), 0]]
    return state


def request(state: State, j: int):
    """Call j's rows: (first row, raw rows [rows_per_call, dim])."""
    r = state.env.mix["rows_per_call"]
    start = (j * r) % state.env.mix["graph_cap"]
    return start, state.corpus[start:start + r]


def serve(state: State, req) -> int:
    """Insert the rows (a fresh graph first when the last one is full) and
    wait for the card: the rows acknowledged."""
    from tpuvec_torch.index import build
    from tpuvec_torch.index.graph import allocate, prepare_vectors

    start, rows = req
    dev = state.env.device
    if start == 0 and state.graphs[-1][1]:
        # keep the fullest graph for the reference, and the one being grown
        state.graphs = [max(state.graphs, key=lambda g: g[1]), [allocate(state.cfg, device=dev), 0]]
    graph = state.graphs[-1]
    with state.env.spans.span("prepare"):
        xp = prepare_vectors(state.cfg, rows, device=dev)
    ids = np.arange(start, start + rows.shape[0], dtype=np.int32)
    graph[0] = build.build_graph(state.cfg, xp, ids, state=graph[0], start_size=graph[1],
                                 max_batch=state.env.mix["max_batch"], device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    graph[1] += rows.shape[0]
    return rows.shape[0]


def units(answer) -> int:
    return answer


def _edges(graph, nodes: torch.Tensor, cfg):
    """(u, v, stored distance) of every level-0 and upper edge of ``nodes``."""
    adj, dist = graph.adj0[nodes], graph.adj0_dist[nodes]
    us = [nodes[:, None].expand_as(adj)]
    vs, ds = [adj], [dist]
    slots = graph.upper_slot[nodes]
    up = slots >= 0
    if bool(up.any()):
        s = slots[up]
        us.append(nodes[up][:, None].expand(-1, graph.upper_adj.shape[1]))
        vs.append(graph.upper_adj[s])
        ds.append(graph.upper_dist[s])
    u = torch.cat([x.reshape(-1) for x in us])
    v = torch.cat([x.reshape(-1) for x in vs])
    d = torch.cat([x.reshape(-1) for x in ds])
    ok = v >= 0
    return u[ok].long(), v[ok].long(), d[ok]


def judge(state: State, window, *, control: bool = False) -> dict:
    """The fullest graph the window grew against the reference: every row
    acknowledged is in it; the stored distance of every edge of the sampled
    nodes against the float64 distance of its two rows (``control``: the
    reference's TF32 distances in the program's place); recall@10 of a
    plain search over it, on the reference's own unit rows, against the
    exact top-10 of its rows."""
    mix, cfg, dev = state.env.mix, state.cfg, state.env.device
    graph, g = max(state.graphs, key=lambda x: x[1])
    state.graphs = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    missing = int((graph.levels[:g] < 0).sum()) + abs(int(graph.count) - g)
    rng = random.Random(subseed(state.env.seed, "judge"))
    nodes = torch.tensor(sorted(rng.sample(range(g), min(g, mix["judge_nodes"]))),
                         dtype=torch.int64, device=dev)
    u, v, stored = _edges(graph, nodes, cfg)
    dangling = bool(((v >= g) | (graph.levels[v.clamp_max(cfg.cap - 1)] < 0)).any())
    v = v.clamp_max(g - 1)
    ref = exact.pair_sq_l2(state.corpus[u], state.corpus[v])
    if control:
        stored = exact.pair_sq_l2(state.corpus[u], state.corpus[v], tf32=True)
    gap = float((stored.to(torch.float64) - ref).abs().max()) if u.numel() else float("nan")
    if dangling:
        gap = float("inf")
    q = state.manifold.rows(mix["judge_queries"], subseed(state.env.seed, "judge_queries"))
    rows = exact.unit(state.corpus[:g])
    fields = {"entry_point": graph.entry_point, "entry_level": graph.entry_level,
              "upper_slot": graph.upper_slot, "upper_adj": graph.upper_adj, "adj0": graph.adj0,
              "m": cfg.m, "lu": cfg.lu}
    got, want = [], []
    for s in range(0, q.shape[0], _JUDGE_BLOCK):
        qb = q[s:s + _JUDGE_BLOCK]
        got.append(plain_loop.search(fields, rows, exact.unit(qb), k=10, ef=mix["judge_ef"]).cpu().numpy())
        want.append(exact.cosine_topk(qb, state.corpus[:g], 10)[1].cpu().numpy())
    rec = checks.recall(np.concatenate(got), np.concatenate(want))
    return {
        "attempted": int(sum(window.units)),
        "failed": missing,
        "graph_rows": g,
        "checks": [
            checks.check("missing", missing, 0),
            checks.check("edge_dist_gap", gap, checks.EDGE_DIST_GAP),
            checks.check("graph_recall_at_10", rec, state.env.config["recall_floor"], at_most=False),
        ],
    }
