"""The port's tracing (``tpuvec_torch/utils/timing.py``) on the CPU at tiny
sizes: off records nothing and changes no result, spans nest under one
request, the descent's counters equal a plain recount, device spans fall
back to the host, and the dumped Chrome trace lines up with torch.profiler's."""

import json

import numpy as np
import pytest
import torch

from tpuvec_torch.index import search
from tpuvec_torch.index.build import build_graph
from tpuvec_torch.index.graph import config_for, prepare_queries, prepare_vectors
from tpuvec_torch.index.params import HnswParams
from tpuvec_torch.ops.beam import node_dist
from tpuvec_torch.ops.rerank import rerank_topk
from tpuvec_torch.types import DistanceMetric
from tpuvec_torch.utils import timing

DIM, ROWS, QUERIES = 16, 240, 12


@pytest.fixture(scope="module")
def graph():
    """(config, state, prepared queries) of a 240-row graph with upper levels."""
    cfg = config_for(DIM, cap=256, params=HnswParams(m=4, max_m0=8, ef_construction=32))
    rng = np.random.default_rng(14)
    x = prepare_vectors(cfg, rng.standard_normal((ROWS, DIM)), device="cpu")
    state = build_graph(cfg, x, max_batch=64, device="cpu")
    q = prepare_queries(cfg, rng.standard_normal((QUERIES, DIM)), device="cpu")
    return cfg, state, q


@pytest.fixture
def traced():
    """Tracing on for the test, off and empty after it."""
    timing.reset()
    timing.enable()
    try:
        yield
    finally:
        timing.disable()
        timing.reset()


def test_off_records_nothing_and_results_equal_traced(graph):
    cfg, state, q = graph
    timing.reset()
    d_off, i_off = search.search_graph(cfg, state, q, k=5, ef=16)
    assert timing.stats() == {} and timing.records() == []
    assert timing.span("a") is timing.span("b")  # one shared no-op
    timing.enable()
    try:
        d_on, i_on = search.search_graph(cfg, state, q, k=5, ef=16)
        stats = timing.stats()
    finally:
        timing.disable()
        timing.reset()
    assert torch.equal(d_off, d_on) and torch.equal(i_off, i_on)
    assert stats["search"][1] == 1 and stats["search.descent"][1] == 1
    assert not hasattr(timing, "add")


def test_spans_nest_under_requests(traced):
    with timing.request() as rid:
        with timing.span("outer"):
            with timing.span("inner"):
                sum(range(20_000))
            with timing.span("inner"):
                pass
            timing.count("things", 3)
            timing.count("things")
    with timing.span("root_a"):
        pass
    with timing.span("root_b"):
        pass
    by_name = {}
    for r in timing.records():
        by_name.setdefault(r["name"], []).append(r)
    outer = by_name["outer"][0]
    inners = by_name["inner"]
    assert outer["parent"] == 0 and all(r["parent"] == outer["id"] for r in inners)
    assert {r["request"] for r in inners + [outer]} == {rid}
    dur = outer["end_ns"] - outer["start_ns"]
    assert outer["self_ns"] == dur - sum(r["end_ns"] - r["start_ns"] for r in inners)
    a, b = by_name["root_a"][0], by_name["root_b"][0]
    assert len({a["request"], b["request"], rid}) == 3
    stats = timing.stats()
    assert stats["things"] == (4, 2) and stats["inner"][1] == 2


def _recount(cfg, state, q):
    """Each query's greedy descent alone, as plain Python: the batch's
    steps at a level are the most moves any query made there plus the step
    in which none moved."""
    top = min(cfg.lu, int(state.entry_level))
    m, steps, moved = cfg.m, 0, 0
    cur = [int(state.entry_point)] * q.shape[0]
    for lev in range(top, 0, -1):
        most = 0
        for b in range(q.shape[0]):
            qb = q[b:b + 1]
            d = float(node_dist(cfg.graph_metric, cfg.normalized, state.vectors, qb,
                                torch.tensor([[cur[b]]]))[0, 0])
            moves = 0
            while True:
                slot = int(state.upper_slot[cur[b]])
                nbrs = state.upper_adj[slot, (lev - 1) * m:lev * m] if slot >= 0 else torch.full((m,), -1)
                nd = node_dist(cfg.graph_metric, cfg.normalized, state.vectors, qb, nbrs[None].to(torch.int32))[0]
                j = int(torch.argmin(nd))
                if not float(nd[j]) < d:
                    break
                cur[b], d, moves = int(nbrs[j]), float(nd[j]), moves + 1
            most = max(most, moves)
            moved += moves
        steps += most + 1
    return steps, moved


def test_descent_counters_match_a_recount(graph, traced):
    cfg, state, q = graph
    assert int(state.entry_level) >= 2  # the graph has levels to descend
    search.descend_to_level1(cfg, state, q)
    stats = timing.stats()
    steps, moved = _recount(cfg, state, q)
    assert stats["descent.steps"][0] == steps
    assert stats["descent.moved"][0] == moved
    assert stats["descent.query_steps"][0] == steps * QUERIES
    # host reads: the entry level, one a step, and the steps' moved counts
    assert stats["search.descent.sync"][1] == steps + 2


def test_device_span_on_the_cpu_is_its_host_time(traced):
    with timing.span("work", device=True):
        sum(range(10_000))
    with timing.span("tensor_work", device=torch.zeros(2)):
        pass
    stats = timing.stats()
    assert stats["work.device"] == stats["work"] and stats["work"][1] == 1
    assert stats["tensor_work.device"] == stats["tensor_work"]


def test_rerank_spans(traced):
    g = torch.Generator().manual_seed(3)
    shadow = torch.randn(64, DIM, generator=g)
    slots = torch.randint(0, 64, (4, 10), generator=g)
    rerank_topk(shadow, slots, slots >= 0, torch.randn(4, DIM, generator=g),
                metric=DistanceMetric.COSINE, k=3)
    stats = timing.stats()
    assert stats["rerank.topk"][1] == 1 and stats["rerank.gather.device"][1] == 1
    gather = [r for r in timing.records() if r["name"] == "rerank.gather"]
    topk = [r for r in timing.records() if r["name"] == "rerank.topk"]
    assert gather[0]["parent"] == topk[0]["id"]


def test_dump_writes_a_nested_chrome_trace(graph, traced, tmp_path):
    cfg, state, q = graph
    search.search_graph(cfg, state, q, k=5, ef=16)
    timing.dump(str(tmp_path / "spans.json"))
    trace = json.loads((tmp_path / "spans.json").read_text())
    events = trace["traceEvents"]
    assert events and all(e["ph"] == "X" for e in events)
    by_id = {e["args"]["id"]: e for e in events}
    root = [e for e in events if e["args"]["parent"] == 0]
    assert [e["name"] for e in root] == ["search"]
    for e in events:
        assert e["args"]["request"] == root[0]["args"]["request"]
        p = by_id.get(e["args"]["parent"])
        if p is not None:
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    names = {e["name"] for e in events}
    assert {"search", "search.descent", "search.descent.sync"} <= names


def test_spans_line_up_with_the_profiler_trace(graph, traced, tmp_path):
    """Each dumped span lies inside its profiler range (the span opens
    inside it), to within 1 ms: the two clocks agree within 1 ms either
    way, whatever delays fall between a range's timestamp and its span's."""
    cfg, state, q = graph
    with timing.trace(str(tmp_path / "prof.json")):
        search.search_graph(cfg, state, q, k=5, ef=16)
    timing.dump(str(tmp_path / "spans.json"))
    prof = json.loads((tmp_path / "prof.json").read_text())
    spans = json.loads((tmp_path / "spans.json").read_text())

    def intervals(trace, cat=None):
        """Each name's (start, end) on the wall clock (us), in order."""
        base, out = trace["baseTimeNanoseconds"] / 1e3, {}
        for e in trace["traceEvents"]:
            if e.get("ph") == "X" and (cat is None or e.get("cat") == cat):
                out.setdefault(e["name"], []).append((e["ts"] + base, e["ts"] + base + e["dur"]))
        return {name: sorted(v) for name, v in out.items()}

    in_prof = intervals(prof, "user_annotation")
    dumped = intervals(spans)
    assert set(dumped) == {"search", "search.descent", "search.descent.sync"}
    for name, spans_of_name in dumped.items():
        assert len(in_prof[name]) == len(spans_of_name)
        for (p0, p1), (s0, s1) in zip(in_prof[name], spans_of_name):
            assert p0 - 1e3 <= s0 and s1 <= p1 + 1e3  # us
