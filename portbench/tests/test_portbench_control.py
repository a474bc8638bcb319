"""The comparison that decides ``correct`` has to fail: the control (the
reference in TF32 in the program's place) and, with the timed path broken
underneath, each fault a cell can have. At tiny sizes on the CPU; the
control at the cells' own sizes runs on the card (``portbench/control.py``)."""

import time

import pytest
import torch

from portbench import control, harness
from portbench.tests import kept, tiny

BENCH = kept.bench()
# the benchmark's cells, and the ingest cell kept out of it (kept.py)
CELLS = [w["name"] for w in harness.load_bench()["workloads"]] + [kept.INGEST]
SEARCH = [c for c in CELLS if ".ingest-" not in c]
INGEST = [c for c in CELLS if ".ingest-" in c]
QUANTIZED = [c for c in SEARCH if harness.cell_parts(BENCH, c)[2].get("candidates")]


def run(cell, where, seed=2**31 + 4242):
    """One run of ``cell`` from the copy ``where`` (the ``kept_copy`` fixture)."""
    root, here = where
    result, lines = harness.run_cell(cell, seed, 0.7, False, t_start=time.perf_counter(),
                                     device="cpu", root=root, here=here, config_overrides=tiny.CONFIG,
                                     mix_overrides=tiny.mix(cell))
    return result


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12])
def test_control_is_not_correct(cell, seed, kept_copy):
    root, here = kept_copy
    out = control.control(cell, seed, 0.7, device="cpu", config_overrides=tiny.CONFIG,
                          mix_overrides=tiny.mix(cell), root=root, here=here)
    assert out["correct"] is False, out
    gaps = ["edge_dist_gap"] if cell in INGEST else ["dist_gap"]
    if cell in QUANTIZED:
        gaps.append("cand_gap")  # the int4 control of the int8 stage
    for gap in gaps:
        value, limit = out["checks"][gap]
        assert value > limit, gap


def _final(cell):
    """The module and function that produce a search cell's answers."""
    from tpuvec_torch.index import search
    from tpuvec_torch.ops import rerank

    mix = harness.cell_parts(BENCH, cell)[2]
    return (rerank, "rerank_topk") if mix.get("candidates") else (search, "search_graph")


def _search_fault(kind, fn):
    def broken(*args, **kwargs):
        d, i = fn(*args, **kwargs)
        if kind == "answer_altered":
            return d, torch.where(i >= 0, i + 1, i)
        half = d.shape[0] // 2  # the first half's answers stand for the whole batch
        return torch.cat([d[:half], d[:half]])[: d.shape[0]], torch.cat([i[:half], i[:half]])[: i.shape[0]]
    return broken


def _unchanged_loop(fn):
    def broken(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d=None, res_i=None, **kw):
        if res_d is not None:
            return res_d, res_i, 0
        return beam_d, beam_i, 0
    return broken


@pytest.mark.parametrize("cell", SEARCH)
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch", "state_unchanged"])
def test_search_faults_are_not_correct(cell, fault, monkeypatch, kept_copy):
    assert run(cell, kept_copy)["correct"] is True
    if fault == "state_unchanged":
        from tpuvec_torch.index import search

        monkeypatch.setattr(search, "beam_loop", _unchanged_loop(search.beam_loop))
    else:
        module, name = _final(cell)
        monkeypatch.setattr(module, name, _search_fault(fault, getattr(module, name)))
    assert run(cell, kept_copy)["correct"] is False


@pytest.mark.parametrize("cell", INGEST)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_ingest_faults_are_not_correct(cell, fault, monkeypatch, kept_copy):
    from tpuvec_torch.index import build

    assert run(cell, kept_copy)["correct"] is True
    insert, connect = build.insert_batch, build._stage_connect
    if fault == "state_unchanged":
        monkeypatch.setattr(build, "insert_batch", lambda config, state, *a, **k: state)
    elif fault == "half_batch":
        def half(config, state, new_ids, new_vecs, new_levels, **k):
            keep = torch.arange(new_ids.shape[0]) < (new_ids.shape[0] + 1) // 2
            return insert(config, state, torch.where(keep, new_ids, -1), new_vecs, new_levels, **k)
        monkeypatch.setattr(build, "insert_batch", half)
    else:
        def altered(config, state, new_ids, cand_d, cand_i):
            state = connect(config, state, new_ids, cand_d, cand_i)
            rows = new_ids[new_ids >= 0].long()
            state.adj0_dist[rows] = state.adj0_dist[rows] * 1.001
            return state
        monkeypatch.setattr(build, "_stage_connect", altered)
    assert run(cell, kept_copy)["correct"] is False


@pytest.mark.parametrize("cell", QUANTIZED)
@pytest.mark.parametrize("fault", ["coarse_quantizer", "candidate_altered"])
def test_int8_stage_faults_are_not_correct(cell, fault, monkeypatch, kept_copy):
    """The int8 stage broken underneath the exact rerank: the quantizer at
    half its levels, or each candidate id moved to the next row where the
    search produces it. ``cand_gap`` has to catch both."""
    from tpuvec_torch.index import graph, search

    assert run(cell, kept_copy)["correct"] is True
    if fault == "coarse_quantizer":
        monkeypatch.setattr(graph, "quantize_int8_for_index",
                            lambda v: torch.round(torch.clamp(v, -1.0, 1.0) * 63.0).to(torch.int8))
    else:
        fn = search.search_graph

        def altered(*args, **kwargs):
            d, i = fn(*args, **kwargs)
            return d, torch.where(i >= 0, (i + 1) % 3000, i)
        monkeypatch.setattr(search, "search_graph", altered)
    result = run(cell, kept_copy)
    assert result["correct"] is False
    assert result["checks"]["cand_gap"]["value"] > result["checks"]["cand_gap"]["limit"]
