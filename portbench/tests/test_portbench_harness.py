"""The harness end to end at tiny sizes on the CPU, the yardstick's pieces
against plain numpy, discovery by name, and the JAX check."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import checks, exact, plain_loop
from portbench.tests import kept, tiny

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=False, seconds=1.0, seed=2**31 + 977, **kw):
    return harness.run_cell(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                            config_overrides=tiny.CONFIG, mix_overrides=tiny.mix(cell), **kw)


# the benchmark's cells, and the ingest cell kept out of it (kept.py)
@pytest.mark.parametrize("cell", CELLS + [kept.INGEST])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_end_to_end(cell, trace, capsys, kept_copy):
    root, here = kept_copy
    result, lines = run(cell, trace, root=root, here=here)
    print(json.dumps(result))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, lines
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(kept.bench(), cell, trace)}
    if trace:
        # the device's metrics have nothing to read on the CPU
        want -= {"loop_roofline", "idle_share.query", "idle_share.ingest"}
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["metrics"]) == want
    assert lines[-1].startswith("check ")


def test_same_seed_same_inputs():
    from portbench.reference.data import Manifold, subseed

    cfg = harness.cell_parts(BENCH, CELLS[0])[1]
    m = Manifold(cfg["dim"], cfg["data"], torch.device("cpu"))
    a = m.rows(300, subseed(2**31 + 5, "corpus"))
    assert torch.equal(a, m.rows(300, subseed(2**31 + 5, "corpus")))
    assert not torch.equal(a, m.rows(300, subseed(2**31 + 6, "corpus")))
    assert torch.allclose(a.norm(dim=1), torch.ones(300), atol=1e-5)


def test_exact_scan_against_numpy():
    g = torch.Generator().manual_seed(3)
    x, q = torch.randn(5000, 64, generator=g), torch.randn(37, 64, generator=g)
    valid = torch.rand(5000, generator=g) < 0.3
    d, i = exact.cosine_topk(q, x, 10, valid=valid)
    xn = x.numpy().astype(np.float64)
    xn /= np.linalg.norm(xn, axis=1, keepdims=True)
    qn = q.numpy().astype(np.float64)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    sim = np.where(valid.numpy()[None], qn @ xn.T, -np.inf)
    want = np.argsort(-sim, axis=1, kind="stable")[:, :10]
    assert checks.recall(i.numpy(), want) == 1.0
    np.testing.assert_allclose(d.numpy(), 1 - np.take_along_axis(sim, want, 1), atol=1e-6)
    ref = exact.pair_cosine64(q, x, i).numpy()
    np.testing.assert_allclose(ref, 1 - np.take_along_axis(sim, want, 1), atol=1e-12)


def test_int8_codes_against_numpy():
    g = torch.Generator().manual_seed(5)
    x, q = torch.randn(400, 96, generator=g), torch.randn(9, 96, generator=g)
    ids = torch.randint(-1, 400, (9, 12), generator=g)
    xn = x.numpy().astype(np.float64)
    xn = np.rint(np.clip(xn / np.linalg.norm(xn, axis=1, keepdims=True), -1, 1) * 127)
    qn = q.numpy().astype(np.float64)
    qn = np.rint(np.clip(qn / np.linalg.norm(qn, axis=1, keepdims=True), -1, 1) * 127)
    np.testing.assert_array_equal(exact.codes(x).numpy(), xn)
    got = exact.pair_code_sq_l2(q, x, ids).numpy()
    want = ((qn[:, None, :] - xn[ids.clamp_min(0).numpy()]) ** 2).sum(-1)
    ok = ids.numpy() >= 0
    np.testing.assert_array_equal(got[ok], want[ok])
    assert np.isnan(got[~ok]).all()
    c4 = exact.codes(x, exact.INT4_LEVELS)
    d, i = exact.code_sq_l2_topk(exact.codes(q, exact.INT4_LEVELS), c4, 5)
    full = ((exact.codes(q, exact.INT4_LEVELS).double()[:, None] - c4.double()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(d.numpy(), np.sort(full.numpy(), axis=1)[:, :5])


def test_short_filtered_answer_is_invalid():
    """A filtered answer holds k ids like any other: a short one breaks
    the configuration's guarantee."""
    ids = np.array([[3, 13, 23], [7, -1, -1]])
    d = np.array([[0.1, 0.2, 0.3], [0.1, np.inf, np.inf]])
    kinds = checks.invalid_kinds(ids, d, 100, 3, allowed=(ids % 10) == ids[:, :1] % 10)
    assert kinds["short"].tolist() == [False, True]
    assert checks.invalid_answers(ids, d, 100, 3, allowed=(ids % 10) == ids[:, :1] % 10) == 1


def test_unread_mix_key_is_refused(tmp_path):
    """A mix key that its driver does not read (here a second client) is
    refused, not silently run as one client."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    root, here = kept.copy(tmp_path, bench)
    mix = json.loads((here / "traffic" / "knn-b4096.json").read_text())
    (here / "traffic" / "knn-b4096.json").write_text(json.dumps({**mix, "clients": 8}))
    with pytest.raises(ValueError, match="clients"):
        harness.cell_parts(bench, "f32cos-1m-768.knn-b4096", root, here)


def test_filtered_mix_runs(tmp_path):
    """The filtered mix, whose cell waits on the program (PERF.md), runs end
    to end at a tiny size where its answers hold k ids."""
    name = kept.FILTER
    root, here = kept.copy(tmp_path, kept.bench())
    result, lines = harness.run_cell(name, 2**31 + 977, 0.5, False, t_start=time.perf_counter(),
                                     device="cpu", root=root, here=here, config_overrides=tiny.CONFIG,
                                     mix_overrides=tiny.SEARCH)
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and "recall_at_10" in result["metrics"]


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12], dtype=torch.float32)
    assert exact.tf32_round(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0]


def test_roofline_bytes_on_a_hand_built_graph():
    # 6 nodes on a line, 4 dims; the query sits on node 5's row and the
    # beam starts at node 0: the plain loop walks 0 -> 1 -> ... -> 5
    vec = torch.zeros(6, 4)
    vec[:, 0] = torch.arange(6, dtype=torch.float32)
    adj = torch.tensor([[1, -1], [0, 2], [1, 3], [2, 4], [3, 5], [4, -1]], dtype=torch.int32)
    q = vec[5:6].clone()
    beam_d = torch.full((1, 4), float("inf"))
    beam_i = torch.full((1, 4), -1, dtype=torch.int32)
    beam_x = torch.ones((1, 4), dtype=torch.bool)
    beam_d[0, 0], beam_i[0, 0], beam_x[0, 0] = 25.0, 0, False
    sel, cand, active = plain_loop.frontier(beam_d, beam_i, beam_x, 1)
    beam_x |= sel
    args = (q, vec, adj, beam_d, beam_i, beam_x, cand, active)
    kw = {"max_iters": 20}
    fresh, adjs = plain_loop.loop_rows(args, kw)
    assert sorted(torch.unique(fresh).tolist()) == [1, 2, 3, 4, 5]
    assert sorted(torch.unique(adjs).tolist()) == [0, 1, 2, 3, 4, 5]
    out = plain_loop.beam_loop(*args, **kw)
    assert out[1][0, 0].item() == 5
    bound = plain_loop.loop_bound(args, kw, out, fresh, adjs)
    small = sum(t.numel() * t.element_size() for t in (q, beam_d, beam_i, beam_x, cand, active, *out))
    assert bound["bytes"] == 5 * 16 + 6 * 8 + small
    assert bound["ops"] == fresh.numel() * 4 * 4
    assert bound["bound_by"] == "bytes"


def test_pieces_found_by_name(tmp_path):
    """A cell, a traffic mix and a metric added to a copy are found by
    name, with no file of the harness edited."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    name = "f32cos-1m-768.knn-b64"
    bench["workloads"].append({"name": name, "config": "f32cos-1m-768", "traffic": "knn-b64",
                               "chips": 1, "why": "a cell added in a test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                                "bound": 0.01, "source": "host_clock", "workloads": [name]})
    for m in bench["end_to_end"]:
        if m["name"] in ("qps", "query_p95_ms", "recall_at_10"):
            m["workloads"].append(name)
    root, here = kept.copy(tmp_path, bench)
    mix = json.loads((here / "traffic" / "knn-b4096.json").read_text())
    (here / "traffic" / "knn-b64.json").write_text(json.dumps({**mix, "batch": 64}))
    (here / "metrics" / "calls_made.py").write_text("def read(run):\n    return len(run.window.latencies_s)\n")
    result, _ = harness.run_cell(name, 7, 0.5, False, t_start=time.perf_counter(), device="cpu",
                                 root=root, here=here, config_overrides=tiny.CONFIG,
                                 mix_overrides={"sample_queries": 64})
    assert result["correct"] is True
    assert result["metrics"]["calls_made"]["value"] >= 1
    assert result["attempted"] % 64 == 0


def test_no_jax_in_the_benchmark():
    """Nothing the harness, a driver, a metric or the reference imports has
    the top-level name jax, jaxlib, flax or tpuvec."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import harness, control\n"
        "from portbench.reference import checks, data, exact, peaks, plain_loop\n"
        "from portbench.tests import kept\n"
        "b = kept.bench()  # with the cells kept out of it\n"
        "[harness.cell_parts(b, w['name']) for w in b['workloads']]\n"
        "[harness.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "import tpuvec_torch.index.build, tpuvec_torch.index.search, tpuvec_torch.ops.rerank\n"
        "print(json.dumps(harness.forbidden_modules()))\n" % str(harness.ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=harness.ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "tpuvec")
    sys.modules.setdefault("tpuvec_torch_lookalike", None)
    try:
        assert "tpuvec_torch_lookalike" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("tpuvec_torch_lookalike", None)


def test_run_exits_without_a_card_or_the_port(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 1),
           "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=harness.ROOT)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench")
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "not in this checkout" in out.stderr
