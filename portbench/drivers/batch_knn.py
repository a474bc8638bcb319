"""Batched k-NN traffic: one client in a closed loop sends batches of fresh
queries to the port's HNSW search and waits for each answer on the host.

The traffic mix (``traffic/<name>.json``) gives:

* ``batch``, ``k``, ``ef`` and optionally ``max_iters``: each call is
  ``prepare_queries`` + ``search_graph(k, ef, max_iters)``;
* ``candidates`` (optional): the search returns that many candidates,
  and ``rerank_topk`` picks the k best against the f32 originals; the
  candidate lists of a seeded reservoir sample of the window's calls stay
  on the device for the check of the quantized stage;
* ``filter`` (optional) ``{"modulus": m}``: row r carries label r % m, and
  each call filters on one label drawn from the seed;
* ``sample_queries``: how many of the window's answers (whole calls,
  drawn from the seed) the reference checks;
* ``assumed`` (optional): what the mix assumes, in words; not read.

Set-up makes the configuration's corpus from the seed on the device,
prepares it and builds the graph with ``build_graph``. Queries are fresh
rows of the same manifold, from their own stream of the seed, never in the
corpus; call j's batch is a function of (seed, j).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import checks, exact
from portbench.reference.data import Manifold, subseed

# queries of a kept call whose candidates the reference codes in one block
_CAND_BLOCK = 512

UNIT = "queries"
# the traffic mix's keys this driver reads (the harness refuses others)
MIX_KEYS = {"driver", "batch", "k", "ef", "max_iters", "candidates", "filter", "sample_queries", "assumed"}
# (module, attribute, span, capture args and device time) wrapped in traced runs
SPANS = [
    ("tpuvec_torch.index.search", "descend_to_level1", "descent", False),
    ("tpuvec_torch.index.search", "beam_loop", "loop", True),
    ("tpuvec_torch.ops.rerank", "rerank_topk", "rerank", False),
]


@dataclass
class State:
    env: object
    manifold: Manifold
    corpus: torch.Tensor
    n: int
    cfg: object
    graph: object
    masks: list
    kept: list
    keep_rng: random.Random


def _hnsw_config(config: dict, device):
    from tpuvec_torch.index.graph import config_for
    from tpuvec_torch.index.params import HnswParams
    from tpuvec_torch.types import DistanceMetric, IndexQuantization

    if config["metric"] != "cosine":
        raise ValueError("batch_knn serves cosine configurations")
    h = config["hnsw"]
    params = HnswParams(m=h["m"], max_m0=h["max_m0"], ef_construction=h["ef_construction"])
    return config_for(config["dim"], metric=DistanceMetric.COSINE,
                      quantization=IndexQuantization(config["quantization"]),
                      params=params, cap=config["rows"])


def setup(env, *, build: bool = True) -> State:
    """Corpus, graph, filter masks and one warm-up call of the cell's shape.
    ``build=False`` (the control) makes the corpus alone."""
    from tpuvec_torch.index.build import build_graph
    from tpuvec_torch.index.graph import prepare_vectors

    config, mix, dev = env.config, env.mix, env.device
    manifold = Manifold(config["dim"], config["data"], dev)
    n = config["rows"]
    corpus = manifold.rows(n, subseed(env.seed, "corpus"))
    cfg = _hnsw_config(config, dev)
    masks = []
    if mix.get("filter"):
        m = mix["filter"]["modulus"]
        row = torch.arange(cfg.cap, device=dev)
        masks = [(row % m == label) & (row < n) for label in range(m)]
    graph = None
    if build:
        xp = prepare_vectors(cfg, corpus, device=dev)
        graph = build_graph(cfg, xp, max_batch=config["build_max_batch"], device=dev)
        del xp
    state = State(env, manifold, corpus, n, cfg, graph, masks, [], random.Random(subseed(env.seed, "kept")))
    if build:
        serve(state, _request(state, subseed(env.seed, "warmup"), 0 if masks else -1, -1))
    return state


def _request(state: State, stream: int, label: int, j: int):
    return state.manifold.rows(state.env.mix["batch"], stream), label, j


def _label(state: State, j: int) -> int:
    """Call j's filter label, drawn from the seed (-1: no filter)."""
    if not state.masks:
        return -1
    return random.Random(subseed(state.env.seed, "label", j)).randrange(len(state.masks))


def request(state: State, j: int):
    """Call j's raw queries [batch, dim] on the device, its label and j."""
    return _request(state, subseed(state.env.seed, "queries", j), _label(state, j), j)


def serve(state: State, req):
    """One call: the port's search of the batch; (ids, distances) on the
    host, distances in the cosine metric."""
    from tpuvec_torch.index import search
    from tpuvec_torch.index.graph import prepare_queries
    from tpuvec_torch.ops import rerank
    from tpuvec_torch.types import DistanceMetric

    q, label, j = req
    mix, spans = state.env.mix, state.env.spans
    with spans.span("prepare"):
        qp = prepare_queries(state.cfg, q, device=state.env.device)
    mask = state.masks[label] if label >= 0 else None
    if mix.get("candidates"):
        cand_d, cand = search.search_graph(state.cfg, state.graph, qp, k=mix["candidates"], ef=mix["ef"],
                                           max_iters=mix.get("max_iters"), filter_mask=mask)
        _keep(state, j, cand_d, cand)
        d, i = rerank.rerank_topk(state.corpus, cand, cand >= 0, q, metric=DistanceMetric.COSINE,
                                  k=mix["k"])
    else:
        d, i = search.search_graph(state.cfg, state.graph, qp, k=mix["k"], ef=mix["ef"],
                                   max_iters=mix.get("max_iters"), filter_mask=mask)
        d = d / 2.0  # squared L2 of unit rows -> cosine distance
    with spans.span("results_to_host"):
        return i.cpu().numpy(), d.cpu().numpy()


def _kept_calls(mix: dict) -> int:
    return math.ceil(mix["sample_queries"] / mix["batch"])


def _keep(state: State, j: int, cand_d: torch.Tensor, cand_i: torch.Tensor) -> None:
    """Reservoir sampling (algorithm R, drawn from the seed) of the calls
    whose candidate lists stay on the device: after call j, each of calls
    0..j is kept with the same chance. No wait for the card."""
    if j < 0:  # the warm-up call
        return
    m = _kept_calls(state.env.mix)
    if j < m:
        state.kept.append((j, cand_d, cand_i))
        return
    r = state.keep_rng.randrange(j + 1)
    if r < m:
        state.kept[r] = (j, cand_d, cand_i)


def units(answer) -> int:
    return answer[0].shape[0]


def control_answers(state: State, calls: int) -> list:
    """The control in the program's place: for calls 0..calls-1, the exact
    top-k of the reference computed in TF32; with ``candidates``, the
    candidate lists too: the exact top by squared L2 of the reference's
    int4 codes (the precision below int8), scaled to int8 code units."""
    mix = state.env.mix
    out = []
    if mix.get("candidates"):
        xc = exact.codes(state.corpus, exact.INT4_LEVELS)
        scale = (exact.INT8_LEVELS / exact.INT4_LEVELS) ** 2
    for j in range(calls):
        q, label, _ = request(state, j)
        valid = state.masks[label][: state.n] if label >= 0 else None
        d, i = exact.cosine_topk(q, state.corpus, mix["k"], valid=valid, tf32=True)
        out.append((i.to(torch.int32).cpu().numpy(), d.cpu().numpy()))
        if mix.get("candidates"):
            cd, ci = exact.code_sq_l2_topk(exact.codes(q, exact.INT4_LEVELS), xc, mix["candidates"])
            state.kept.append((j, cd * scale, ci))
    return out


def sample_calls(seed: int, calls: int, batch: int, want: int) -> list[int]:
    """Whole calls of the window, drawn from the seed, holding at least
    ``want`` queries (all calls where the window has fewer)."""
    m = min(calls, math.ceil(want / batch))
    return sorted(random.Random(subseed(seed, "sample")).sample(range(calls), m))


def judge(state: State, window) -> dict:
    """The window's answers against the reference: every answer's ids and
    order (and filter); on the sampled calls, recall@10 against the exact
    top-k and each distance against its float64 value."""
    mix, k, n = state.env.mix, state.env.mix["k"], state.n
    state.graph = None  # the program's state is freed before the reference runs
    if state.env.device.type == "cuda":
        torch.cuda.empty_cache()
    answers = window.answers
    invalid, kinds = 0, {}
    for j, (ids, d) in enumerate(answers):
        allowed = None
        if state.masks:
            allowed = (ids % len(state.masks)) == _label(state, j)
        bad = checks.invalid_kinds(ids, d, n, k, allowed)
        for kind, hit in bad.items():
            kinds[kind] = kinds.get(kind, 0) + int(hit.sum())
        invalid += int(np.logical_or.reduce(list(bad.values())).sum())
    got_i, want_i, gaps = [], [], []
    for j in sample_calls(state.env.seed, len(answers), mix["batch"], mix["sample_queries"]):
        q, label, _ = request(state, j)
        valid = state.masks[label][:n] if label >= 0 else None
        _, ex_i = exact.cosine_topk(q, state.corpus, k, valid=valid)
        ids, d = answers[j]
        ids_t = torch.as_tensor(ids, device=q.device).to(torch.int64)
        ref = exact.pair_cosine64(q, state.corpus, ids_t).cpu().numpy()
        gaps.append(np.abs(d.astype(np.float64) - ref))
        got_i.append(ids)
        want_i.append(ex_i.cpu().numpy())
    gap = np.concatenate(gaps)
    gap = float(np.nanmax(np.where(np.isnan(gap), np.inf, gap))) if gap.size else float("nan")
    rec = checks.recall(np.concatenate(got_i), np.concatenate(want_i))
    total = int(sum(window.units))
    more = []
    if mix.get("candidates"):
        more.append(checks.check("cand_gap", _cand_gap(state), checks.CAND_GAP))
    return {
        "attempted": total,
        "failed": invalid,
        "recall_at_10": rec,
        "notes": [f"invalid answers by kind: {kinds}"],
        "checks": [
            checks.check("invalid", invalid, 0),
            checks.check("recall_at_10", rec, state.env.config["recall_floor"], at_most=False),
            checks.check("dist_gap", gap, checks.DIST_GAP),
        ] + more,
    }


def _cand_gap(state: State) -> float:
    """The quantized stage of the kept calls against the reference: the
    widest gap between a candidate's distance, as the search returned it,
    and the exact squared L2 of the reference's own int8 codes of its query
    and row (inf for an id out of range; padding (-1, inf) is skipped)."""
    gap = 0.0
    for j, cand_d, cand_i in state.kept:
        q = request(state, j)[0]
        for s in range(0, q.shape[0], _CAND_BLOCK):
            ids = cand_i[s:s + _CAND_BLOCK].to(torch.int64)
            got = cand_d[s:s + _CAND_BLOCK].to(torch.float64)
            ref = exact.pair_code_sq_l2(q[s:s + _CAND_BLOCK], state.corpus, ids)
            pad = (ids == -1) & torch.isinf(got)
            d = torch.where(pad, 0.0, (got - ref).abs())
            gap = max(gap, float(torch.nan_to_num(d, nan=float("inf")).max()))
    state.kept = []
    return gap if math.isfinite(gap) else float("inf")
