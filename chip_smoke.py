"""Smoke run of tpuvec_torch on one NVIDIA GPU (H100): the quickest proof
that the port still starts, builds its kernels and is right on the card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. card: the card's name and power limit from nvidia-smi (no card: exit);
2. build: compile every CUDA kernel from tpuvec_torch/csrc with nvcc (the
   entry points tpuvec_beam_update and tpuvec_beam_search_level0);
3. kernels: beam_update (one beam iteration) against beam_update_plain on
   the card at the shapes of the main path, exactly, with and without ties;
   its device time per launch (torch.profiler) beside its bound, and the
   time per call of the wrapper and of the plain version back to back
   (CUDA events);
4. main path: f32 cosine HNSW at 100K x 768 (--n sets the rows; m=16, max_m0=32,
   ef_construction=200, as bench.py configures the JAX package), built
   with build_graph(max_batch=1024), searched in batches of 256 queries
   at ef 24/32/48/64 and scored against the exact scan (recall@10 >= 0.95
   at some ef). The level-0 loop kernel must have launched in both the
   build and the search;
3b. loop kernel, on phase 4's graph: beam_loop (the whole level-0 loop in
   one launch) against beam_loop_plain at the search shape and the
   construction shape, within the stated tolerance (float32 sums in
   another order): after one iteration distances within 1e-5 and ids equal
   wherever a slot's distance is more than 1e-5 from its neighbours'; over
   the full loop >= 99% of top-10 ids equal per (query, rank) and
   recall@10 within 0.002 of the plain loop's; its device time per launch
   beside its bound and the plain loop's time;
5. trace: a separate traced run, for where the time goes: the build with
   a synchronised timer per insert stage and around the candidates stage's
   descent and level-0 loop, one search batch split the same way, and one
   search batch under torch.profiler.

The last two lines are a JSON line with every kernel's numbers and the
JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# HBM rate and non-tensor-core float32 rate of one H100 SXM (data sheet)
_HBM_BYTES_PER_S = 3.35e12
_F32_OPS_PER_S = 67e12

# BASELINE.md config 2 (100K x 768 cosine, k=10); queries as bench.py draws them
N, D, NQ, REPS, K = 100_000, 768, 256, 5, 10


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _beam_inputs(rng, b, efp, w, ties, device):
    """A sorted beam with +inf padding; a window repeating beam ids, its own
    ids and -1s. Tie-free unless ``ties``."""
    n_live = rng.integers(efp // 4, efp + 1, size=b)
    if ties:
        vals = rng.integers(0, 6, size=(b, efp + w)).astype(np.float32)
    else:
        vals = rng.permuted(np.tile(np.arange(efp + w, dtype=np.float32), (b, 1)), axis=1)
        vals = vals / 7.0 + 0.5
    bd = np.sort(vals[:, :efp], axis=1)
    bi = rng.permuted(np.tile(np.arange(10 * efp, dtype=np.int32), (b, 1)), axis=1)[:, :efp]
    bx = rng.random((b, efp)) > 0.6
    pad = np.arange(efp)[None, :] >= n_live[:, None]
    bd[pad], bi[pad], bx[pad] = np.inf, -1, True
    nbrs = rng.integers(0, 10 * efp, size=(b, w)).astype(np.int32)
    from_beam = rng.random((b, w)) < 0.3
    nbrs = np.where(from_beam, bi[np.arange(b)[:, None], rng.integers(0, efp, (b, w))], nbrs)
    nbrs[:, w // 2 :] = np.where(rng.random((b, w - w // 2)) < 0.3, nbrs[:, : w - w // 2], nbrs[:, w // 2 :])
    nbrs[rng.random((b, w)) < 0.1] = -1
    import torch

    return [
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (bd, bi, bx, nbrs.astype(np.int32), vals[:, efp:])
    ]


def _time_ms(fn, reps: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, kernel: str) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, from a torch.profiler trace of ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [ev for ev in prof.key_averages() if kernel in ev.key]
    count = sum(ev.count for ev in hits)
    if count == 0:
        raise AssertionError(f"profiler saw no launch of {kernel} in {reps} calls")
    if count != reps:  # the trace can drop an event; average over those it kept
        _log(f"kernels: profiler kept {count} of {reps} launches of {kernel}")
    return sum(ev.device_time_total for ev in hits) / count / 1e3


def _beam_bound(args, outs, e):
    """(bound_ms, bound_by) of one beam update: each input read once, each
    output written once, against the HBM rate; the compares a merge
    needs (dedup against the beam and the earlier window, a sort of the
    window, a linear merge, the frontier) against the float32 rate."""
    b, efp = args[0].shape
    w = args[3].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    ops = b * (w * efp + (w * (w - 1) // 2 if e > 1 else 0) + w * math.log2(w) + efp + w + efp)
    t_bytes, t_ops = nbytes / _HBM_BYTES_PER_S * 1e3, ops / _F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_beam_kernel(torch, device):
    """Phase 3: beam_update (CUDA) == beam_update_plain on the card, exactly,
    at the search and construction shapes and on a case with ties."""
    from tpuvec_torch.ops.beam import beam_update, beam_update_plain

    rng = np.random.default_rng(0)
    shapes = []
    for b, efp, w, e in [(256, 64, 32, 1), (1024, 256, 64, 2)]:
        for ties in (False, True):
            args = _beam_inputs(rng, b, efp, w, ties, device)
            ker = beam_update(*args, n_expand=e)
            ref = beam_update_plain(*args, n_expand=e)
            torch.cuda.synchronize()
            for name, k_, r in zip(["beam_d", "beam_i", "beam_x", "cand", "active"], ker, ref):
                if not torch.equal(k_, r):
                    bad = int((k_ != r).sum())
                    raise AssertionError(
                        f"beam_update {name} differs from plain at B={b} EF={efp} W={w} E={e} "
                        f"ties={ties}: {bad} entries"
                    )
            finite = torch.isfinite(ref[0])
            err = float((ker[0] - ref[0])[finite].abs().max()) if finite.any() else 0.0
            if ties:
                _log(f"kernels: beam_update == plain with ties and -1 ids at B={b} EF={efp} W={w} E={e}")
                continue
            ms = _device_ms(lambda: beam_update(*args, n_expand=e), 100, "beam_update_kernel")
            call_ms = _time_ms(lambda: beam_update(*args, n_expand=e), 200)
            plain_ms = _time_ms(lambda: beam_update_plain(*args, n_expand=e), 20)
            bound_ms, bound_by = _beam_bound(args, ker, e)
            shapes.append(dict(B=b, EF=efp, W=w, E=e, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
            _log(
                f"kernels: beam_update == plain at B={b} EF={efp} W={w} E={e}: "
                f"device {ms:.5f} ms per launch (bound {bound_ms:.5f} ms by {bound_by}); "
                f"back-to-back calls {call_ms:.4f} ms, plain {plain_ms:.4f} ms"
            )
    return shapes


def run_main_path(torch, device, n):
    """Phase 4: build, exact oracle, search sweep at n x 768 cosine."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.build import build_graph
    from tpuvec_torch.index.graph import config_for, prepare_vectors
    from tpuvec_torch.index.params import HnswParams
    from tpuvec_torch.index.search import search_graph
    from tpuvec_torch.ops.beam import beam_loop, beam_update
    from tpuvec_torch.types import DistanceMetric
    from tpuvec_torch.utils.data import synthetic_embeddings

    d, nq, reps, k = D, NQ, REPS, K
    t0 = time.time()
    n_clusters = 1024 if n >= 500_000 else 256  # as bench.py draws its corpus
    data = synthetic_embeddings(n + nq * (reps + 1), d, n_clusters=n_clusters, seed=0)
    cfg = config_for(
        d, metric=DistanceMetric.COSINE, cap=n,
        params=HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128),
    )
    xp = prepare_vectors(cfg, data[:n], device=device)
    torch.cuda.synchronize()
    _log(f"main: data {n}x{d} + {nq * (reps + 1)} queries made and prepared in {time.time() - t0:.1f}s")

    wrappers = {"beam_update": beam_update, "beam_search_level0": beam_loop}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.time()
    state = build_graph(cfg, xp, max_batch=1024, device=device)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_launches = {name: fn.launches for name, fn in wrappers.items()}
    if int(state.count) != n:
        raise AssertionError(f"graph holds {int(state.count)} of {n} vectors")
    _log(f"main: build {n} vectors in {build_s:.2f}s = {n / build_s:.0f} vec/s, "
         f"kernel launches {build_launches}")

    qp = prepare_vectors(cfg, data[n : n + nq], device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    _, gt_i = bruteforce_knn(qp, xp, valid, metric=cfg.graph_metric, k=k, normalized=True)
    # the oracle itself against a float64 numpy scan on a few queries
    x64 = data[:n].astype(np.float64)
    x64 /= np.linalg.norm(x64, axis=1, keepdims=True)
    q64 = data[n : n + 8].astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    np_i = np.argsort(-(q64 @ x64.T), axis=1)[:, :k]  # unit vectors: max dot = min L2
    agree = np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(gt_i[:8].cpu().numpy(), np_i)])
    if agree < 0.99:
        raise AssertionError(f"exact scan agrees with numpy on only {agree:.3f} of ids")
    gt = gt_i.cpu().numpy()
    _log(f"main: exact scan oracle ready (agrees with numpy float64 on {agree:.3f} of ids)")

    rep_qs = [
        prepare_vectors(cfg, data[n + (i + 1) * nq : n + (i + 2) * nq], device=device)
        for i in range(reps)
    ]
    sweep = []
    for ef in (24, 32, 48, 64):
        d_h, i_h = search_graph(cfg, state, qp, k=k, ef=ef)  # warm-up, scored
        torch.cuda.synchronize()
        t0 = time.time()
        for q in rep_qs:
            search_graph(cfg, state, q, k=k, ef=ef)
        torch.cuda.synchronize()
        dt = (time.time() - t0) / reps
        dh, ih = d_h.cpu().numpy(), i_h.cpu().numpy()
        if dh.shape != (nq, k) or not np.isfinite(dh).all() or (ih < 0).any() or (ih >= n).any():
            raise AssertionError(f"search output malformed at ef={ef}")
        if (np.diff(dh, axis=1) < 0).any():
            raise AssertionError(f"search distances not ascending at ef={ef}")
        recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(ih, gt)])
        sweep.append(dict(ef=ef, recall=float(recall), ms_per_batch=dt * 1e3, qps=nq / dt))
        _log(f"main: ef={ef} recall@10={recall:.4f} {dt * 1e3:.2f} ms/batch {nq / dt:.0f} QPS")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    search_launches = {name: launches[name] - build_launches[name] for name in wrappers}
    best = max((s for s in sweep if s["recall"] >= 0.95), key=lambda s: s["qps"], default=None)
    if best is None:
        raise AssertionError(f"no ef reached recall@10 >= 0.95: {sweep}")
    # the main path runs the level-0 loop kernel; beam_update is held in
    # phase 3 and no longer launched by the path
    if build_launches["beam_search_level0"] == 0 or search_launches["beam_search_level0"] == 0:
        raise AssertionError(
            f"loop kernel launches: build {build_launches}, search {search_launches}"
        )
    _log(f"main: best {best['qps']:.0f} QPS at recall@10 {best['recall']:.4f} (ef={best['ef']}); "
         f"kernel launches: build {build_launches}, search {search_launches}")
    return dict(launches=launches, cfg=cfg, xp=xp, state=state, q=rep_qs[0], ef=best["ef"],
                data=data, n=n, gt=gt, qp=qp)


def _recall(ids, gt) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ids, gt)]))


def _loop_visits(torch, args, kw):
    """Run beam_loop_plain and record the rows it reads: the fresh window ids
    (vector rows) and the active frontier ids (adjacency rows) of every
    iteration. Returns (fresh ids, adjacency ids, the plain loop's result)."""
    from tpuvec_torch.ops import beam

    plain = beam.beam_update_plain
    fresh_ids, frontiers = [], [(args[6], args[7])]

    def recording(beam_d, beam_i, beam_x, nbrs, nd, *, n_expand):
        dup = (nbrs[:, :, None] == beam_i[:, None, :]).any(-1)
        if n_expand > 1:
            pos = torch.arange(nbrs.shape[1], device=nbrs.device)
            earlier = (pos[:, None] > pos[None, :])[None]
            dup |= ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(-1)
        fresh_ids.append(nbrs[(nbrs >= 0) & ~dup])
        out = plain(beam_d, beam_i, beam_x, nbrs, nd, n_expand=n_expand)
        frontiers.append((out[3], out[4]))
        return out

    beam.beam_update_plain = recording
    try:
        result = beam.beam_loop_plain(*args, **kw)
    finally:
        beam.beam_update_plain = plain
    adj_ids = [c[(c >= 0) & a[:, None]] for c, a in frontiers[: len(fresh_ids)]]
    return torch.cat(fresh_ids), torch.cat(adj_ids), result


def _loop_bound(torch, args, fresh, adj, outs):
    """(bound_ms, bound_by, distinct bytes, per-visit bytes) of one loop
    launch: the distinct vector and adjacency rows the batch's loop reads,
    each once, plus q, the beam and frontier in and the outputs, against the
    HBM rate; two multiply-adds per element of every fresh row against the
    float32 rate."""
    q, vectors, adj0 = args[:3]
    row_v = vectors.shape[1] * vectors.element_size()
    row_a = adj0.shape[1] * adj0.element_size()
    small = sum(t.numel() * t.element_size() for t in (q, *args[3:], *outs))
    distinct = torch.unique(fresh).numel() * row_v + torch.unique(adj).numel() * row_a + small
    per_visit = fresh.numel() * row_v + adj.numel() * row_a + small
    ops = fresh.numel() * 4 * vectors.shape[1]
    t_bytes, t_ops = distinct / _HBM_BYTES_PER_S * 1e3, ops / _F32_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, distinct, per_visit)


def _check_one_iteration(torch, label, kd, ki, pd, pi) -> float:
    """Kernel vs plain after one iteration: the same +inf slots, distances
    within 1e-5, ids equal wherever a slot's distance is more than 1e-5
    from its neighbours'. Returns the largest distance error."""
    fin = torch.isfinite(pd)
    if not torch.equal(fin, torch.isfinite(kd)):
        raise AssertionError(f"beam_loop {label}: +inf slots differ from plain after 1 iteration")
    err = float((kd - pd)[fin].abs().max()) if fin.any() else 0.0
    if err > 1e-5:
        raise AssertionError(f"beam_loop {label}: distance error {err} > 1e-5 after 1 iteration")
    gap = torch.nan_to_num(torch.diff(pd, dim=1), nan=math.inf)  # +inf - +inf: padding
    edge = torch.full_like(pd[:, :1], math.inf)
    apart = (torch.cat([edge, gap], 1) > 1e-5) & (torch.cat([gap, edge], 1) > 1e-5)
    bad = int(((ki != pi) & apart).sum())
    if bad:
        raise AssertionError(f"beam_loop {label}: {bad} separated slots hold other ids than plain")
    return err


def _check_loop_smem(torch, device):
    """The loop kernel with rows past 48 KB of shared memory (the opt-in
    path) against the plain loop after one iteration, and with rows past
    the card's limit: ValueError."""
    from tpuvec_torch.index.search import seed_beam
    from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain, node_dist
    from tpuvec_torch.types import DistanceMetric

    rng = np.random.default_rng(1)
    kw = dict(metric=DistanceMetric.COSINE, normalized=True)
    cap, m0, b = 64, 8, 4
    for dp, fits in ((16384, True), (65536, False)):
        x = rng.standard_normal((cap + b, dp)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        vectors, q = torch.from_numpy(x[:cap]).to(device), torch.from_numpy(x[cap:]).to(device)
        adj0 = torch.from_numpy(rng.integers(0, cap, (cap, m0)).astype(np.int32)).to(device)
        seeds = torch.zeros(b, dtype=torch.int32, device=device)
        seed_d = node_dist(kw["metric"], kw["normalized"], vectors, q, seeds[:, None])[:, 0]
        args = (q, vectors, adj0, *seed_beam(seeds, seed_d, ef=16, n_expand=2))
        if fits:
            k_ = beam_loop(*args, **kw, max_iters=1)
            p_ = beam_loop_plain(*args, **kw, max_iters=1)
            _check_one_iteration(torch, f"Dp={dp}", k_[0], k_[1], p_[0], p_[1])
            _log(f"kernels: beam_loop ~ plain after 1 iteration at Dp={dp} (> 48 KB of shared memory)")
            continue
        try:
            beam_loop(*args, **kw, max_iters=1)
        except ValueError as exc:
            _log(f"kernels: beam_loop at Dp={dp} raises ValueError ({exc})")
        else:
            raise AssertionError(f"beam_loop took Dp={dp}, past the card's shared memory")


def check_loop_kernel(torch, device, run):
    """Phase 3b, on phase 4's graph: beam_loop (CUDA) against beam_loop_plain
    at the search shape (the oracle's 256 queries at ef=64: EF=64, E=1) and
    the construction shape (1024 held-out rows at ef_construction with the
    build's iteration budget: EF=256, E=2)."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.build import _build_iter_budget
    from tpuvec_torch.index.graph import prepare_vectors
    from tpuvec_torch.index.search import default_max_iters, descend_to_level1, seed_beam
    from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain

    cfg, state, n, data = run["cfg"], run["state"], run["n"], run["data"]
    qc = prepare_vectors(cfg, data[n + NQ : n + NQ + 1024], device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    _, gt_c = bruteforce_knn(qc, run["xp"], valid, metric=cfg.graph_metric, k=K, normalized=True)
    efc = max(cfg.ef_construction, cfg.max_m0)
    cases = [
        (run["qp"], run["gt"], 64, 1, default_max_iters(64, 1)),
        (qc, gt_c.cpu().numpy(), efc, 2, _build_iter_budget(cfg.cap, efc, 2)),
    ]
    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized)
    _check_loop_smem(torch, device)
    shapes = []
    for q, gt, ef, e, max_iters in cases:
        args = (q, state.vectors, state.adj0, *seed_beam(*descend_to_level1(cfg, state, q), ef=ef, n_expand=e))
        b, efp, w, dp = q.shape[0], args[3].shape[1], e * cfg.max_m0, q.shape[1]
        label = f"B={b} EF={efp} W={w} E={e}"
        one_k = beam_loop(*args, **kw, max_iters=1)
        one_p = beam_loop_plain(*args, **kw, max_iters=1)
        err = _check_one_iteration(torch, label, one_k[0], one_k[1], one_p[0], one_p[1])

        kd, ki, k_it = beam_loop(*args, **kw, max_iters=max_iters)
        fresh, adj, (pd, pi, p_it) = _loop_visits(torch, args, dict(kw, max_iters=max_iters))
        same = float((ki[:, :K] == pi[:, :K]).float().mean())
        r_k, r_p = _recall(ki[:, :K].cpu().numpy(), gt), _recall(pi[:, :K].cpu().numpy(), gt)
        if same < 0.99 or abs(r_k - r_p) > 0.002:
            raise AssertionError(
                f"beam_loop {label}: top-10 ids equal {same:.4f} (< 0.99?), recall@10 "
                f"{r_k:.4f} vs plain {r_p:.4f} (more than 0.002 apart?)"
            )
        ms = _device_ms(lambda: beam_loop(*args, **kw, max_iters=max_iters), 10, "beam_search_level0_kernel")
        call_ms = _time_ms(lambda: beam_loop(*args, **kw, max_iters=max_iters), 10)
        plain_ms = _time_ms(lambda: beam_loop_plain(*args, **kw, max_iters=max_iters), 3, warm=1)
        iters_t = torch.empty((b,), dtype=torch.int32)
        bound_ms, bound_by, distinct, per_visit = _loop_bound(torch, args, fresh, adj, (kd, ki, iters_t))
        shapes.append(dict(
            B=b, EF=efp, W=w, E=e, Dp=dp, max_iters=max_iters, iters=k_it, plain_iters=p_it,
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            distinct_bytes=distinct, per_visit_bytes=per_visit, max_abs_err=err,
            top10_same=same, recall=r_k, plain_recall=r_p,
        ))
        _log(
            f"kernels: beam_loop ~ plain at {label} Dp={dp}: 1 iteration max err {err:.2e}; "
            f"full loop ({k_it} iterations, plain {p_it}) top-10 ids equal {same:.4f}, "
            f"recall@10 {r_k:.4f} vs plain {r_p:.4f}; device {ms:.4f} ms per launch "
            f"(bound {bound_ms:.5f} ms by {bound_by}: {distinct / 1e6:.2f} MB distinct, "
            f"{per_visit / 1e6:.2f} MB per visit); back-to-back calls {call_ms:.4f} ms, "
            f"plain loop {plain_ms:.2f} ms"
        )
    return shapes


def _timers(torch, module, names, spent):
    """Wrap module.<name> for each name with a synchronised timer adding
    into spent[name]; returns the originals, to restore."""
    originals = {name: getattr(module, name) for name in names}

    def timed(name):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapper

    for name in names:
        setattr(module, name, timed(name))
    return originals


def _restore(module, originals):
    for name, fn in originals.items():
        setattr(module, name, fn)


def trace_main_path(torch, device, run):
    """Phase 5, a separate traced run (phase 4's numbers are untraced): the
    build again with a synchronised timer around each insert stage and
    around the candidates stage's descent and level-0 loop; search batches
    split the same way; one search batch at the best ef under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuvec_torch.index import build, search
    from tpuvec_torch.index.search import search_graph

    stages = ["_stage_write", "_stage_candidates", "_stage_upper", "_stage_connect"]
    split = ["descend_to_level1", "beam_search_level0"]
    spent = {}
    originals = _timers(torch, build, stages + split, spent)
    try:
        t = time.perf_counter()
        build.build_graph(run["cfg"], run["xp"], max_batch=1024, device=device)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        _restore(build, originals)
    parts = ", ".join(f"{name[len('_stage_'):]} {spent[name]:.2f}s" for name in stages)
    _log(f"trace: build {total:.2f}s with stage timers: {parts}; candidates = descent "
         f"{spent['descend_to_level1']:.2f}s + level-0 loop {spent['beam_search_level0']:.2f}s")

    cfg, state, q, ef = run["cfg"], run["state"], run["q"], run["ef"]
    search_graph(cfg, state, q, k=K, ef=ef)
    spent, reps = {}, 5
    originals = _timers(torch, search, split, spent)
    try:
        t = time.perf_counter()
        for _ in range(reps):
            search_graph(cfg, state, q, k=K, ef=ef)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) / reps
    finally:
        _restore(search, originals)
    _log(f"trace: search batch at ef={ef}: {total * 1e3:.2f} ms with timers = descent "
         f"{spent['descend_to_level1'] / reps * 1e3:.2f} ms + level-0 loop "
         f"{spent['beam_search_level0'] / reps * 1e3:.2f} ms (mean of {reps})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        search_graph(cfg, state, q, k=K, ef=ef)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = sorted(
        (ev.time_range.start, ev.time_range.end, ev.name)
        for ev in prof.events() if ev.device_type == DeviceType.CUDA
    )
    if not spans:
        _log("trace: search: the profiler recorded no device time (not measured)")
        return
    busy, end, by_name = 0.0, -math.inf, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    _log(
        f"trace: search batch at ef={ef}: {wall_us / 1e3:.2f} ms traced, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%}), {len(spans)} device ops; top: "
        + "; ".join(f"{name[:48]} {us / 1e3:.2f} ms" for name, us in top)
    )


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N, help="corpus rows (bench.py's size: 1000000)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card_line()
    _log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = "cuda"

    from tpuvec_torch import kernels
    from tpuvec_torch.device import resolve

    resolve(device)
    t0 = time.time()
    built = kernels.build_all()
    entry_points = {name: [fn for fn in kernels.SOURCES[name] if "cuda_error" not in fn] for name in built}
    _log(f"build: {entry_points} compiled and loaded in {time.time() - t0:.1f}s")

    update_shapes = check_beam_kernel(torch, device)
    run = run_main_path(torch, device, args.n)
    loop_shapes = check_loop_kernel(torch, device, run)
    trace_main_path(torch, device, run)

    def entry(name, replaces, shapes):
        main_shape = shapes[-1]  # the construction shape: most of the path's time
        return {
            "name": name,
            "route": "cuda",
            "source": "tpuvec_torch/csrc/beam_update.cu",
            "replaces": replaces,
            "launches": run["launches"][name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": None,
            "shapes": shapes,
        }

    kernels_line = [
        entry("beam_update", "tpuvec/ops/pallas_beam.py:144", update_shapes),
        entry("beam_search_level0",
              "tpuvec/ops/pallas_beam.py:144 + tpuvec/index/search.py:336-357", loop_shapes),
    ]
    _log(card)
    _log(json.dumps({"kernels": kernels_line}))
    _log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
