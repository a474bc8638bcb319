"""Smoke run of tpuvec_torch on one NVIDIA GPU (H100): the quickest proof
that the port still starts, builds its kernels and is right on the card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. card: the card's name and power limit from nvidia-smi (no card: exit);
2. build: compile every CUDA kernel from tpuvec_torch/csrc with nvcc (the
   entry points tpuvec_beam_update, tpuvec_beam_search_level0 and
   tpuvec_level0_occupancy), and print ptxas's registers, spills and
   static shared memory for each kernel and each of the loop kernel's six
   forms;
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
   beside its bound and the plain loop's time. Also at the construction
   shape: the kernel with 1, 5, 8 and W row slots in its ring exactly equal
   to the kernel with the slots its launch plan gives (the refills and the
   ring's laps), and with rows of 16384 floats (past 48 KB of shared
   memory) against the plain loop, and of 65536 (past the card): ValueError;
5. trace: a separate traced run, for where the time goes: the build with
   a synchronised timer per insert stage and around the candidates stage's
   descent and level-0 loop, one search batch split the same way, and one
   search batch under torch.profiler;
6. quantized: BASELINE configs 3 and 4 at 100K x 1024 (--n sets the rows;
   the sources run 1M): config 3 is INT8 cosine with an f32 rerank, data
   and sweep as scripts/bench_suite.py:config_3 draws them; config 4 is
   BINARY (Hamming) with an int8 shadow, rerank and one-hop expansion, data
   and sweep as scripts/probe_10m_binary.py draws them. Both with m=16,
   max_m0=32, ef_construction=200, built with max_batch=1024 and searched
   in batches of 256; recall@10 against the exact f32 cosine scan of the
   originals and QPS at every point, the build rate, and the split of one
   batch into descent, level-0 loop and rerank (phase 5's timers). The
   loop kernel's int8 form must launch in config 3's build and search, its
   word form in config 4's;
3c. quantized loop forms, on phase 6's graphs: beam_loop against
   beam_loop_plain at the search shape (256 queries, EF=64, E=1) and the
   construction shape (1024 held-out rows, EF=256, E=2, the build's
   iteration budget): int8 squared L2 (config 3's form), int8 L1 and
   Hamming (config 4's form) exactly equal in ids, distances and
   iterations (integer distances, the same stable merge); int8 raw cosine
   within 1e-6 in distance with ids equal wherever slots are more than 1e-6
   apart; each form's device time per launch beside its bound and the
   plain loop's time;
7. deletes and filters at the index layer, the path under VecTable's
   filtered queries and deletes (each masked form of the loop kernel must
   launch in it):
   - filtered HNSW on phase 4's graph, the whole batch under one mask as
     VecTable._hnsw passes it: masks of 50% (even ids), 10% (id % 10 == 0)
     and 1% (id % 100 == 0) at ef 64 and 256, k=10; every returned id must
     pass its mask; recall@10 against the exact masked scan and QPS, with
     recall >= 0.90 asserted at 50%, ef=256 (tests/test_table.py's floor);
   - the per-query coded exact scan (BASELINE config 5 at the index
     layer): 1000 tenants, code = id % 1000, 256 queries each with its own
     tenant plus one of code -2 (no tenant); ids and distances must equal
     a masked exact scan per tenant; QPS;
   - deletes on a copy of phase 4's graph: every 10th id and the entry
     point; delete_ids' time; no edge may point at a deleted id, the entry
     point must be live at the highest live level, count must be n minus
     the deleted; recall@10 of unfiltered search at ef 48 / 64 against the
     exact scan of the live rows, and of a 10% filtered search
     (id % 10 == 5) after the deletion;
   - filtered search on phase 6's graphs at the 10% mask: config 3 (int8
     search + f32 rerank) and config 4 as VecTable._binary_rerank runs it
     (filtered Hamming search, then expand_rerank_topk with the mask);
3d. masked loop forms, on phase 7's graphs and 10% masks at every shape
   phase 7 gives them (256 queries, E=1): f32 at k=10 (KP=32) and EF 64
   and 256, int8 and words at k=48 (KP=128), EF=64, max_iters=64;
   beam_loop(node_mask=) against beam_loop_plain(node_mask=); int8
   squared L2 and Hamming exactly equal (result ids and distances,
   iterations), f32 held to phase 3b's tolerances; each form's device
   time per launch beside its bound (the distinct rows, as phase 3b counts
   them, plus the mask bytes they read) and the plain loop's time;
8. the table on the card (tpuvec_torch/store/table.py), each part driven
   with the launch counts set to 0 just before it and read just after:
   8a. BASELINE config 5 at its source's full size whatever --n says
   (scripts/bench_suite.py:config_5: 262,144 x 384 cosine, 1024 tenants,
   default HnswParams(), initial_cap=n): insert_many of every row (vec/s,
   the flush split by the insert stage timers); 64 single-tenant
   knn(partition=) calls (QPS, purity 1.0, each min(k, tenant rows) long);
   knn_many with per-query partitions, B=64 x 4 (QPS, equal to the
   single-tenant calls); 256 unfiltered knn_many queries through HNSW
   against knn_many(exact=True) (recall@10 >= 0.90, QPS); one knn_many
   under a 50% predicate (the f32+mask form; every rowid must pass);
   delete_many of every 10th rowid (integrity_check() == [], no deleted
   rowid returned); update_many of 256 rows (row() returns the new
   vectors); rebuild("e") and recall@10 >= 0.90 again. The f32 form must
   launch in the flush and in the reads, f32+mask in the predicate query.
   Then, on the table's graph, the loop kernel against beam_loop_plain at
   the shapes config 5 gives it (search EF=256, W=64; construction EF=512,
   E=2, W=128, at B=256 and at B=1, which the first batches of an insert
   into an empty graph launch; the predicate's masked search under the
   table's 50% mask, KP=32, EF=256, W=64) to phase 3b's tolerances, with
   device time and bound;
   8b. config 4 through the table: phase 6's data and params, 1024-d f32
   with BINARY quantization and a metadata column bucket = rowid % 10;
   the column must hold its f32 rerank shadow on the card; knn_many
   unfiltered and under filters={"bucket": 5}, each through the device
   expansion rerank, recall@10 >= 0.90 against the exact f32 scan, every
   rowid in its bucket; the words form must launch in the flush and the
   reads, words+mask in the filtered read. Each read's split into descent,
   level-0 loop, exact scan, rerank and host is logged. Then, on the
   table's graph, the words form against beam_loop_plain at the flush's
   construction shape (EF=256, E=2, W=64, at B=256 and at B=1) and the
   reads' search shape (k=100: EF=128, W=32), and words+mask under the
   table's bucket-5 mask at the filtered read's shape (KP=256, EF=128),
   each exactly equal. Each part records the shape (form, EF, W, E, KP,
   Dp, B == 1) of every loop kernel call its path makes, and fails if one
   of them is not among the shapes it then holds, a launch of one query
   held at B=1 (16 queries, one a launch);
9. persistence on the card (tpuvec_torch/store/snapshot.py, follower.py,
   native.py; tvstore is compiled from csrc/tvstore.cpp with g++ into
   build/native/), in a temporary directory, after phase 8a's holds:
   9a. phase 8a's table after its deletes, updates and rebuild (free
   slots, scalars and tombstones all present; about 1.99 GB) saved through
   tvstore (bytes, seconds, GB/s) and loaded on the card (seconds, GB/s;
   and the file's read alone, with and without the CRC check);
   the loaded table must equal the live one: rowid map, next slot, free
   slots, max rowid, live slots, each slot's scalar value, the raw
   originals, every graph field (torch.equal), integrity_check() == [];
   knn_many of the 256 queries must give identical rowids and equal
   distances on four routes: HNSW, the exact scan, one tenant a query and
   the 50% predicate (f32 and f32+mask must launch, counted as "phase 9");
   then a tvstore file past 2^31 bytes (a 2^31 + 2^20-byte section and one
   after it) through the port's bindings must read back equal;
   9b. a second OS process that imports only tpuvec_torch follows the file
   with SnapshotFollower on the card and answers the 256 queries through
   HNSW: equal to the writer's, bitwise; its load time and its time from
   start to first answer;
   9c. at a cut, the first 20,000 rows of config 5's data with its
   columns: an npz round trip held as in 9a; insert_many with autosave
   off, then into a writer under writer_lock with autosave_path (tvstore)
   and the default autosave_every=16 (vec/s of both, the saves that
   completed); a second writer_lock on the path must raise; a reader
   process follows the last autosave, the writer commits the rest with
   snapshot.save, and the reader's refresh() must return True with all
   20,000 rows and answers equal to the writer's;
   and prints a {"snapshot": ...} line with those figures;
10. the vec0 SQL surface on the card (tpuvec_torch/sql/), after phase 8b,
   the earlier tables freed: connect(device="cuda") and CREATE VIRTUAL
   TABLE docs USING vec0(emb float[768] hnsw(M=32, ef_construction=400),
   label TEXT) (BASELINE.md's 768D SQL insert settings; ef_search the DDL
   default 200) over phase 4's --n x 768 rows, label = 'l' || (rowid % 10):
   BEGIN, executemany of every INSERT with f32 blobs, COMMIT (vec/s, the
   statements' handling against the flush by the insert stage timers) and
   VecTable.insert_many of the same rows beside it; phase 4's 256 queries
   as 256 single `SELECT rowid, distance FROM docs WHERE emb MATCH ? AND
   k = 10` statements at the default ef and with `AND ef = ?` at 16, 32
   and 64: each statement's rows bitwise equal to VecTable.knn, recall@10
   >= 0.95 against knn_many(exact=True) at the default ef, p50 / p99 ms,
   statements/s and a statement's split into host, descent and level-0
   loop (synchronised timers, over the first 32 statements of each ef); the same under `AND label = ?` (10% of
   rows): every rowid carries its label, recall@10 >= 0.90 against the
   exact masked scan; a KNN join with a plain SQLite table and a CTE over
   a MATCH must give the planner's rowids and distances; a full-table
   GROUP BY through the mirror on a cut table of the first 10,000 rows
   (seconds, microseconds a row, and the full table too when that
   predicts <= 60 s at --n); DELETE of every 10th rowid in a transaction,
   ROLLBACK: the count and the 256 statements' answers as before; the
   deletes again, committed; UPDATE of 100 rows by rowid, each read back;
   integrity_check() == []; vec_rebuild_hnsw('docs', 'emb', 16, 200) and
   recall@10 >= 0.95 again. Every KNN statement must launch the loop
   kernel (f32, or f32+mask under the label), and the UPDATEs and the
   rebuild must launch it; the launches reported as phase 10's are those
   of SQL statements alone, not of the VecTable calls they are held
   against (their counts are set aside). Then every loop-kernel shape the phase
   launched is held against beam_loop_plain to phase 3b's tolerances on
   the table's graph before and after the rebuild, a launch of one query
   (B=1) at B=1 (16 queries, one a launch) and a launch of more at
   B=256, and the phase fails if a shape it launched is not held; it
   prints a {"sql": ...} line with those figures;

Device times per launch are torch.profiler's; where its trace kept no
launch of a kernel, they are CUDA events around the launches, and the
kernels line says so ("ms_source": "cuda_events" in place of "profiler").
Every loop-kernel shape also carries its launch plan (ops/beam.py:
_loop_plan): "ring_slots", "smem_bytes", "blocks_per_sm" (the CUDA
occupancy query, beside the plan's own count) and "waves"; "us_per_iter",
the device time per launch over the launch's iterations; and
"phase_cycles", the SM cycles of each phase of an iteration (dedup, rows,
merge, frontier, each its own work and then its wait at the barrier after
it) from the same source built with -DTPUVEC_LOOP_CLOCKS, a second build
that phase 2 starts beside the first.

    python3 chip_smoke.py --against NAME=PATH[,FLAG...] ...

also builds the loop kernel from another beam_update.cu (an earlier
commit's, or a variant, with extra nvcc FLAGs) and times it beside this
tree's at every held shape, in turns (other, this, this, other; CUDA
events), under "against" in the shape's numbers.
The last lines are the {"snapshot": ...} and {"sql": ...} lines, the card's name and power
limit, a JSON line with every kernel's numbers (its launches on the main
paths in all, and by phase in "launches_by_path") and the JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import select
import subprocess
import sys
import tempfile
import time

import numpy as np

# HBM rate, non-tensor-core float32 rate and int8 rate of one H100 SXM
# (data sheet)
_HBM_BYTES_PER_S = 3.35e12
_F32_OPS_PER_S = 67e12
_INT8_OPS_PER_S = 1979e12

# BASELINE.md config 2 (100K x 768 cosine, k=10); queries as bench.py draws them
N, D, NQ, REPS, K = 100_000, 768, 256, 5, 10
# BASELINE.md configs 3 and 4 (1024 dims; the sources run 1M and 10M rows)
QD = 1024
GEN_CHUNK = 250_000  # scripts/probe_10m_binary.py's rows per seeded chunk
# BASELINE.md config 5 as scripts/bench_suite.py:config_5 runs it, whatever
# --n says: rows, dims, tenants; the per-query batch and its reps
C5_N, C5_D, C5_TENANTS, C5_B, C5_REPS = 262_144, 384, 1024, 64, 4
# phase 9c's cut: the first rows of config 5's data (np.savez_compressed
# of the full 2 GB table would take about a minute of the host's zlib)
C9_N = 20_000
# phase 10: the SQL surface on BASELINE.md's 768D SQL insert settings
# (in-memory + transaction, M=32, ef_construction=400; ef_search stays the
# DDL default 200) over phase 4's data; the efs bound by `AND ef = ?`
# besides the default; the rows of the cut table the full-table composed
# statement runs on (it mirrors every row as JSON text); the statements of
# each ef whose layers are timed apart
SQL_DDL = ("CREATE VIRTUAL TABLE docs USING vec0(emb float[768] hnsw(M=32, ef_construction=400), "
           "label TEXT)")
SQL_EFS = (None, 16, 32, 64)
SQL_MIRROR_N = 10_000
SQL_SPLIT_N = 32
# the queries a B=1 shape (one query a launch: a SQL statement, or the first
# batches of a table's doubling insert schedule) is held on, one a launch
B1_QUERIES = 16
# the loop kernel's name in a profiler trace, and its C entry point
_LOOP_KERNEL = ("beam_search_level0_kernel", "tpuvec_beam_search_level0")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _log_ptxas(source: str, report: str) -> None:
    """ptxas's lines on each kernel of ``source`` as it wrote them: the
    (mangled) entry's name, then its stack and spills and its registers."""
    for line in report.splitlines():
        if "entry function" in line or "spill" in line or "Used" in line:
            _log(f"build: ptxas {source}.cu: {line.strip()}")


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


def _launch_ms(fn, reps: int, entry: str) -> float:
    """Time per launch from CUDA events recorded on the stream right before
    and after each call of the C entry point ``entry`` inside ``fn``: the
    kernel's time on the card plus its launch latency, no host work."""
    import torch
    from tpuvec_torch import kernels

    lib = kernels.load("beam_update")
    launch, spans = getattr(lib, entry), []

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = launch(*args)
        end.record()
        spans.append((start, end))
        return rc

    setattr(lib, entry, timed)
    try:
        for _ in range(reps):
            fn()
    finally:
        setattr(lib, entry, launch)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / len(spans)


def _device_ms(fn, reps: int, kernel: str, entry: str) -> tuple[float, str]:
    """(ms, source): the device time per launch of the CUDA kernel whose
    name contains ``kernel``, from a torch.profiler trace of ``reps`` calls
    of ``fn`` (source "profiler"). The trace can keep fewer launches than
    ran (at 1M rows, from phase 3c on, one in ten or none): then the time
    by CUDA events around the launches of C entry ``entry`` is logged
    beside it, and taken (source "cuda_events") when the trace kept none."""
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
    if count == reps:
        return sum(ev.device_time_total for ev in hits) / count / 1e3, "profiler"
    ev_ms = _launch_ms(fn, reps, entry)
    if count == 0:
        _log(f"kernels: profiler kept no launch of {kernel} in {reps} calls; CUDA events "
             f"around the launch: {ev_ms:.4f} ms")
        return ev_ms, "cuda_events"
    ms = sum(ev.device_time_total for ev in hits) / count / 1e3
    _log(f"kernels: profiler kept {count} of {reps} launches of {kernel}: {ms:.4f} ms; CUDA "
         f"events around the launch: {ev_ms:.4f} ms")
    return ms, "profiler"


def _reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from tpuvec_torch.ops.beam import beam_loop, beam_update

    beam_update.launches = beam_loop.launches = 0
    beam_loop.form_launches = dict.fromkeys(beam_loop.form_launches, 0)


def _launches():
    """(the loop kernel's launches by form, beam_update's launches)."""
    from tpuvec_torch.ops.beam import beam_loop, beam_update

    return dict(beam_loop.form_launches), beam_update.launches


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
            ms, ms_source = _device_ms(lambda: beam_update(*args, n_expand=e), 100,
                                       "beam_update_kernel", "tpuvec_beam_update")
            call_ms = _time_ms(lambda: beam_update(*args, n_expand=e), 200)
            plain_ms = _time_ms(lambda: beam_update_plain(*args, n_expand=e), 20)
            bound_ms, bound_by = _beam_bound(args, ker, e)
            shapes.append(dict(B=b, EF=efp, W=w, E=e, ms=ms, ms_source=ms_source, call_ms=call_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               max_abs_err=err))
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
    _reset_launches()
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
    launches["f32"] = beam_loop.form_launches["f32"]
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
                data=data, n=n, gt=gt, qp=qp, rep_qs=rep_qs)


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


def _loop_bound(torch, args, fresh, adj, outs, masked=False):
    """(bound_ms, bound_by, distinct bytes, per-visit bytes) of one loop
    launch: the distinct vector and adjacency rows the batch's loop reads,
    each once (``masked``: and the mask byte of each distinct fresh id),
    plus q, the beam and frontier (and result buffer) in and the outputs,
    against the HBM rate; two multiply-adds per element of every fresh row
    against the float32 rate (int8 rows: the int8 rate; words: three
    operations a word at the float32 rate)."""
    q, vectors, adj0 = args[:3]
    row_v = vectors.shape[1] * vectors.element_size() + (1 if masked else 0)
    row_a = adj0.shape[1] * adj0.element_size()
    small = sum(t.numel() * t.element_size() for t in (q, *args[3:], *outs))
    distinct = torch.unique(fresh).numel() * row_v + torch.unique(adj).numel() * row_a + small
    per_visit = fresh.numel() * row_v + adj.numel() * row_a + small
    if vectors.dtype == torch.int8:  # two multiply-adds an element, int8 rate
        per_elem, rate = 4, _INT8_OPS_PER_S
    elif vectors.dtype == torch.int32:  # xor, popcount, add a word
        per_elem, rate = 3, _F32_OPS_PER_S
    else:  # two multiply-adds an element, float32 rate
        per_elem, rate = 4, _F32_OPS_PER_S
    ops = fresh.numel() * per_elem * vectors.shape[1]
    t_bytes, t_ops = distinct / _HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, distinct, per_visit)


def _check_one_iteration(torch, label, kd, ki, pd, pi, tol=1e-5, when="after 1 iteration") -> float:
    """Kernel vs plain (by default after one iteration): the same +inf
    slots, distances within ``tol``, ids equal wherever a slot's distance is
    more than ``tol`` from its neighbours'. Returns the largest distance
    error."""
    fin = torch.isfinite(pd)
    if not torch.equal(fin, torch.isfinite(kd)):
        raise AssertionError(f"beam_loop {label}: +inf slots differ from plain {when}")
    err = float((kd - pd)[fin].abs().max()) if fin.any() else 0.0
    if err > tol:
        raise AssertionError(f"beam_loop {label}: distance error {err} > {tol:g} {when}")
    gap = torch.nan_to_num(torch.diff(pd, dim=1), nan=math.inf)  # +inf - +inf: padding
    edge = torch.full_like(pd[:, :1], math.inf)
    apart = (torch.cat([edge, gap], 1) > tol) & (torch.cat([gap, edge], 1) > tol)
    bad = int(((ki != pi) & apart).sum())
    if bad:
        raise AssertionError(f"beam_loop {label}: {bad} separated slots hold other ids than plain {when}")
    return err


# Loop kernels built beside this tree's: the --against ones by name, each
# held shape also timed with them in turns; and this tree's own source
# built with -DTPUVEC_LOOP_CLOCKS, for each held shape's phase cycles.
_AGAINST = {}
_CLOCKS = "phase-clocks"


class _OtherLoopKernel:
    """A loop kernel library built from another beam_update.cu, in the place
    of this tree's in beam_loop's calls (``_using``). A source whose entry
    point takes no ring size (before the ring) gets the call without it."""

    def __init__(self, lib, takes_ring):
        self._lib, self._takes_ring = lib, takes_ring
        self.clocks = getattr(lib, "tpuvec_loop_clocks", None)  # a clocks build's

    def tpuvec_beam_search_level0(self, *args):
        if not self._takes_ring:  # drop `ring`, the argument before the stream
            args = args[:-2] + args[-1:]
        return self._lib.tpuvec_beam_search_level0(*args)

    def tpuvec_cuda_error_string(self, code):
        return self._lib.tpuvec_cuda_error_string(code)


def _start_other_builds(specs):
    """Start one nvcc for this tree's source with -DTPUVEC_LOOP_CLOCKS and one
    for each NAME=PATH[,FLAG...] of --against (flags as this tree's kernels
    are built with, and FLAGs); returns name -> (process, library path)."""
    import hashlib
    from pathlib import Path

    from tpuvec_torch import kernels

    builds = {_CLOCKS: (kernels._CSRC / "beam_update.cu", ["-DTPUVEC_LOOP_CLOCKS"])}
    for spec in specs:
        name, _, rest = spec.partition("=")
        path, *flags = rest.split(",")
        builds[name] = (Path(path), flags)
    kernels._BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in builds.items():
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
        out = kernels._BUILD / f"lib{name}-{digest}.so"
        cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, *flags, "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    return procs


def _load_other_builds(procs):
    """Wait for _start_other_builds' builds, log their ptxas lines and load
    them: the clocks build returned, the --against ones into _AGAINST."""
    import ctypes

    from tpuvec_torch import kernels

    clocks = None
    for name, (proc, out) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        if name != _CLOCKS:
            _log_ptxas(f"against {name}", report)
        lib = ctypes.CDLL(str(out))
        takes_ring = hasattr(lib, "tpuvec_level0_occupancy")
        argtypes, restype = kernels.SOURCES["beam_update"]["tpuvec_beam_search_level0"]
        lib.tpuvec_beam_search_level0.argtypes = argtypes if takes_ring else argtypes[:-2] + argtypes[-1:]
        lib.tpuvec_beam_search_level0.restype = restype
        lib.tpuvec_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpuvec_cuda_error_string.restype = ctypes.c_char_p
        if name == _CLOCKS:
            lib.tpuvec_loop_clocks.argtypes = [ctypes.c_void_p]
            lib.tpuvec_loop_clocks.restype = ctypes.c_int
            clocks = _OtherLoopKernel(lib, takes_ring)
            continue
        _AGAINST[name] = _OtherLoopKernel(lib, takes_ring)
        _log(f"build: --against {name} built from {out.name} (entry point "
             f"{'with' if takes_ring else 'without'} a ring size)")
    return clocks


@contextlib.contextmanager
def _using(lib):
    """beam_loop's calls go to ``lib`` inside the block."""
    from tpuvec_torch import kernels

    own = kernels.load("beam_update")
    kernels._libs["beam_update"] = lib
    try:
        yield
    finally:
        kernels._libs["beam_update"] = own


@contextlib.contextmanager
def _ring_slots(ring):
    """beam_loop launches with ``ring`` row slots inside the block, whatever
    its launch plan says."""
    from tpuvec_torch.ops import beam

    plan = beam._loop_plan
    beam._loop_plan = lambda *a, **k: (ring, *plan(*a, **k)[1:])
    try:
        yield
    finally:
        beam._loop_plan = plan


def _occupancy(form, ef, m0, e, dp, kp, ring):
    """(blocks an SM holds, shared memory a block) of the loop kernel at this
    shape, from the kernel library (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes

    from tpuvec_torch import kernels
    from tpuvec_torch.ops.beam import _ROWS

    codes = {name: code for name, _, code in _ROWS.values()}
    masked = form.endswith("+mask")
    smem = ctypes.c_int64()
    blocks = kernels.load("beam_update").tpuvec_level0_occupancy(
        codes[form.removesuffix("+mask")], int(masked), ef, m0, e, dp, kp if masked else 0, ring,
        ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError(f"tpuvec_level0_occupancy failed for {form} at EF={ef}: {blocks}")
    return blocks, smem.value


def _loop_fields(torch, form, args, kw, max_iters, ms, iters):
    """The launch plan's numbers of one loop-kernel shape (ring slots, shared
    memory, blocks an SM holds by the CUDA occupancy query and by the plan,
    waves), its device time per iteration run, the cycles of each phase of
    an iteration (the clocks build), and, for each --against kernel, both
    kernels' time per launch by CUDA events, in turns (other, this, this,
    other). Fails if the plan's shared memory is not the kernel's."""
    from tpuvec_torch.ops.beam import _loop_plan, beam_loop

    q, adj0, beam_d, cand = args[0], args[2], args[3], args[6]
    b, efp, dp, e, m0 = q.shape[0], beam_d.shape[1], q.shape[1], cand.shape[1], adj0.shape[1]
    kp = args[8].shape[1] if form.endswith("+mask") else 0
    ring, smem, plan_bps, waves = _loop_plan(form, b, efp, e * m0, e, dp, kp)
    bps, kernel_smem = _occupancy(form, efp, m0, e, dp, kp, ring)
    if kernel_smem != smem:
        raise AssertionError(f"beam_loop {form} EF={efp} W={e * m0}: the plan counts {smem} bytes "
                             f"of shared memory, the kernel {kernel_smem}")
    out = dict(ring_slots=ring, smem_bytes=smem, blocks_per_sm=bps, plan_blocks_per_sm=plan_bps,
               waves=waves, us_per_iter=ms * 1e3 / max(iters, 1))

    def call():
        beam_loop(*args, **kw, max_iters=max_iters)

    out["phase_cycles"] = _phase_cycles(_PHASE_CLOCKS, call)
    if _AGAINST:
        out["against"] = {}
        for name, lib in _AGAINST.items():
            turns = []
            for other in (True, False, False, True):
                with _using(lib) if other else contextlib.nullcontext():
                    call()  # the library's first launch loads its module
                    turns.append(_launch_ms(call, 10, _LOOP_KERNEL[1]))
            out["against"][name] = dict(ms=[turns[0], turns[3]], this_ms=[turns[1], turns[2]])
            _log(f"kernels: {form} B={b} EF={efp} W={e * m0}: {name} {turns[0]:.4f} / "
                 f"{turns[3]:.4f} ms, this tree {turns[1]:.4f} / {turns[2]:.4f} ms per launch "
                 "(CUDA events, in turns)")
    return out


# The clocks build of this tree's loop kernel (_load_other_builds), and the
# phases of an iteration as it times them
_PHASE_CLOCKS = None
_PHASES = ("dedup", "dedup_wait", "rows", "rows_wait", "merge_window", "merge_beam",
           "merge_wait", "frontier", "frontier_wait")


def _phase_cycles(lib, call):
    """SM cycles of each phase of a block's iteration, barrier to barrier, as
    thread 0 of each block sees them, averaged over the blocks' iterations
    of 10 launches of ``call`` through ``lib`` (a -DTPUVEC_LOOP_CLOCKS
    build)."""
    import ctypes

    import torch

    clocks = (ctypes.c_uint64 * (len(_PHASES) + 1))()
    with _using(lib):
        torch.cuda.synchronize()
        lib.clocks(clocks)
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        if lib.clocks(clocks):
            raise RuntimeError("tpuvec_loop_clocks failed")
    iters = max(clocks[len(_PHASES)], 1)
    cycles = {p: clocks[k] / iters for k, p in enumerate(_PHASES)}
    total = sum(cycles.values())
    _log("kernels:   phase cycles per block iteration: " + ", ".join(
        f"{p} {c:.0f} ({c / total:.0%})" for p, c in cycles.items()) + f"; {total:.0f} in all")
    return cycles


def _fmt_plan(plan):
    return (f"{plan['us_per_iter']:.2f} us per iteration; {plan['ring_slots']} ring slots, "
            f"{plan['smem_bytes']} B of shared memory, {plan['blocks_per_sm']} blocks an SM "
            f"(plan {plan['plan_blocks_per_sm']}), {plan['waves']} waves")


def _check_ring_sizes(torch, cfg, state, q, ef, e, max_iters):
    """The loop kernel with fewer ring slots than its plan (one slot, a few,
    eight) and with the whole window, on phase 4's graph: every result
    exactly equal to the planned ring's, since a row's distance is reduced
    the same way in whatever slot it lands. Fewer slots than fresh rows run
    the refills and the ring's laps within an iteration."""
    from tpuvec_torch.index.search import descend_to_level1, seed_beam
    from tpuvec_torch.ops.beam import beam_loop

    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized, max_iters=max_iters)
    args = (q, state.vectors, state.adj0, *seed_beam(*descend_to_level1(cfg, state, q), ef=ef, n_expand=e))
    want = beam_loop(*args, **kw)
    w = e * cfg.max_m0
    for ring in (1, 5, 8, w):
        with _ring_slots(ring):
            got = beam_loop(*args, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]):
            raise AssertionError(f"beam_loop B={q.shape[0]} EF={args[3].shape[1]} W={w}: {ring} ring "
                                 "slots give another result than the planned ring")
    _log(f"kernels: beam_loop at B={q.shape[0]} EF={args[3].shape[1]} W={w} with 1, 5, 8 and {w} "
         "ring slots exactly equal to its planned ring")


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
    from tpuvec_torch.index.search import default_max_iters

    cfg, state, n, data = run["cfg"], run["state"], run["n"], run["data"]
    qc = prepare_vectors(cfg, data[n + NQ : n + NQ + 1024], device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    _, gt_c = bruteforce_knn(qc, run["xp"], valid, metric=cfg.graph_metric, k=K, normalized=True)
    efc = max(cfg.ef_construction, cfg.max_m0)
    cases = [
        (run["qp"], run["gt"], 64, 1, default_max_iters(64, 1)),
        (qc, gt_c.cpu().numpy(), efc, 2, _build_iter_budget(cfg.cap, efc, 2)),
    ]
    _check_loop_smem(torch, device)
    _check_ring_sizes(torch, cfg, state, qc, efc, 2, cases[1][4])
    return _hold_loop(torch, cfg, state, cases)


def _each(torch, fn, argsets, **kw):
    """``fn`` (beam_loop or beam_loop_plain) on each argument set in turn:
    the distances and ids stacked, and each call's iterations."""
    outs = [fn(*args, **kw) for args in argsets]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), [o[2] for o in outs]


def _loop_argsets(cfg, state, q, ef, e, one_by_one=0, **seed_kw):
    """The loop's arguments for the queries ``q``: one batch of them, or
    (``one_by_one``) a batch of one for each of the first ``one_by_one``."""
    from tpuvec_torch.index.search import descend_to_level1, seed_beam

    qs = [q[j : j + 1] for j in range(one_by_one)] if one_by_one else [q]
    return [(qq, state.vectors, state.adj0,
             *seed_beam(*descend_to_level1(cfg, state, qq), ef=ef, n_expand=e, **seed_kw)) for qq in qs]


def _hold_loop(torch, cfg, state, cases, one_by_one=0):
    """beam_loop against beam_loop_plain on one f32 graph, for each case
    (queries, their exact top-10 ids, ef, E, max_iters): after one
    iteration within 1e-5 (ids equal where slots are apart); over the full
    loop >= 99% of top-10 ids equal and recall@10 within 0.002. With
    ``one_by_one`` the first that many queries run as batches of one (B=1),
    each launch held the same way, and the times are a launch of one.
    Returns each shape's numbers: device time, bound, the plain loop's time."""
    from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain

    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized)
    shapes = []
    for q, gt, ef, e, max_iters in cases:
        argsets = _loop_argsets(cfg, state, q, ef, e, one_by_one)
        args = argsets[0]
        b, efp, w, dp = args[0].shape[0], args[3].shape[1], e * cfg.max_m0, q.shape[1]
        nq = one_by_one or q.shape[0]
        label = f"B={b} EF={efp} W={w} E={e}" + (f" ({nq} queries, one a launch)" if one_by_one else "")
        one_k = _each(torch, beam_loop, argsets, **kw, max_iters=1)
        one_p = _each(torch, beam_loop_plain, argsets, **kw, max_iters=1)
        err = _check_one_iteration(torch, label, one_k[0], one_k[1], one_p[0], one_p[1])

        kd, ki, k_its = _each(torch, beam_loop, argsets, **kw, max_iters=max_iters)
        fresh, adj, (pd, pi, p_it) = _loop_visits(torch, args, dict(kw, max_iters=max_iters))
        p_its = [p_it]
        if one_by_one:  # the bound counts the first launch's rows; the hold, every launch's
            pd, pi, p_its = _each(torch, beam_loop_plain, argsets, **kw, max_iters=max_iters)
        k_it, p_it = max(k_its), max(p_its)
        same = float((ki[:, :K] == pi[:, :K]).float().mean())
        r_k, r_p = _recall(ki[:, :K].cpu().numpy(), gt[:nq]), _recall(pi[:, :K].cpu().numpy(), gt[:nq])
        if same < 0.99 or abs(r_k - r_p) > 0.002:
            raise AssertionError(
                f"beam_loop {label}: top-10 ids equal {same:.4f} (< 0.99?), recall@10 "
                f"{r_k:.4f} vs plain {r_p:.4f} (more than 0.002 apart?)"
            )
        # the times, the bound and the plan are those of the first launch
        ms, ms_source = _device_ms(lambda: beam_loop(*args, **kw, max_iters=max_iters), 10,
                                   *_LOOP_KERNEL)
        call_ms = _time_ms(lambda: beam_loop(*args, **kw, max_iters=max_iters), 10)
        plain_ms = _time_ms(lambda: beam_loop_plain(*args, **kw, max_iters=max_iters), 3, warm=1)
        iters_t = torch.empty((b,), dtype=torch.int32)
        bound_ms, bound_by, distinct, per_visit = _loop_bound(torch, args, fresh, adj,
                                                              (kd[:b], ki[:b], iters_t))
        plan = _loop_fields(torch, "f32", args, kw, max_iters, ms, k_its[0])
        shapes.append(dict(
            B=b, EF=efp, W=w, E=e, Dp=dp, max_iters=max_iters, iters=k_its[0], plain_iters=p_its[0],
            ms=ms, ms_source=ms_source, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            distinct_bytes=distinct, per_visit_bytes=per_visit, max_abs_err=err,
            top10_same=same, recall=r_k, plain_recall=r_p, **plan,
            **({"queries_held": nq, "most_iters": k_it} if one_by_one else {}),
        ))
        _log(
            f"kernels: beam_loop ~ plain at {label} Dp={dp}: 1 iteration max err {err:.2e}; "
            f"full loop ({k_it} iterations, plain {p_it}) top-10 ids equal {same:.4f}, "
            f"recall@10 {r_k:.4f} vs plain {r_p:.4f}; device {ms:.4f} ms per launch "
            f"(bound {bound_ms:.5f} ms by {bound_by}: {distinct / 1e6:.2f} MB distinct, "
            f"{per_visit / 1e6:.2f} MB per visit); back-to-back calls {call_ms:.4f} ms, "
            f"plain loop {plain_ms:.2f} ms; {_fmt_plan(plan)}"
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

    _log_busy(torch, f"search batch at ef={ef}", lambda: search_graph(cfg, state, q, k=K, ef=ef))


def _log_busy(torch, label, fn):
    """One call of ``fn`` under torch.profiler: its wall time, the time the
    device was busy (the union of its kernels' spans), the device ops and
    the four costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = sorted(
        (ev.time_range.start, ev.time_range.end, ev.name)
        for ev in prof.events() if ev.device_type == DeviceType.CUDA
    )
    if not spans:
        _log(f"trace: {label}: the profiler recorded no device time (not measured)")
        return
    busy, end, by_name = 0.0, -math.inf, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    _log(
        f"trace: {label}: {wall_us / 1e3:.2f} ms traced, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%}), {len(spans)} device ops; top: "
        + "; ".join(f"{name[:48]} {us / 1e3:.2f} ms" for name, us in top)
    )


def _config3_data(n):
    """Config 3's corpus and queries as scripts/bench_suite.py:config_3
    draws them: one call, the queries after the corpus."""
    from tpuvec_torch.utils.data import synthetic_embeddings

    data = synthetic_embeddings(n + NQ * (REPS + 1), QD, n_clusters=1024, seed=3)
    return data[:n], data[n:].copy()


def _config4_data(n):
    """Config 4's corpus and queries as scripts/probe_10m_binary.py draws
    them: the corpus in seeded chunks of GEN_CHUNK rows on one manifold
    (structure_seed 77), the queries from the first rows of the chunk after
    the corpus (at n <= GEN_CHUNK the probe's own query draw would reuse the
    corpus's seed, so the next chunk's seed is taken)."""
    from tpuvec_torch.utils.data import synthetic_embeddings

    kw = dict(n_clusters=1024, structure_seed=77)
    corpus = np.concatenate([
        synthetic_embeddings(min(GEN_CHUNK, n - s), QD, seed=10_000 + s // GEN_CHUNK, **kw)
        for s in range(0, n, GEN_CHUNK)
    ])
    queries = synthetic_embeddings(GEN_CHUNK, QD, seed=10_000 + -(-n // GEN_CHUNK), **kw)
    return corpus, queries[: NQ * (REPS + 1)]


def _sweep_point(torch, label, fn, reps_in, gt, n):
    """Run ``fn(prepared queries, f32 queries)`` on the first query batch
    (scored) and time it over the other batches; checks the output's shape,
    ids and ascending finite distances. Returns (recall@10, QPS)."""
    d0, i0 = fn(*reps_in[0])
    torch.cuda.synchronize()
    t0 = time.time()
    for ri in reps_in[1:]:
        fn(*ri)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / (len(reps_in) - 1)
    dh, ih = d0.cpu().numpy(), i0.cpu().numpy()
    if dh.shape != (NQ, K) or not np.isfinite(dh).all() or (ih < 0).any() or (ih >= n).any():
        raise AssertionError(f"quantized: {label}: output malformed")
    if (np.diff(dh, axis=1) < 0).any():
        raise AssertionError(f"quantized: {label}: distances not ascending")
    recall = _recall(ih, gt)
    _log(f"quantized: {label}: recall@10={recall:.4f} {dt * 1e3:.2f} ms/batch {NQ / dt:.0f} QPS")
    return recall, NQ / dt


def _split_batch(torch, label, cfg, state, reps_in, ef, max_iters, c, rerank):
    """Phase 5's timers on quantized search batches: descent, level-0 loop
    and rerank, each behind a synchronised timer (mean over the timed
    batches)."""
    from tpuvec_torch.index import search

    spent, reps = {"rerank": 0.0}, len(reps_in) - 1
    originals = _timers(torch, search, ["descend_to_level1", "beam_search_level0"], spent)
    try:
        t = time.perf_counter()
        for qq, qqf in reps_in[1:]:
            _, ii = search.search_graph(cfg, state, qq, k=c, ef=ef, max_iters=max_iters)
            torch.cuda.synchronize()
            t_r = time.perf_counter()
            rerank(ii, qqf)
            torch.cuda.synchronize()
            spent["rerank"] += time.perf_counter() - t_r
        total = (time.perf_counter() - t) / reps
    finally:
        _restore(search, originals)
    _log(f"trace: {label}: {total * 1e3:.2f} ms a batch with timers = descent "
         f"{spent['descend_to_level1'] / reps * 1e3:.2f} ms + level-0 loop "
         f"{spent['beam_search_level0'] / reps * 1e3:.2f} ms + rerank "
         f"{spent['rerank'] / reps * 1e3:.2f} ms (mean of {reps})")


def run_quantized(torch, device, n):
    """Phase 6: BASELINE configs 3 (INT8 + f32 rerank) and 4 (BINARY +
    int8-shadow rerank and expansion) at n x 1024: build, exact f32 oracle,
    sweep, the int8 / word loop forms' launches, and one batch split.
    Returns per form the graph and queries phase 3c runs on, and the form's
    launches."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.build import build_graph
    from tpuvec_torch.index.graph import config_for, prepare_vectors
    from tpuvec_torch.index.params import HnswParams
    from tpuvec_torch.index.search import search_graph
    from tpuvec_torch.ops.beam import beam_loop, beam_update
    from tpuvec_torch.ops.rerank import expand_rerank_topk, rerank_topk
    from tpuvec_torch.types import DistanceMetric, IndexQuantization

    _log(f"quantized: {n} rows x {QD} per config, cut from the sources' 1M "
         f"(config 4's source runs 10M); --n 1000000 runs 1M")
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128)
    cos = DistanceMetric.COSINE
    out = {}
    for name, quant, form in (("config 3", IndexQuantization.INT8, "int8"),
                              ("config 4", IndexQuantization.BINARY, "words")):
        t0 = time.time()
        x, qpool = (_config3_data if quant is IndexQuantization.INT8 else _config4_data)(n)
        cfg = config_for(QD, metric=cos, quantization=quant, params=params, cap=n)
        xp = prepare_vectors(cfg, x, device=device)
        xf = torch.from_numpy(x).to(device)
        if quant is IndexQuantization.INT8:
            shadow = xf  # f32 originals
        else:  # int8, per-row max-abs scale (scripts/probe_10m_binary.py:_quant_int8)
            scale = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-30)
            shadow = torch.round(xf / scale * 127).to(torch.int8)
        reps_in = [
            (prepare_vectors(cfg, qpool[i * NQ : (i + 1) * NQ], device=device),
             torch.from_numpy(qpool[i * NQ : (i + 1) * NQ]).to(device))
            for i in range(REPS + 1)
        ]
        valid = torch.ones(n, dtype=torch.bool, device=device)
        gt = bruteforce_knn(reps_in[0][1], xf, valid, metric=cos, k=K)[1].cpu().numpy()
        torch.cuda.synchronize()
        _log(f"quantized: {name} ({quant.value}): data, {cfg.store_dtype} rows of "
             f"{cfg.padded_dim}, shadow {shadow.dtype} and exact f32 oracle ready in "
             f"{time.time() - t0:.1f}s")

        _reset_launches()
        t0 = time.time()
        state = build_graph(cfg, xp, max_batch=1024, device=device)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        build_launches = dict(beam_loop.form_launches)
        if int(state.count) != n:
            raise AssertionError(f"{name}: graph holds {int(state.count)} of {n} vectors")
        _log(f"quantized: {name}: build {n} vectors in {build_s:.2f}s = {n / build_s:.0f} vec/s, "
             f"loop kernel launches {build_launches}")

        def coarse(ef, mi):
            return lambda qq, qqf: search_graph(cfg, state, qq, k=K, ef=ef, max_iters=mi)

        def reranked(ef, mi, c):
            def fn(qq, qqf):
                _, ii = search_graph(cfg, state, qq, k=c, ef=ef, max_iters=mi)
                return rerank_topk(shadow, ii, ii >= 0, qqf, metric=cos, k=K)
            return fn

        live = torch.arange(cfg.cap, device=device) < n

        def expanded(ef, mi, c):
            def fn(qq, qqf):
                _, ii = search_graph(cfg, state, qq, k=c, ef=ef, max_iters=mi)
                return expand_rerank_topk(shadow, state.adj0, ii, ii >= 0, qqf, metric=cos, k=K,
                                          filter_mask=live)
            return fn

        kind = "int8" if form == "int8" else "Hamming"
        rr = "f32" if form == "int8" else "int8"
        if form == "int8":
            points = [(f"coarse {kind} ef={ef} iters={mi}", coarse(ef, mi)) for ef, mi in ((48, 56), (64, 64))]
        else:
            points = [(f"coarse {kind} ef={ef} iters={mi}", coarse(ef, mi)) for ef, mi in ((64, 64), (128, None))]
        points += [(f"{kind} + {rr} rerank ef={ef} iters={mi} C={c}", reranked(ef, mi, c))
                   for ef, mi, c in ((64, 64, 48), (128, None, 96))]
        if form == "words":
            points += [(f"{kind} + 1-hop expand + {rr} rerank ef=64 iters=64 C={c}", expanded(64, 64, c))
                       for c in (24, 48)]
        sweep = [(label, *_sweep_point(torch, f"{name}: {label}", fn, reps_in, gt, n))
                 for label, fn in points]
        launches = dict(beam_loop.form_launches)
        search_launches = {f: launches[f] - build_launches[f] for f in launches}
        if build_launches[form] == 0 or search_launches[form] == 0:
            raise AssertionError(
                f"{name}: loop kernel's {form} form launches: build {build_launches}, "
                f"search {search_launches}"
            )
        if beam_update.launches or beam_loop.launches != launches[form]:
            raise AssertionError(f"{name}: other kernels launched: {launches}, "
                                 f"beam_update {beam_update.launches}")
        _log(f"quantized: {name}: loop kernel launches: build {build_launches}, search {search_launches}")

        if form == "int8":
            _split_batch(torch, f"{name} search + f32 rerank, ef=64 C=48", cfg, state, reps_in, 64, 64, 48,
                         lambda ii, qqf: rerank_topk(shadow, ii, ii >= 0, qqf, metric=cos, k=K))
        else:
            _split_batch(torch, f"{name} search + expand + int8 rerank, ef=64 C=48", cfg, state, reps_in,
                         64, 64, 48,
                         lambda ii, qqf: expand_rerank_topk(shadow, state.adj0, ii, ii >= 0, qqf,
                                                            metric=cos, k=K, filter_mask=live))
        out[form] = dict(name=name, cfg=cfg, state=state, qpool=qpool, launches=launches[form],
                         build_s=build_s, sweep=sweep, xf=xf, shadow=shadow, reps_in=reps_in, n=n)
        del x, xp, valid
        torch.cuda.empty_cache()
    return out


def check_quantized_loops(torch, device, qruns):
    """Phase 3c, on phase 6's graphs: the loop kernel's int8 and word forms
    against beam_loop_plain at the search and the construction shape.
    Integer forms must be exactly equal; raw cosine within 1e-6."""
    from tpuvec_torch.index.build import _build_iter_budget
    from tpuvec_torch.index.graph import prepare_vectors
    from tpuvec_torch.index.search import default_max_iters
    from tpuvec_torch.types import DistanceMetric

    shapes = {}
    for form, run in qruns.items():
        cfg, state, qpool = run["cfg"], run["state"], run["qpool"]
        qs = prepare_vectors(cfg, qpool[:NQ], device=device)
        qc = prepare_vectors(cfg, qpool[NQ : NQ + 1024], device=device)
        efc = max(cfg.ef_construction, cfg.max_m0)
        cases = [(qs, 64, 1, default_max_iters(64, 1)),
                 (qc, efc, 2, _build_iter_budget(cfg.cap, efc, 2))]
        if form == "int8":  # (label, metric, normalized, distance tolerance)
            metrics = [("sq-L2", cfg.graph_metric, cfg.normalized, 0.0),
                       ("L1", DistanceMetric.L1, False, 0.0),
                       ("cosine", DistanceMetric.COSINE, False, 1e-6)]
        else:
            metrics = [("Hamming", cfg.graph_metric, False, 0.0)]
        shapes[form] = [shape for metric in metrics
                        for shape in _hold_quantized(torch, form, cfg, state, metric, cases)]
    return shapes


def _hold_quantized(torch, form, cfg, state, metric, cases, one_by_one=0):
    """beam_loop against beam_loop_plain on one int8 or word graph under one
    (label, metric, normalized, tolerance), for each case (queries, ef, E,
    max_iters): at tolerance 0 exactly equal in ids, distances and
    iterations, else within it. With ``one_by_one`` the first that many
    queries run as batches of one (B=1), each launch held the same way, and
    the times are a launch of one. Returns each shape's numbers."""
    from tpuvec_torch.index.search import descend_to_level1, seed_beam
    from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain, node_dist

    mlabel, metric, normalized, tol = metric
    kw = dict(metric=metric, normalized=normalized)
    shapes = []
    for q, ef, e, max_iters in cases:
        argsets = []
        for qq in ([q[j : j + 1] for j in range(one_by_one)] if one_by_one else [q]):
            seed_i, _ = descend_to_level1(cfg, state, qq)
            seed_d = node_dist(metric, normalized, state.vectors, qq, seed_i[:, None])[:, 0]
            argsets.append((qq, state.vectors, state.adj0, *seed_beam(seed_i, seed_d, ef=ef, n_expand=e)))
        args = argsets[0]
        b, efp, w, dp = args[0].shape[0], args[3].shape[1], e * cfg.max_m0, q.shape[1]
        label = (f"{form} {mlabel} B={b} EF={efp} W={w} E={e} Dp={dp}"
                 + (f" ({one_by_one} queries, one a launch)" if one_by_one else ""))
        kd, ki, k_its = _each(torch, beam_loop, argsets, **kw, max_iters=max_iters)
        fresh, adj, (pd, pi, p_it) = _loop_visits(torch, args, dict(kw, max_iters=max_iters))
        p_its = [p_it]
        if one_by_one:  # the bound counts the first launch's rows; the hold, every launch's
            pd, pi, p_its = _each(torch, beam_loop_plain, argsets, **kw, max_iters=max_iters)
        k_it, p_it = max(k_its), max(p_its)
        if tol == 0.0:
            if not (torch.equal(kd, pd) and torch.equal(ki, pi) and k_its == p_its):
                raise AssertionError(
                    f"beam_loop {label}: not exactly equal to plain: ids differ in "
                    f"{int((ki != pi).sum())} slots, iterations {k_its} vs {p_its}"
                )
            err = 0.0
        else:
            err = _check_one_iteration(torch, label, kd, ki, pd, pi, tol=tol,
                                       when="over the full loop")
            if k_its != p_its:
                raise AssertionError(f"beam_loop {label}: iterations {k_its} vs plain {p_its}")
        ms, ms_source = _device_ms(lambda: beam_loop(*args, **kw, max_iters=max_iters),
                                   10, *_LOOP_KERNEL)
        plain_ms = _time_ms(lambda: beam_loop_plain(*args, **kw, max_iters=max_iters), 3, warm=1)
        iters_t = torch.empty((b,), dtype=torch.int32)
        bound_ms, bound_by, distinct, per_visit = _loop_bound(torch, args, fresh, adj,
                                                              (kd[:b], ki[:b], iters_t))
        plan = _loop_fields(torch, form, args, kw, max_iters, ms, k_its[0])
        shapes.append(dict(
            metric=mlabel, B=b, EF=efp, W=w, E=e, Dp=dp, max_iters=max_iters, iters=k_its[0],
            ms=ms, ms_source=ms_source, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            distinct_bytes=distinct, per_visit_bytes=per_visit, max_abs_err=err, **plan,
            **({"queries_held": one_by_one, "most_iters": k_it} if one_by_one else {}),
        ))
        same = "exactly equal to plain" if tol == 0.0 else f"within {tol:g} of plain (max err {err:.2e})"
        _log(
            f"kernels: beam_loop {label}: {same}, {k_it} iterations; device {ms:.4f} ms "
            f"per launch (bound {bound_ms:.5f} ms by {bound_by}: {distinct / 1e6:.2f} MB "
            f"distinct, {per_visit / 1e6:.2f} MB per visit); plain loop {plain_ms:.2f} ms; "
            f"{_fmt_plan(plan)}"
        )
    return shapes


def _filtered_point(torch, label, fn, reps_in, gt, mask, n):
    """Run ``fn(*rep)`` on the first rep (scored) and time it over the
    others; every returned id must pass ``mask``, slots past the ones found
    must be (inf, -1), found distances ascending. Returns (recall@10
    against ``gt``, QPS, share of the k slots filled)."""
    d0, i0 = fn(*reps_in[0])
    torch.cuda.synchronize()
    t0 = time.time()
    for ri in reps_in[1:]:
        fn(*ri)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / (len(reps_in) - 1)
    found = i0 >= 0
    if d0.shape != (NQ, K) or (i0 >= n).any() or not torch.equal(found, torch.isfinite(d0)):
        raise AssertionError(f"filtered: {label}: output malformed")
    if not bool(mask[i0[found].long()].all()):
        raise AssertionError(f"filtered: {label}: an id that fails the mask was returned")
    if bool((torch.diff(torch.where(found, d0, math.inf), dim=1) < 0).any()):
        raise AssertionError(f"filtered: {label}: distances not ascending")
    recall, fill = _recall(i0.cpu().numpy(), gt), float(found.float().mean())
    _log(f"filtered: {label}: recall@10={recall:.4f} (slots filled {fill:.4f}) "
         f"{dt * 1e3:.2f} ms/batch {NQ / dt:.0f} QPS")
    return dict(label=label, recall=recall, qps=NQ / dt, fill=fill)


def _copy_state(torch, state):
    """A copy of ``state`` that delete_ids can edit: every tensor cloned
    but the vectors, which it does not write."""
    from tpuvec_torch.index.graph import GraphState

    return GraphState(**{f.name: getattr(state, f.name) if f.name == "vectors"
                         else getattr(state, f.name).clone() for f in dataclasses.fields(GraphState)})


def run_filtered(torch, device, run, qruns):
    """Phase 7: deletes and filters at the index layer (the module
    docstring). Returns the points, the masked forms' launches in this
    phase, and the masks phase 3d runs under."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn, bruteforce_knn_internal
    from tpuvec_torch.index.build import delete_ids
    from tpuvec_torch.index.search import search_graph
    from tpuvec_torch.ops.beam import beam_loop, beam_update
    from tpuvec_torch.ops.rerank import expand_rerank_topk, rerank_topk
    from tpuvec_torch.types import DistanceMetric

    cfg, state, n, xp = run["cfg"], run["state"], run["n"], run["xp"]
    reps_in = [(q,) for q in (run["qp"], *run["rep_qs"])]
    ids = torch.arange(cfg.cap, device=device)
    live = ids < n
    masks = {"50%": live & (ids % 2 == 0), "10%": live & (ids % 10 == 0),
             "1%": live & (ids % 100 == 0)}
    _log(f"filtered: masks over {n} rows: " + ", ".join(
        f"{name} {int(m.sum())} rows" for name, m in masks.items()))
    # ground truth first, so that the counts below hold only the path's launches
    gts = {name: bruteforce_knn(run["qp"], xp, m[:n], metric=cfg.graph_metric, k=K,
                                normalized=True)[1].cpu().numpy()
           for name, m in masks.items()}

    _reset_launches()
    points = []
    for name, mask in masks.items():
        for ef in (64, 256):
            pt = _filtered_point(
                torch, f"f32 {name} mask ef={ef}",
                lambda q, mask=mask, ef=ef: search_graph(cfg, state, q, k=K, ef=ef, filter_mask=mask),
                reps_in, gts[name], mask, n)
            points.append(pt)
            if name == "50%" and ef == 256 and pt["recall"] < 0.90:
                raise AssertionError(f"filtered recall@10 {pt['recall']:.4f} < 0.90 at 50%, ef=256")

    # the coded exact scan: 1000 tenants, one tenant a query, one query of none
    codes = torch.where(live, ids % 1000, -1).to(torch.int32)[:n]
    tenants = np.random.default_rng(7).choice(1000, NQ, replace=False)
    q_codes = torch.tensor([*tenants.tolist(), -2], dtype=torch.int32, device=device)
    valid = live[:n]
    kw = dict(metric=cfg.graph_metric, k=K, normalized=True)

    def coded(q):
        return bruteforce_knn_internal(torch.cat([q, q[:1]]), xp, valid, slot_codes=codes,
                                       q_codes=q_codes, **kw)

    d_c, i_c = coded(run["qp"])
    q_all = torch.cat([run["qp"], run["qp"][:1]])
    for b, c in enumerate(tenants.tolist()):
        d_r, i_r = bruteforce_knn_internal(q_all, xp, valid & (codes == c), **kw)
        if not (torch.equal(i_c[b], i_r[b]) and torch.equal(d_c[b], d_r[b])):
            raise AssertionError(f"coded scan: query {b} (tenant {c}) differs from its masked scan")
    per_tenant = torch.bincount(codes[codes >= 0].long(), minlength=1000)
    want = per_tenant[torch.from_numpy(tenants).to(device)].clamp_max(K)
    if bool((i_c[NQ] >= 0).any()) or not torch.equal((i_c[:NQ] >= 0).sum(1), want):
        raise AssertionError("coded scan: a query of code -2 found rows, or a tenant came back short")
    torch.cuda.synchronize()
    t0 = time.time()
    for (q,) in reps_in[1:]:
        coded(q)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / (len(reps_in) - 1)
    coded_pt = dict(label="coded exact scan, 1000 tenants", qps=(NQ + 1) / dt, ms=dt * 1e3)
    points.append(coded_pt)
    _log(f"filtered: coded exact scan ({NQ} tenants of 1000 + one of code -2) equals the masked "
         f"scan per tenant; {dt * 1e3:.2f} ms/batch {(NQ + 1) / dt:.0f} QPS")

    # deletes on a copy of the graph: every 10th id and the entry point
    g = _copy_state(torch, state)
    dels = torch.unique(torch.cat([torch.arange(0, n, 10, device=device, dtype=torch.int32),
                                   g.entry_point.view(1)]))
    delete_ids(cfg, g, torch.full((1,), -1, dtype=torch.int32, device=device))  # warm-up, no edit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    delete_ids(cfg, g, dels)
    torch.cuda.synchronize()
    del_ms = (time.perf_counter() - t0) * 1e3
    gone = torch.zeros(cfg.cap, dtype=torch.bool, device=device)
    gone[dels.long()] = True
    for adj in (g.adj0, g.upper_adj):
        if bool((gone[adj.clamp_min(0).long()] & (adj >= 0)).any()):
            raise AssertionError("delete: an edge still points at a deleted id")
    ep, lv = int(g.entry_point), g.levels
    if ep < 0 or bool(gone[ep]) or int(lv[ep]) != int(g.entry_level) or int(g.entry_level) != int(lv.max()):
        raise AssertionError(f"delete: entry point {ep} (level {int(g.entry_level)}) is not live at "
                             f"the highest live level {int(lv.max())}")
    if int(g.count) != n - dels.numel():
        raise AssertionError(f"delete: count {int(g.count)} != {n} - {dels.numel()}")
    _log(f"filtered: delete_ids of {dels.numel()} ids (every 10th and the entry point) in "
         f"{del_ms:.2f} ms; no edge points at them, the entry point {ep} is live at the highest "
         f"level {int(g.entry_level)}, count {int(g.count)}")
    alive = (lv >= 0)
    gt_live = bruteforce_knn(run["qp"], xp, alive[:n], **kw)[1].cpu().numpy()
    for ef in (48, 64):
        points.append(_filtered_point(
            torch, f"f32 after delete, unfiltered ef={ef}",
            lambda q, ef=ef: search_graph(cfg, g, q, k=K, ef=ef), reps_in, gt_live, alive, n))
    m_after = alive & (ids % 10 == 5)
    gt_after = bruteforce_knn(run["qp"], xp, m_after[:n], **kw)[1].cpu().numpy()
    points.append(_filtered_point(
        torch, "f32 after delete, 10% mask (id % 10 == 5) ef=64",
        lambda q: search_graph(cfg, g, q, k=K, ef=64, filter_mask=m_after),
        reps_in, gt_after, m_after, n))
    del g

    # the quantized graphs at the 10% mask, as VecTable runs them
    cos = DistanceMetric.COSINE
    qmasks = {}
    for form, qrun in qruns.items():
        qcfg, qstate, qn = qrun["cfg"], qrun["state"], qrun["n"]
        qids = torch.arange(qcfg.cap, device=device)
        qlive = qids < qn
        mask = qlive & (qids % 10 == 0)
        qmasks[form] = mask
        gt = bruteforce_knn(qrun["reps_in"][0][1], qrun["xf"], mask[:qn], metric=cos,
                            k=K)[1].cpu().numpy()
        shadow = qrun["shadow"]
        if form == "int8":
            def fn(qq, qqf, qcfg=qcfg, qstate=qstate, mask=mask, shadow=shadow):
                _, ii = search_graph(qcfg, qstate, qq, k=48, ef=64, max_iters=64, filter_mask=mask)
                ok = (ii >= 0) & mask[ii.clamp_min(0).long()]
                return rerank_topk(shadow, ii, ok, qqf, metric=cos, k=K)
            label = "config 3 int8 10% mask ef=64 C=48 + f32 rerank"
        else:
            def fn(qq, qqf, qcfg=qcfg, qstate=qstate, mask=mask, shadow=shadow, qlive=qlive):
                _, ii = search_graph(qcfg, qstate, qq, k=48, ef=64, max_iters=64, filter_mask=mask)
                ok = (ii >= 0) & mask[ii.clamp_min(0).long()]
                return expand_rerank_topk(shadow, qstate.adj0, ii, ok, qqf, metric=cos, k=K,
                                          filter_mask=qlive & mask)
            label = "config 4 Hamming 10% mask ef=64 C=48 + 1-hop expand + int8 rerank"
        points.append(_filtered_point(torch, label, fn, qrun["reps_in"], gt, mask, qn))

    launches = dict(beam_loop.form_launches)
    for form in ("f32+mask", "int8+mask", "words+mask"):
        if launches[form] == 0:
            raise AssertionError(f"filtered: the loop kernel's {form} form never launched: {launches}")
    if beam_update.launches:
        raise AssertionError(f"filtered: beam_update launched {beam_update.launches} times")
    _log(f"filtered: loop kernel launches in this phase: {launches}")
    return dict(points=points, launches=launches, del_ms=del_ms, n_deleted=dels.numel(),
                masks={"f32": masks["10%"], **qmasks})


def check_masked_loops(torch, device, run, qruns, filt):
    """Phase 3d: the masked forms of the loop kernel against
    beam_loop_plain(node_mask=) under phase 7's 10% masks, at every shape
    phase 7 gives them: f32 on phase 4's graph at k=10 (KP=32) and ef 64
    and 256; int8 (config 3) and words (config 4) on phase 6's graphs at
    k=48 (KP=128), ef=64, max_iters=64."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.graph import prepare_vectors
    from tpuvec_torch.index.search import default_max_iters

    # form -> (config, state, queries, [(ef, k_out, max_iters), ...])
    graphs = {"f32": (run["cfg"], run["state"], run["qp"],
                      [(ef, K, default_max_iters(ef, 1)) for ef in (64, 256)])}
    for form, qrun in qruns.items():
        graphs[form] = (qrun["cfg"], qrun["state"],
                        prepare_vectors(qrun["cfg"], qrun["qpool"][:NQ], device=device),
                        [(64, 48, 64)])
    shapes = {}
    for form, (cfg, state, q, cases) in graphs.items():
        mask, gt = filt["masks"][form], None
        if form == "f32":
            gt = bruteforce_knn(q, run["xp"], mask[: run["n"]], metric=cfg.graph_metric, k=K,
                                normalized=True)[1].cpu().numpy()
        shapes[form] = _hold_masked(torch, form, cfg, state, q, mask, cases, gt)
    return shapes


def _hold_masked(torch, form, cfg, state, q, mask, cases, gt=None, one_by_one=0):
    """beam_loop(node_mask=) against beam_loop_plain(node_mask=) on one graph
    under one mask, for each case (ef, k_out, max_iters) at E=1: f32 (``gt``
    the exact masked top-10 ids) to phase 3b's tolerances, int8 and words
    exactly equal in ids, distances and iterations. With ``one_by_one`` the
    first that many queries run as batches of one (f32 only), as
    _hold_loop's. Returns each shape's numbers: device time, bound (the
    distinct rows plus the mask bytes they read), the plain loop's time."""
    from tpuvec_torch.ops.beam import beam_loop, beam_loop_plain

    kw = dict(metric=cfg.graph_metric, normalized=cfg.normalized, node_mask=mask)
    shapes = []
    for ef, k_out, max_iters in cases:
        e = 1
        argsets = _loop_argsets(cfg, state, q, ef, e, one_by_one, node_mask=mask, k_out=k_out)
        args = argsets[0]
        b, efp, kp, dp = args[0].shape[0], args[3].shape[1], args[8].shape[1], q.shape[1]
        nq = one_by_one or q.shape[0]
        label = (f"{form}+mask B={b} EF={efp} W={e * cfg.max_m0} E={e} KP={kp} Dp={dp}"
                 + (f" ({nq} queries, one a launch)" if one_by_one else ""))
        kd, ki, k_its = _each(torch, beam_loop, argsets, **kw, max_iters=max_iters)
        fresh, adj, (pd, pi, p_it) = _loop_visits(torch, args, dict(kw, max_iters=max_iters))
        p_its = [p_it]
        if one_by_one:  # the bound counts the first launch's rows; the hold, every launch's
            pd, pi, p_its = _each(torch, beam_loop_plain, argsets, **kw, max_iters=max_iters)
        k_it, p_it = max(k_its), max(p_its)
        extra = {}
        if form == "f32":
            one_k = _each(torch, beam_loop, argsets, **kw, max_iters=1)
            one_p = _each(torch, beam_loop_plain, argsets, **kw, max_iters=1)
            err = _check_one_iteration(torch, label, one_k[0], one_k[1], one_p[0], one_p[1])
            same = float((ki[:, :K] == pi[:, :K]).float().mean())
            r_k, r_p = _recall(ki[:, :K].cpu().numpy(), gt[:nq]), _recall(pi[:, :K].cpu().numpy(), gt[:nq])
            if same < 0.99 or abs(r_k - r_p) > 0.002:
                raise AssertionError(
                    f"beam_loop {label}: top-10 ids equal {same:.4f} (< 0.99?), recall@10 "
                    f"{r_k:.4f} vs plain {r_p:.4f} (more than 0.002 apart?)")
            extra = dict(top10_same=same, recall=r_k, plain_recall=r_p)
            agree = (f"1 iteration max err {err:.2e}; full loop top-10 ids equal {same:.4f}, "
                     f"recall@10 {r_k:.4f} vs plain {r_p:.4f}")
        else:
            if not (torch.equal(kd, pd) and torch.equal(ki, pi) and k_it == p_it):
                raise AssertionError(
                    f"beam_loop {label}: not exactly equal to plain: ids differ in "
                    f"{int((ki != pi).sum())} slots, iterations {k_it} vs {p_it}")
            err, agree = 0.0, "exactly equal to plain"
        if one_by_one:
            extra.update(queries_held=nq, most_iters=k_it)
        # the times, the bound and the plan are those of the first launch
        ms, ms_source = _device_ms(lambda: beam_loop(*args, **kw, max_iters=max_iters), 10,
                                   *_LOOP_KERNEL)
        plain_ms = _time_ms(lambda: beam_loop_plain(*args, **kw, max_iters=max_iters), 3, warm=1)
        iters_t = torch.empty((b,), dtype=torch.int32)
        bound_ms, bound_by, distinct, per_visit = _loop_bound(torch, args, fresh, adj,
                                                              (kd[:b], ki[:b], iters_t), masked=True)
        plan = _loop_fields(torch, form + "+mask", args, kw, max_iters, ms, k_its[0])
        shapes.append(dict(
            B=b, EF=efp, W=e * cfg.max_m0, E=e, KP=kp, Dp=dp, max_iters=max_iters, iters=k_its[0],
            plain_iters=p_its[0], ms=ms, ms_source=ms_source, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            distinct_bytes=distinct, per_visit_bytes=per_visit, max_abs_err=err, **extra, **plan,
        ))
        _log(f"kernels: beam_loop {label}: {agree}, {k_it} iterations (plain {p_it}); device "
             f"{ms:.4f} ms per launch (bound {bound_ms:.5f} ms by {bound_by}: "
             f"{distinct / 1e6:.2f} MB distinct, {per_visit / 1e6:.2f} MB per visit); plain "
             f"loop {plain_ms:.2f} ms; {_fmt_plan(plan)}")
    return shapes


def _result_arrays(results, k=K):
    """Table results as (rowids, distances) [B, k], (-1, +inf) past the
    rows found."""
    ids = np.full((len(results), k), -1, dtype=np.int64)
    dists = np.full((len(results), k), np.inf)
    for b, res in enumerate(results):
        for j, r in enumerate(res):
            ids[b, j], dists[b, j] = r.rowid, r.distance
    return ids, dists


def _same_results(torch, label, got, want, ref):
    """Two lists of table results agree as phase 3b's tolerance has it:
    the same rows found, distances within 1e-5, rowids equal wherever a
    slot's distance is more than 1e-5 from its neighbours'."""
    (gi, gd), (wi, wd) = _result_arrays(got), _result_arrays(want)
    _check_one_iteration(torch, f"(table) {label} vs {ref}", torch.from_numpy(gd),
                         torch.from_numpy(gi), torch.from_numpy(wd), torch.from_numpy(wi), when="")


def _timed(torch, fn, reps):
    """(result of the first call, ms per call over ``reps`` more)."""
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) / reps * 1e3


def _table_split(torch, fn):
    """One call of ``fn`` (a table read) with a synchronised timer around
    each layer under VecTable: the descent and the level-0 loop of the HNSW
    search, the exact scan, the rerank. Returns (total ms, {layer: ms}),
    the host's decode, prepare and collect as the remainder."""
    from tpuvec_torch.index import search
    from tpuvec_torch.store import table as table_mod

    spent = {}
    patched = [(search, _timers(torch, search, ["descend_to_level1", "beam_search_level0"], spent)),
               (table_mod, _timers(torch, table_mod, ["bruteforce_knn_internal", "rerank_topk",
                                                       "expand_rerank_topk"], spent))]
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        for module, originals in patched:
            _restore(module, originals)
    names = {"descend_to_level1": "descent", "beam_search_level0": "level-0 loop",
             "bruteforce_knn_internal": "exact scan", "rerank_topk": "rerank",
             "expand_rerank_topk": "expansion rerank"}
    parts = {names[name]: sec * 1e3 for name, sec in spent.items()}
    parts["host"] = total - sum(parts.values())
    return total, parts


def _fmt_split(parts):
    return ", ".join(f"{name} {ms:.2f}" for name, ms in parts.items())


def _timed_insert(torch, insert):
    """``insert()`` (an insert_many, or SQL statements that insert) with the
    insert stages' timers and a synchronised timer around the candidates
    stage's descent and level-0 loop. Returns (seconds, {part: seconds}),
    the host's decode, prepare and the flush's own work (and the statements'
    handling) as the remainder; "flush" is the time inside VecTable.flush."""
    from tpuvec_torch.index import build
    from tpuvec_torch.utils import timing

    spent = {}
    originals = _timers(torch, build, ["descend_to_level1", "beam_search_level0"], spent)
    timing.reset()
    timing.enable()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        insert()
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        timing.disable()
        _restore(build, originals)
    stats = timing.stats()
    parts = {name[len("insert."):]: stats[name][0] for name in
             ("insert.write", "insert.candidates", "insert.upper", "insert.connect")}
    parts["host"] = total - sum(parts.values())
    parts["flush"] = stats["table.flush"][0]
    parts["candidates: descent"] = spent["descend_to_level1"]
    parts["candidates: level-0 loop"] = spent["beam_search_level0"]
    return total, parts


def _even_rowid(rowid, values):
    """Phase 8a's 50% predicate."""
    return rowid % 2 == 0


@contextlib.contextmanager
def _loop_shapes_seen(torch):
    """Inside the block, the shape (form, EF, W, E, KP, Dp, B == 1) of every
    call the level-0 search makes of the loop kernel's wrapper, gathered
    into the set it yields (KP 0 when unmasked)."""
    from tpuvec_torch.index import search

    forms = {torch.float32: "f32", torch.int8: "int8", torch.int32: "words"}
    seen, wrapper = set(), search.beam_loop

    def recording(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d=None,
                  res_i=None, **kw):
        masked, e = kw.get("node_mask") is not None, cand.shape[1]
        seen.add((forms[vectors.dtype] + ("+mask" if masked else ""), beam_d.shape[1],
                  e * adj0.shape[1], e, res_d.shape[1] if masked else 0, q.shape[1], q.shape[0] == 1))
        return wrapper(q, vectors, adj0, beam_d, beam_i, beam_x, cand, active, res_d, res_i, **kw)

    search.beam_loop = recording
    try:
        yield seen
    finally:
        search.beam_loop = wrapper


def _check_held(phase, seen, shapes):
    """Every shape the phase launched (``seen``) is among the shapes held
    against the plain loop on its own graphs (``shapes``, form -> list): a
    launch of one query (B=1) held at B=1, a launch of more at B > 1."""
    held = {(form, s["EF"], s["W"], s["E"], s.get("KP", 0), s["Dp"], s["B"] == 1)
            for form, rows in shapes.items() for s in rows}
    missing = seen - held
    if missing:
        raise AssertionError(f"table: phase {phase} launched the loop kernel at shapes no check "
                             f"held against the plain loop: {sorted(missing)}")
    _log(f"table: phase {phase} launched the loop kernel at {sorted(seen)} (form, EF, W, E, KP, "
         "Dp, B == 1), each held against the plain loop on its graph")


def run_table_config5(torch, device):
    """Phase 8a: BASELINE config 5 through VecTable at its source's full
    size (the module docstring). Returns the table, the queries and the
    loop kernel's launches on the path, for the checks after it."""
    from tpuvec_torch.store import ColumnSpec, VecTable
    from tpuvec_torch.types import DistanceMetric
    from tpuvec_torch.utils.data import synthetic_embeddings

    n, d = C5_N, C5_D
    t0 = time.time()
    data = synthetic_embeddings(n + 64, d, seed=5)
    x, q = data[:n], data[n:]
    parts = np.random.default_rng(7).integers(0, C5_TENANTS, n)
    per_tenant = np.bincount(parts, minlength=C5_TENANTS)
    # 256 queries and 256 update rows more, on the corpus's manifold
    q256 = synthetic_embeddings(256, d, seed=6, structure_seed=5)
    upd = synthetic_embeddings(256, d, seed=8, structure_seed=5)
    rows = [{"e": x[i], "tenant": int(parts[i])} for i in range(n)]
    cols = [ColumnSpec.vector("e", d, metric=DistanceMetric.COSINE), ColumnSpec.partition_key("tenant")]
    t = VecTable("bench5", cols, initial_cap=n, device=device)
    _log(f"table: config 5: {n} x {d} cosine, {C5_TENANTS} tenants ({per_tenant.min()}-"
         f"{per_tenant.max()} rows each), default HnswParams(), initial_cap={n}; data made in "
         f"{time.time() - t0:.1f}s")

    # 1. insert
    _reset_launches()
    insert_s, split = _timed_insert(torch, lambda: t.insert_many(rows, rowids=list(range(n))))
    del rows  # while the row dicts live, every garbage collection below walks them
    gc.collect()
    flush_launches, _ = _launches()
    vc = t.vector_cols["e"]
    if len(t) != n or int(vc.state.count) != n or flush_launches["f32"] == 0:
        raise AssertionError(f"table: config 5 insert: {len(t)} rows, graph count "
                             f"{int(vc.state.count)}, loop launches {flush_launches}")
    _log(f"table: config 5: insert_many of {n} rows in {insert_s:.2f}s = {n / insert_s:.0f} vec/s "
         f"(stage timers on); cap {t.cap}, cap_u {vc.config.cap_u}; split (s): "
         + ", ".join(f"{name} {sec:.2f}" for name, sec in split.items())
         + f"; loop kernel launches {flush_launches}")

    # 2. single-tenant lookups (each a coded exact scan at ~256 rows a tenant)
    probes = [(q[i % 64], int(parts[i * 97 % n])) for i in range(64)]

    def singles():
        return [t.knn("e", qq, k=K, partition=p) for qq, p in probes]

    res, ms = _timed(torch, singles, 1)
    for (qq, p), r in zip(probes, res):
        if len(r) != min(K, per_tenant[p]) or any(parts[x.rowid] != p for x in r):
            raise AssertionError(f"table: single-tenant knn of tenant {p}: {len(r)} rows, "
                                 f"tenants {[int(parts[x.rowid]) for x in r]}")
    single_qps = 64 / (ms / 1e3)
    _log(f"table: config 5: 64 single-tenant knn(partition=) {ms / 64:.3f} ms each = "
         f"{single_qps:.0f} QPS, purity 1.0, each min(k, tenant rows) long")
    _log_busy(torch, "config 5 single-tenant knn", lambda: t.knn("e", q[0], k=K, partition=probes[0][1]))

    # 3. per-query partitions, B=64 x 4 reps (as the source draws them)
    rep_qs = [[q[j % 64] * (1.0 + 1e-4 * (r + 1)) for j in range(C5_B)] for r in range(C5_REPS)]
    rep_parts = [[int(parts[(j * 97 + r) % n]) for j in range(C5_B)] for r in range(C5_REPS)]
    batch = t.knn_many("e", rep_qs[0], k=K, partition=rep_parts[0])
    _same_results(torch, "per-query partitions B=64", batch,
                  [t.knn("e", qq, k=K, partition=p) for qq, p in zip(rep_qs[0], rep_parts[0])],
                  "the single-tenant calls")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for qs_r, ps_r in zip(rep_qs, rep_parts):
        outs = t.knn_many("e", qs_r, k=K, partition=ps_r)
        if any(parts[x.rowid] != p for res_j, p in zip(outs, ps_r) for x in res_j):
            raise AssertionError("table: per-query partitions returned a row of another tenant")
    torch.cuda.synchronize()
    batch_qps = C5_B * C5_REPS / (time.perf_counter() - t1)
    _, batch_split = _table_split(torch, lambda: t.knn_many("e", rep_qs[0], k=K, partition=rep_parts[0]))
    _log(f"table: config 5: per-query partitions B={C5_B} x {C5_REPS}: {batch_qps:.0f} QPS, purity "
         f"1.0, equal to the single-tenant calls; one batch split (ms): {_fmt_split(batch_split)}")

    # 4. unfiltered HNSW against the exact scan, 256 queries
    def recall_point(label, **kw):
        got, ms = _timed(torch, lambda: t.knn_many("e", q256, k=K, **kw), 3)
        exact = t.knn_many("e", q256, k=K, exact=True, **kw)
        ids, want = _result_arrays(got)[0], _result_arrays(exact)[0]
        recall = _recall(ids, want)
        _, sp = _table_split(torch, lambda: t.knn_many("e", q256, k=K, **kw))
        _log(f"table: config 5: {label}: recall@10 {recall:.4f} against the exact scan, "
             f"{ms:.2f} ms a batch of 256 = {256 / (ms / 1e3):.0f} QPS; split (ms): {_fmt_split(sp)}")
        return dict(label=label, recall=recall, qps=256 / (ms / 1e3), ms=ms), ids

    points = []
    pt, _ = recall_point("HNSW ef=200 (default), unfiltered")
    points.append(pt)
    _log_busy(torch, "config 5 knn_many of 256, HNSW", lambda: t.knn_many("e", q256, k=K))
    if pt["recall"] < 0.90:
        raise AssertionError(f"table: config 5 HNSW recall@10 {pt['recall']:.4f} < 0.90")

    # 5. a 50% predicate: in-beam filtered search (f32+mask)
    before, _ = _launches()
    pt, ids = recall_point("HNSW under a 50% predicate (rowid even)",
                           predicate=_even_rowid)
    points.append(pt)
    after, _ = _launches()
    if after["f32+mask"] == before["f32+mask"] or (ids[ids >= 0] % 2).any():
        raise AssertionError(f"table: predicate query: f32+mask launches {before} -> {after}, "
                             "or an odd rowid came back")

    # 6. delete every 10th rowid
    dels = list(range(0, n, 10))
    t1 = time.perf_counter()
    t.delete_many(dels)
    torch.cuda.synchronize()
    del_s = time.perf_counter() - t1
    problems = t.integrity_check()
    if problems:
        raise AssertionError(f"table: integrity_check after deletes: {problems}")
    pt, ids = recall_point(f"HNSW after delete_many of {len(dels)} rows")
    points.append(pt)
    if (ids[ids >= 0] % 10 == 0).any():
        raise AssertionError("table: a deleted rowid came back")
    _log(f"table: config 5: delete_many of {len(dels)} rowids in {del_s * 1e3:.1f} ms; "
         "integrity_check() == []; no deleted rowid returned")

    # 7. update 256 rows
    ups = [r for r in range(n) if r % 10][:256]
    t1 = time.perf_counter()
    t.update_many(ups, [{"e": v} for v in upd])
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t1
    if any(not np.array_equal(t.row(r)["e"].as_f32(), v) for r, v in zip(ups, upd)):
        raise AssertionError("table: row() does not return an updated vector")
    self_hits = np.mean([r[0].rowid == u for r, u in zip(t.knn_many("e", upd, k=1), ups)])
    _log(f"table: config 5: update_many of 256 rows in {upd_s * 1e3:.1f} ms; row() returns the new "
         f"vectors; HNSW top-1 is the updated row for {self_hits:.4f} of them")

    # 8. rebuild
    t1 = time.perf_counter()
    t.rebuild("e")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t1
    pt, _ = recall_point("HNSW after rebuild")
    points.append(pt)
    if pt["recall"] < 0.90 or t.integrity_check():
        raise AssertionError(f"table: after rebuild recall@10 {pt['recall']:.4f} < 0.90, or "
                             f"integrity_check {t.integrity_check()}")
    launches, bu = _launches()
    if launches["f32"] == flush_launches["f32"] or bu or any(
            launches[f] for f in launches if f not in ("f32", "f32+mask")):
        raise AssertionError(f"table: config 5 launches {launches}, beam_update {bu}")
    _log(f"table: config 5: rebuild of {len(t)} rows in {rebuild_s:.2f}s; loop kernel launches "
         f"in phase 8a: {launches} (the flush {flush_launches['f32']})")
    return dict(table=t, q256=q256, launches=launches, insert_s=insert_s, split=split, points=points,
                single_qps=single_qps, batch_qps=batch_qps, del_s=del_s, upd_s=upd_s,
                rebuild_s=rebuild_s, head=x[:C9_N].copy(), head_parts=parts[:C9_N].copy())


def check_table_loops(torch, device, c5):
    """Phase 8a step 9, on the table's graph after the path: beam_loop
    against beam_loop_plain at the shapes config 5's default HnswParams()
    give it: search (256 queries at ef_search=200: EF=256, E=1, W=64),
    construction (the same rows at ef_construction=400 with the build's
    iteration budget: EF=512, E=2, W=128; at B=256 and, as the first
    batches of an insert into an empty graph launch it, at B=1) and the
    predicate query's masked search under the table's own 50% mask (k=10:
    KP=32, EF=256, W=64), at phase 3b's tolerances. Returns the shapes by
    form."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.build import _build_iter_budget
    from tpuvec_torch.index.graph import prepare_vectors
    from tpuvec_torch.index.search import default_max_iters

    t = c5["table"]
    vc = t.vector_cols["e"]
    cfg, state = vc.config, vc.state
    qp = prepare_vectors(cfg, c5["q256"], device=device)
    live = torch.from_numpy(t._live[: t.cap].copy()).to(device)
    gt = bruteforce_knn(qp, state.vectors, live, metric=cfg.graph_metric, k=K,
                        normalized=True)[1].cpu().numpy()
    efc = max(cfg.ef_construction, cfg.max_m0)
    cases = [(qp, gt, cfg.ef_search, 1, default_max_iters(cfg.ef_search, 1)),
             (qp, gt, efc, 2, _build_iter_budget(cfg.cap, efc, 2))]
    even = torch.from_numpy(t._filter_mask(predicate=_even_rowid)).to(device)
    gt_even = bruteforce_knn(qp, state.vectors, even, metric=cfg.graph_metric, k=K,
                             normalized=True)[1].cpu().numpy()
    return {"f32": _hold_loop(torch, cfg, state, cases) + _hold_loop(torch, cfg, state, cases[1:],
                                                                      one_by_one=B1_QUERIES),
            "f32+mask": _hold_masked(torch, "f32", cfg, state, qp, even,
                                     [(cfg.ef_search, K, default_max_iters(cfg.ef_search, 1))],
                                     gt_even)}


def run_table_config4(torch, device, n):
    """Phase 8b: config 4 through VecTable (the module docstring). Returns
    the loop kernel's launches on the path and the points."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.params import HnswParams
    from tpuvec_torch.store import ColumnSpec, VecTable
    from tpuvec_torch.types import DistanceMetric, IndexQuantization

    cos = DistanceMetric.COSINE
    x, qpool = _config4_data(n)
    qs = qpool[:NQ]
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128)
    cols = [ColumnSpec.vector("e", QD, metric=cos, quantization=IndexQuantization.BINARY, params=params),
            ColumnSpec.metadata("bucket")]
    t = VecTable("config4", cols, initial_cap=n + 1, device=device)
    rows = [{"e": x[i], "bucket": i % 10} for i in range(n)]
    xf, qf = torch.from_numpy(x).to(device), torch.from_numpy(qs).to(device)
    bucket5 = torch.arange(n, device=device) % 10 == 5
    gts = {None: bruteforce_knn(qf, xf, torch.ones(n, dtype=torch.bool, device=device),
                                metric=cos, k=K)[1].cpu().numpy(),
           5: bruteforce_knn(qf, xf, bucket5, metric=cos, k=K)[1].cpu().numpy()}
    del xf

    _reset_launches()
    t0 = time.perf_counter()
    t.insert_many(rows, rowids=list(range(n)))
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    del rows
    gc.collect()
    build_launches, _ = _launches()
    vc = t.vector_cols["e"]
    if vc.shadow is None or tuple(vc.shadow.shape) != (vc.config.cap, QD) or vc.shadow.device.type != t.device.type:
        raise AssertionError("table: config 4 column holds no device shadow")
    _log(f"table: config 4: insert_many of {n} x {QD} BINARY rows in {insert_s:.2f}s = "
         f"{n / insert_s:.0f} vec/s; f32 shadow on the card ({vc.config.cap} x {QD}); loop kernel "
         f"launches {build_launches}")
    points = []
    for bucket in (None, 5):
        kw = {} if bucket is None else dict(filters={"bucket": bucket})
        label = "unfiltered" if bucket is None else "filters={'bucket': 5} (10%)"
        res, ms = _timed(torch, lambda: t.knn_many("e", qs, k=K, **kw), 3)
        ids = _result_arrays(res)[0]
        recall = _recall(ids, gts[bucket])
        _, sp = _table_split(torch, lambda: t.knn_many("e", qs, k=K, **kw))
        if "expansion rerank" not in sp:
            raise AssertionError(f"table: config 4 {label}: the device expansion rerank did not run")
        if recall < 0.90 or (bucket is not None and (ids[ids >= 0] % 10 != bucket).any()):
            raise AssertionError(f"table: config 4 {label}: recall@10 {recall:.4f} < 0.90, or a "
                                 "rowid outside the bucket")
        points.append(dict(label=label, recall=recall, qps=NQ / (ms / 1e3), ms=ms))
        if bucket is None:
            _log_busy(torch, "config 4 knn_many of 256", lambda: t.knn_many("e", qs, k=K))
        _log(f"table: config 4: knn_many {label}, coarse_k 100, expansion on: recall@10 "
             f"{recall:.4f} against the exact f32 scan, {ms:.2f} ms a batch of {NQ} = "
             f"{NQ / (ms / 1e3):.0f} QPS; split (ms): {_fmt_split(sp)}")
    launches, bu = _launches()
    if (build_launches["words"] == 0 or launches["words"] == build_launches["words"]
            or launches["words+mask"] == 0 or bu
            or any(launches[f] for f in launches if f not in ("words", "words+mask"))):
        raise AssertionError(f"table: config 4 launches {launches}, beam_update {bu}")
    _log(f"table: config 4: loop kernel launches in phase 8b: {launches}")
    return dict(table=t, qs=qs, qc=qpool[NQ : NQ + 1024], launches=launches, insert_s=insert_s,
                points=points)


def check_table4_loops(torch, device, c4t):
    """Phase 8b's holds, on the binary table's graph after the path: the
    words form against beam_loop_plain at the flush's construction shape
    (1024 held-out rows, EF=256, E=2, W=64; at B=1 too, as the first
    batches of the insert launch it) and the reads' search shape
    (k=100 at ef_search=128: EF=128, E=1, W=32), and the words+mask form
    under the table's own filters={"bucket": 5} mask at the filtered
    read's shape (k_out=100: KP=256, EF=128), each exactly equal. Returns
    the shapes by form."""
    from tpuvec_torch.index.build import _build_iter_budget
    from tpuvec_torch.index.graph import prepare_vectors
    from tpuvec_torch.index.search import default_max_iters

    t = c4t["table"]
    vc = t.vector_cols["e"]
    cfg, state = vc.config, vc.state
    qs, qc = (prepare_vectors(cfg, x, device=device) for x in (c4t["qs"], c4t["qc"]))
    coarse_k = max(10 * K, 96)  # VecTable._binary_rerank's default
    ef = max(cfg.ef_search, coarse_k)  # search_graph's
    efc = max(cfg.ef_construction, cfg.max_m0)
    bucket5 = torch.from_numpy(t._filter_mask(filters={"bucket": 5})).to(device)
    cases = [(qs, ef, 1, default_max_iters(ef, 1)), (qc, efc, 2, _build_iter_budget(cfg.cap, efc, 2))]
    hamming = ("Hamming", cfg.graph_metric, cfg.normalized, 0.0)
    return {"words": _hold_quantized(torch, "words", cfg, state, hamming, cases)
            + _hold_quantized(torch, "words", cfg, state, hamming, cases[1:], one_by_one=B1_QUERIES),
            "words+mask": _hold_masked(torch, "words", cfg, state, qs, bucket5,
                                       [(ef, coarse_k, default_max_iters(ef, 1))])}


def _sql_label(rowid):
    """Phase 10's label column: 'l' || (rowid % 10)."""
    return f"l{rowid % 10}"


def _statements(torch, db, sql, params_list, form=None):
    """Each statement alone after one warm-up, timed on the host clock (its
    rows fetched, so the device work is done). With ``form`` each must
    launch that form of the loop kernel. Returns (rows of each, ms of each)."""
    from tpuvec_torch.ops.beam import beam_loop

    rows, ms, none = [], [], 0
    db.execute(sql, list(params_list[0])).fetchall()  # warm-up
    torch.cuda.synchronize()
    for params in params_list:
        before = beam_loop.form_launches[form] if form else 0
        t = time.perf_counter()
        rows.append(db.execute(sql, list(params)).fetchall())
        ms.append((time.perf_counter() - t) * 1e3)
        none += bool(form) and beam_loop.form_launches[form] == before
    if none:
        raise AssertionError(f"sql: {none} of {len(params_list)} statements {sql[:48]!r}... launched "
                             f"no {form} loop kernel")
    return rows, ms


class _PathLaunches:
    """The loop kernel's launches that one path's own calls make: the
    counts are read into a running total before work beside the path (what
    it is held against) and set to 0 after it."""

    def __init__(self):
        _reset_launches()
        self.total, self.beam_update = {}, 0

    def read(self):
        """(the path's launches so far by form, beam_update's)."""
        launches, bu = _launches()
        return {f: self.total.get(f, 0) + c for f, c in launches.items()}, self.beam_update + bu

    @contextlib.contextmanager
    def aside(self):
        self.total, self.beam_update = self.read()
        try:
            yield
        finally:
            _reset_launches()


def _latency(ms):
    return dict(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                mean_ms=float(np.mean(ms)), statements_per_s=len(ms) / (sum(ms) / 1e3))


def _sql_ids(rows):
    """Statement rows (rowid, distance, ...) as [B, K] rowids, -1 past the rows found."""
    ids = np.full((len(rows), K), -1, dtype=np.int64)
    for b, r in enumerate(rows):
        ids[b, : len(r)] = [x[0] for x in r]
    return ids


def _same_as_table(label, rows, want):
    """Statement rows equal, bitwise, to VecTable results."""
    for j, (r, w) in enumerate(zip(rows, want)):
        if [(x[0], x[1]) for x in r] != [(x.rowid, x.distance) for x in w]:
            raise AssertionError(f"sql: {label}: statement {j} gives {r[:3]}..., VecTable.knn "
                                 f"{[(x.rowid, x.distance) for x in w][:3]}...")


def run_sql(torch, device, run):
    """Phase 10 (the module docstring): the vec0 SQL surface at --n x 768 on
    the card. Returns the {"sql": ...} figures, the loop kernel's launches
    that SQL statements made (not those of the VecTable calls they are
    held against) and what check_sql_loops holds."""
    from tpuvec_torch.sql import connect
    from tpuvec_torch.sql.ddl import parse_create_vtab
    from tpuvec_torch.store import VecTable

    n, data = run["n"], run["data"]
    x, q = data[:n], data[n : n + NQ]
    qb = [v.tobytes() for v in q]
    out = dict(rows=n, dims=D, ddl=SQL_DDL, queries=NQ)
    db = connect(device=device)
    db.execute(SQL_DDL)
    t = db.table("docs")
    _log(f"sql: {SQL_DDL} on connect(device={device!r}): {t.device}")

    # 1. load: BEGIN, executemany of every row, COMMIT
    params = [[i + 1, x[i].tobytes(), _sql_label(i + 1)] for i in range(n)]
    insert = "INSERT INTO docs(rowid, emb, label) VALUES (?, ?, ?)"
    sql_launches = _PathLaunches()

    def load():
        db.execute("BEGIN")
        db.executemany(insert, params)
        db.execute("COMMIT")

    sql_s, split = _timed_insert(torch, load)
    flush_launches, _ = sql_launches.read()
    del params
    if len(t) != n or int(t.vector_cols["emb"].state.count) != n or flush_launches["f32"] == 0:
        raise AssertionError(f"sql: load: {len(t)} rows, loop launches {flush_launches}")
    statements_s = sql_s - split["flush"]
    rows = [{"emb": x[i], "label": _sql_label(i + 1)} for i in range(n)]
    with sql_launches.aside():
        plain = VecTable("docs", parse_create_vtab(SQL_DDL)[1], device=device)
        table_s, table_split = _timed_insert(torch, lambda: plain.insert_many(rows, rowids=list(range(1, n + 1))))
    del rows, plain
    gc.collect()
    torch.cuda.empty_cache()
    out["insert"] = dict(sql_vec_s=n / sql_s, sql_s=sql_s, statements_s=statements_s, flush_s=split["flush"],
                         split_s=split, vectable_insert_many_vec_s=n / table_s, vectable_insert_many_s=table_s,
                         vectable_split_s=table_split)
    _log(f"sql: BEGIN; executemany of {n} INSERTs; COMMIT in {sql_s:.2f}s = {n / sql_s:.0f} vec/s: the "
         f"statements' handling {statements_s:.2f}s, the flush {split['flush']:.2f}s; split (s): "
         + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
         + f"; VecTable.insert_many of the same rows {table_s:.2f}s = {n / table_s:.0f} vec/s")

    # 2. KNN statements, one query each, at the default ef and at ef = ?
    knn = "SELECT rowid, distance FROM docs WHERE emb MATCH ? AND k = 10"
    with sql_launches.aside():
        gt = _result_arrays(t.knn_many("emb", list(q), k=K, exact=True))[0]
    out["knn"] = []
    before = None
    for ef in SQL_EFS:
        sql = knn + ("" if ef is None else " AND ef = ?")
        plist = [[b] + ([] if ef is None else [ef]) for b in qb]
        res, ms = _statements(torch, db, sql, plist, form="f32")
        with sql_launches.aside():
            want = [t.knn("emb", b, k=K, ef=ef) for b in qb]
        _same_as_table(f"ef={ef}", res, want)
        recall = _recall(_sql_ids(res), gt)
        sample = plist[:SQL_SPLIT_N]
        total, parts = _table_split(torch, lambda: [db.execute(sql, list(p)).fetchall() for p in sample])
        pt = dict(ef=ef or t.vector_cols["emb"].params.ef_search, recall=recall, **_latency(ms),
                  split_ms={k_: v / len(sample) for k_, v in parts.items()},
                  split_total_ms=total / len(sample), split_statements=len(sample))
        out["knn"].append(pt)
        _log(f"sql: {NQ} KNN statements at ef={pt['ef']}{' (default)' if ef is None else ''}: recall@10 "
             f"{recall:.4f} against knn_many(exact=True); p50 {pt['p50_ms']:.3f} ms, p99 "
             f"{pt['p99_ms']:.3f} ms, {pt['statements_per_s']:.0f} statements/s; bitwise equal to "
             f"VecTable.knn; a statement's split (ms, synchronised timers, over {len(sample)}): "
             + _fmt_split(pt["split_ms"]))
        if ef is None:
            before = res
            if recall < 0.95:
                raise AssertionError(f"sql: recall@10 {recall:.4f} < 0.95 at the default ef")

    # 3. under a metadata filter (10% of rows)
    filt = "SELECT rowid, distance FROM docs WHERE emb MATCH ? AND label = ? AND k = 10"
    plist = [[b, _sql_label(j)] for j, b in enumerate(qb)]
    res, ms = _statements(torch, db, filt, plist, form="f32+mask")
    gt_f = np.full((NQ, K), -1, dtype=np.int64)
    with sql_launches.aside():
        for lab in range(10):
            js = list(range(lab, NQ, 10))
            gt_f[js] = _result_arrays(t.knn_many("emb", [q[j] for j in js], k=K, exact=True,
                                                 filters={"label": _sql_label(lab)}))[0]
        want = [t.knn("emb", b, k=K, filters={"label": lab}) for b, lab in plist]
    ids = _sql_ids(res)
    if any(r >= 0 and r % 10 != j % 10 for j, row in enumerate(ids) for r in row):
        raise AssertionError("sql: a filtered statement returned a row of another label")
    _same_as_table("label filter", res, want)
    recall_f = _recall(ids, gt_f)
    out["filtered"] = dict(recall=recall_f, **_latency(ms))
    _log(f"sql: {NQ} KNN statements AND label = ? (10%): recall@10 {recall_f:.4f} against the exact "
         f"masked scan, every rowid carries its label, p50 {out['filtered']['p50_ms']:.3f} ms, p99 "
         f"{out['filtered']['p99_ms']:.3f} ms")
    if recall_f < 0.90:
        raise AssertionError(f"sql: filtered recall@10 {recall_f:.4f} < 0.90")

    # 4. composed statements: a KNN join, a CTE over a MATCH, a full-table aggregate
    db.execute("CREATE TABLE meta(id INTEGER PRIMARY KEY, title TEXT)")
    db.executemany("INSERT INTO meta VALUES (?, ?)", [[i, f"doc{i}"] for i in range(1, n + 1)])
    join = ("SELECT docs.rowid, docs.distance, m.title FROM docs JOIN meta m ON m.id = docs.rowid "
            "WHERE docs.emb MATCH ? AND k = 10 ORDER BY docs.distance")
    cte = ("WITH near AS (SELECT rowid AS r, distance FROM docs WHERE emb MATCH ? AND k = 10) "
           "SELECT r, distance FROM near ORDER BY distance")
    composed = {}
    for name, sql in (("knn join", join), ("cte over match", cte)):
        res, ms = _statements(torch, db, sql, [[b] for b in qb[:16]], form="f32")
        for j, r in enumerate(res):
            if [(a[0], a[1]) for a in r] != [(a[0], a[1]) for a in before[j]]:
                raise AssertionError(f"sql: {name}, query {j}: {r[:3]}... not the planner's "
                                     f"{before[j][:3]}...")
            if name == "knn join" and any(a[2] != f"doc{a[0]}" for a in r):
                raise AssertionError(f"sql: knn join, query {j}: a title of another row")
        composed[name] = _latency(ms)
    cut = min(n, SQL_MIRROR_N)
    db.execute(SQL_DDL.replace(" docs ", " docs_cut "))
    db.executemany("INSERT INTO docs_cut(rowid, emb, label) VALUES (?, ?, ?)",
                   [[i + 1, x[i].tobytes(), _sql_label(i + 1)] for i in range(cut)])
    group = "SELECT label, COUNT(*) FROM {} GROUP BY label ORDER BY label"
    t0 = time.perf_counter()
    counts = db.execute(group.format("docs_cut")).fetchall()
    cut_s = time.perf_counter() - t0
    want_counts = sorted((_sql_label(r), c) for r, c in
                         zip(*np.unique(np.arange(1, cut + 1) % 10, return_counts=True)))
    if counts != [(lab, int(c)) for lab, c in want_counts]:
        raise AssertionError(f"sql: {group.format('docs_cut')}: {counts}")
    predicted_s = cut_s / cut * n
    full = dict(statement=group.format("docs_cut"), rows=cut, s=cut_s, us_per_row=cut_s / cut * 1e6,
                predicted_s_at_n=predicted_s)
    if predicted_s <= 60.0:  # cheap enough: the full table as well
        t0 = time.perf_counter()
        counts = db.execute(group.format("docs")).fetchall()
        full.update(full_table_s=time.perf_counter() - t0, full_table_counts=counts)
    else:
        full["reduced"] = f"the first {cut} of {n} rows: {predicted_s:.0f} s predicted at {n} (> 60 s)"
    db.execute("DROP TABLE docs_cut")
    out["composed"] = dict(**composed, full_table=full)
    _log(f"sql: a KNN join with a plain SQLite table and a CTE over a MATCH give the planner's rowids "
         f"and distances (16 queries each; p50 {composed['knn join']['p50_ms']:.2f} / "
         f"{composed['cte over match']['p50_ms']:.2f} ms); {full['statement']} mirrors {cut} rows in "
         f"{cut_s:.2f}s ({full['us_per_row']:.0f} us a row, {predicted_s:.1f} s predicted at {n} rows"
         + (f"; the full table took {full['full_table_s']:.2f}s" if "full_table_s" in full else
            "; the full table not run") + ")")

    # 5. writes: deletes rolled back, deletes committed, updates, integrity, rebuild
    dels = list(range(10, n + 1, 10))
    delete = f"DELETE FROM docs WHERE rowid IN ({', '.join(map(str, dels))})"
    db.execute("BEGIN")
    t0 = time.perf_counter()
    db.execute(delete)
    torch.cuda.synchronize()
    txn_delete_s = time.perf_counter() - t0
    if len(t) != n - len(dels):
        raise AssertionError(f"sql: {len(t)} rows after the deletes in the transaction")
    t0 = time.perf_counter()
    db.execute("ROLLBACK")
    torch.cuda.synchronize()
    rollback_s = time.perf_counter() - t0
    after, _ = _statements(torch, db, knn, [[b] for b in qb], form="f32")
    differ = [j for j, (a, b) in enumerate(zip(after, before)) if a != b]
    if len(t) != n or differ:
        raise AssertionError(f"sql: after ROLLBACK {len(t)} rows (want {n}); {len(differ)} of {NQ} "
                             f"statements answer otherwise than before the transaction: {differ[:8]}")
    db.execute("BEGIN")
    db.execute(delete)
    t0 = time.perf_counter()
    db.execute("COMMIT")
    commit_s = time.perf_counter() - t0
    if len(t) != n - len(dels):
        raise AssertionError(f"sql: {len(t)} rows after the committed deletes")
    ups = [r for r in range(1, n + 1) if r % 10][:100]
    newv = data[n + NQ : n + NQ + len(ups)]
    f32_before = sql_launches.read()[0]["f32"]
    t0 = time.perf_counter()
    for r, v in zip(ups, newv):
        db.execute("UPDATE docs SET emb = ? WHERE rowid = ?", [v.tobytes(), r])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_launches = sql_launches.read()[0]["f32"] - f32_before
    for r, v in zip(ups, newv):
        got = np.asarray(json.loads(db.execute("SELECT emb FROM docs WHERE rowid = ?", [r]).fetchone()[0]),
                         dtype=np.float32)
        if not np.array_equal(got, v):
            raise AssertionError(f"sql: rowid {r} does not read back its updated vector")
    problems = db.integrity_check("docs")
    if problems:
        raise AssertionError(f"sql: integrity_check: {problems}")
    vc = t.vector_cols["emb"]
    graph = dict(cfg=vc.config, state=vc.state,
                 mask=torch.from_numpy(t._filter_mask(filters={"label": _sql_label(3)})).to(device))
    f32_before = sql_launches.read()[0]["f32"]
    t0 = time.perf_counter()
    ok = db.execute("SELECT vec_rebuild_hnsw('docs', 'emb', 16, 200)").fetchall()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    rebuild_launches = sql_launches.read()[0]["f32"] - f32_before
    with sql_launches.aside():
        gt2 = _result_arrays(t.knn_many("emb", list(q), k=K, exact=True))[0]
    res, ms = _statements(torch, db, knn, [[b] for b in qb], form="f32")
    recall2 = _recall(_sql_ids(res), gt2)
    if ok != [("ok",)] or recall2 < 0.95 or db.integrity_check("docs"):
        raise AssertionError(f"sql: vec_rebuild_hnsw {ok}: recall@10 {recall2:.4f} (< 0.95?), "
                             f"integrity_check {db.integrity_check('docs')}")
    out["writes"] = dict(txn_delete_rows=len(dels), txn_delete_s=txn_delete_s, rollback_s=rollback_s,
                         rollback_restored=True, answers_equal_after_rollback=True, commit_s=commit_s,
                         updates=len(ups), update_s=update_s, integrity_check=[], rebuild_s=rebuild_s,
                         recall_after_rebuild=recall2, after_rebuild=_latency(ms))
    launches, bu = sql_launches.read()
    if (update_launches < len(ups) or rebuild_launches == 0 or bu
            or any(launches[f] for f in launches if f not in ("f32", "f32+mask"))):
        raise AssertionError(f"sql: loop kernel launches {launches} ({update_launches} in the "
                             f"{len(ups)} UPDATEs, {rebuild_launches} in the rebuild), beam_update {bu}")
    out["launches"] = launches
    _log(f"sql: DELETE of {len(dels)} rowids in a transaction {txn_delete_s:.2f}s, ROLLBACK "
         f"{rollback_s:.2f}s: the count came back and the {NQ} statements answer as before; again "
         f"committed ({commit_s:.2f}s); {len(ups)} UPDATEs by rowid in {update_s:.2f}s, each reads "
         f"back; integrity_check() == []; vec_rebuild_hnsw('docs', 'emb', 16, 200) in {rebuild_s:.2f}s, "
         f"then recall@10 {recall2:.4f}; every KNN statement launched the loop kernel; its launches "
         f"by SQL statements in phase 10: {launches} (the load's flush {flush_launches['f32']}, the "
         f"UPDATEs' {update_launches}, the rebuild's {rebuild_launches})")
    return dict(sql=out, launches=launches, db=db, q=q, graph=graph)


def check_sql_loops(torch, device, sq):
    """Phase 10's holds: every loop-kernel shape the SQL path launched,
    against beam_loop_plain to phase 3b's tolerances, on the SQL table's
    graph before vec_rebuild_hnsw (M=32, ef_construction=400) and after it
    (M=16, ef_construction=200): the statements' B=1 search shapes at every
    ef phase 10 ran (EF 16 / 32 / 64 / 256, W=64), f32+mask at B=1 under
    the label = 'l3' mask (KP=32, EF=256), the flush's construction shape
    (EF=512, E=2, W=128) at B=1 and at B=256, and, after the rebuild, its
    search shape (EF=256, W=32) at B=1 and its construction shape (EF=256,
    E=2, W=64) at B=1 and B=256. B=1 runs B1_QUERIES queries, one a launch.
    Returns the shapes by form."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn
    from tpuvec_torch.index.build import _build_iter_budget
    from tpuvec_torch.index.graph import prepare_vectors
    from tpuvec_torch.index.search import default_max_iters

    t = sq["db"].table("docs")
    out = {"f32": [], "f32+mask": []}
    vc = t.vector_cols["emb"]
    for when, cfg, state, mask in (("before vec_rebuild_hnsw", sq["graph"]["cfg"], sq["graph"]["state"],
                                    sq["graph"]["mask"]),
                                   ("after vec_rebuild_hnsw", vc.config, vc.state, None)):
        qp = prepare_vectors(cfg, sq["q"], device=device)
        valid = state.levels >= 0
        gt = bruteforce_knn(qp, state.vectors, valid, metric=cfg.graph_metric, k=K,
                            normalized=True)[1].cpu().numpy()
        efc = max(cfg.ef_construction, cfg.max_m0)
        build = (qp, gt, efc, 2, _build_iter_budget(cfg.cap, efc, 2))
        efs = [cfg.ef_search] + ([ef for ef in SQL_EFS if ef] if mask is not None else [])
        search = [(qp, gt, max(ef, K), 1, default_max_iters(max(ef, K), 1)) for ef in efs]
        _log(f"kernels: phase 10's shapes on the SQL table's graph {when}")
        out["f32"] += _hold_loop(torch, cfg, state, search + [build], one_by_one=B1_QUERIES)
        out["f32"] += _hold_loop(torch, cfg, state, [build])
        if mask is not None:
            gt_m = bruteforce_knn(qp, state.vectors, mask & valid, metric=cfg.graph_metric, k=K,
                                  normalized=True)[1].cpu().numpy()
            out["f32+mask"] += _hold_masked(torch, "f32", cfg, state, qp, mask,
                                            [(cfg.ef_search, K, default_max_iters(cfg.ef_search, 1))],
                                            gt_m, one_by_one=B1_QUERIES)
    return out


# Phase 9b / 9c's reader: a second OS process that imports only the port,
# follows the snapshot on the card and answers the 256 queries.
#   argv: repo root, snapshot path, queries (.npy), output prefix, k[, --wait]
# With --wait it prints its first report, then waits for a line on stdin,
# refreshes and answers again. Its last line is a JSON report.
_FOLLOWER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from tpuvec_torch.store import SnapshotFollower

path, qpath, out, k = sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5])
q = np.load(qpath)


def answer(follower, tag):
    res = follower.table.knn_many("e", q, k=k)
    ids = np.full((len(res), k), -1, dtype=np.int64)
    dists = np.full((len(res), k), np.inf)
    for b, rr in enumerate(res):
        for j, r in enumerate(rr):
            ids[b, j], dists[b, j] = r.rowid, r.distance
    np.save(f"{out}_{tag}_ids.npy", ids)
    np.save(f"{out}_{tag}_dists.npy", dists)


t = time.perf_counter()
f = SnapshotFollower(path, device="cuda")
torch.cuda.synchronize()
report = {"load_s": time.perf_counter() - t, "rows": len(f), "refreshed_unchanged": f.refresh()}
answer(f, "first")
report["first_answer_at"] = time.time()
if "--wait" in sys.argv:
    print(json.dumps(report), flush=True)
    sys.stdin.readline()
    t = time.perf_counter()
    report = {"refreshed": f.refresh()}
    torch.cuda.synchronize()
    report.update(refresh_s=time.perf_counter() - t, rows=len(f))
    answer(f, "after")
report["device"] = str(f.table.device)
report["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tpuvec"))
print(json.dumps(report), flush=True)
"""


def _snapshot_routes():
    """Phase 9's knn_many routes on a config 5 table, 256 queries: HNSW,
    the exact scan, one tenant a query (the coded exact scan) and the 50%
    predicate (f32+mask)."""
    return {"HNSW": {}, "exact": dict(exact=True),
            "per-query tenants": dict(partition=[j % C5_TENANTS for j in range(NQ)]),
            "50% predicate": dict(predicate=_even_rowid)}


def _answers(torch, table, q, routes):
    """(rowids, distances) [256, K] of knn_many on each route."""
    out = {name: _result_arrays(table.knn_many("e", q, k=K, **kw)) for name, kw in routes.items()}
    torch.cuda.synchronize()
    return out


def _same_answers(label, got, want):
    """Each route's rowids identical and distances bitwise equal. Where a
    route is not, the distances must still be equal and the rowids equal
    as a set per distinct distance (the kernel not deterministic from run
    to run: a finding, logged). Returns {route: bitwise equal}."""
    bitwise = {}
    for name, (wi, wd) in want.items():
        gi, gd = got[name]
        bitwise[name] = bool(np.array_equal(gi, wi) and np.array_equal(gd, wd))
        if bitwise[name]:
            continue
        if not np.array_equal(gd, wd):
            raise AssertionError(f"snapshot: {label}: {name}: distances differ in "
                                 f"{int((gd != wd).sum())} places")
        for row in range(wd.shape[0]):
            for v in np.unique(wd[row]):
                if set(gi[row][gd[row] == v]) != set(wi[row][wd[row] == v]):
                    raise AssertionError(f"snapshot: {label}: {name}: query {row} returns other "
                                         f"rowids at distance {v}")
        _log(f"snapshot: {label}: {name}: rowids equal only as a set per distinct distance "
             f"({int((gi != wi).sum())} places in another order): not deterministic run to run")
    return bitwise


def _decoded_scalars(table, cap):
    """Each scalar column's value at every slot below ``cap`` (None where
    NULL): a load interns the values again in the file's order, so codes
    may be numbered otherwise than the live table's."""
    return {name: np.array(sc.values + [None], dtype=object)[sc.codes[:cap]]
            for name, sc in table._scalars.items()}


def _hold_loaded(torch, label, got, want):
    """A loaded table equals the table it was saved from: host state
    (rowid map, next slot, free slots, max rowid, live slots), each slot's
    scalar values, the raw originals, every graph field, and
    integrity_check() == []."""
    problems = [name for name in ("_rowid_to_slot", "_slot_to_rowid", "_next_slot", "_free_slots",
                                  "_max_rowid") if getattr(got, name) != getattr(want, name)]
    cap = want.cap
    if got.cap != cap or not np.array_equal(got._live[:cap], want._live[:cap]):
        problems.append("_live")
    mine, theirs = _decoded_scalars(got, cap), _decoded_scalars(want, cap)
    problems += [f"scalars {name}" for name in theirs if not np.array_equal(mine[name], theirs[name])]
    for cname, vc in want.vector_cols.items():
        gvc = got.vector_cols[cname]
        if gvc.config != vc.config:
            problems.append(f"config of {cname}")
        if gvc.raw.dtype != vc.raw.dtype or not np.array_equal(gvc.raw, vc.raw):
            problems.append(f"raw::{cname}")
        for f in dataclasses.fields(vc.state):
            a, b = getattr(gvc.state, f.name), getattr(vc.state, f.name)
            if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
                problems.append(f"graph::{cname}::{f.name}")
    integrity = got.integrity_check()
    if problems or integrity:
        raise AssertionError(f"snapshot: {label}: the loaded table differs in {problems}; "
                             f"integrity_check {integrity}")


def _follower(tmp, path, q, tag, wait=False):
    """Start phase 9's reader process on ``path`` (the module's
    _FOLLOWER). Returns (process, output prefix, spawn time)."""
    qpath = os.path.join(tmp, f"{tag}_queries.npy")
    np.save(qpath, q)
    out = os.path.join(tmp, tag)
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-c", _FOLLOWER, repo, path, qpath, out, str(K)] + (["--wait"] if wait else [])
    spawned = time.time()
    proc = subprocess.Popen(cmd, cwd=tmp, text=True, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    return proc, out, spawned


def _follower_report(label, proc, out, tag, want, timeout=600):
    """Wait for the reader, check its report (no module of JAX or of the
    JAX package loaded, on the card) and that its answers ``tag`` equal
    ``want`` (rowids, distances) bitwise."""
    stdout, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"snapshot: {label}: reader process exit {proc.returncode}:\n{stderr[-4000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    if report["foreign_modules"] or not report["device"].startswith("cuda"):
        raise AssertionError(f"snapshot: {label}: reader report {report}")
    ids, dists = np.load(f"{out}_{tag}_ids.npy"), np.load(f"{out}_{tag}_dists.npy")
    if not (np.array_equal(ids, want[0]) and np.array_equal(dists, want[1])):
        raise AssertionError(f"snapshot: {label}: the reader's answers differ from the writer's in "
                             f"{int((ids != want[0]).sum())} rowids, {int((dists != want[1]).sum())} "
                             "distances")
    return report


def _first_line(label, proc, timeout=600):
    """The reader's first JSON line (it then waits for its cue)."""
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        _, stderr = proc.communicate()
        raise AssertionError(f"snapshot: {label}: reader process gave no first report:\n{stderr[-4000:]}")
    return json.loads(line)


def _past_2gib(native, tmp):
    """A tvstore file past 2^31 bytes through the port's bindings (config
    5's file stays under it): a uint64 section of 2^31 + 2^20 bytes, then
    a small one whose offset is past 2^31; both must read back equal.
    Returns its figures."""
    big = np.arange((2**31 + 2**20) // 8, dtype=np.uint64)
    tail = np.arange(7, dtype=np.int32)
    path = os.path.join(tmp, "big.tvs")
    t0 = time.perf_counter()
    w = native.TvsWriter(path)
    w.add("big", big)
    w.add("tail", tail)
    w.finish()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = native.TvsReader(path)
    try:
        out = r.read_all()
    finally:
        r.close()
    read_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    os.unlink(path)
    if not (out["big"].dtype == big.dtype and np.array_equal(out["big"], big)
            and np.array_equal(out["tail"], tail)):
        raise AssertionError("snapshot: a tvstore file past 2^31 bytes did not read back equal")
    return dict(bytes=nbytes, write_s=write_s, read_s=read_s, equal=True)


def run_snapshots(torch, device, c5, tmp):
    """Phase 9 (the module docstring): config 5's table saved through
    tvstore, reloaded on the card and followed from a second process (9a,
    9b); npz, autosave and a follower's refresh at C9_N rows (9c). Returns
    the {"snapshot": ...} figures and the loop kernel's launches."""
    from tpuvec_torch import native
    from tpuvec_torch.store import ColumnSpec, VecTable, snapshot, writer_lock
    from tpuvec_torch.types import DistanceMetric, InvalidState

    t, q = c5["table"], c5["q256"]
    routes = _snapshot_routes()
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("snapshot: the tvstore library did not build (g++, csrc/tvstore.cpp)")
    _log(f"snapshot: tvstore library {native._target().name} built or found in "
         f"{time.perf_counter() - t0:.2f}s")

    # 9a. save, load and hold, at full size
    path = os.path.join(tmp, "config5.tvs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snapshot.save(t, path, engine="native")
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    want = _answers(torch, t, q, routes)
    _reset_launches()
    t0 = time.perf_counter()
    loaded = snapshot.load(path, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _hold_loaded(torch, "config 5, tvstore", loaded, t)
    got = _answers(torch, loaded, q, routes)
    launches, bu = _launches()
    bitwise = _same_answers("config 5, tvstore", got, want)
    # where the load's time goes: the file read with and without the
    # engine's CRC check (the file is in the page cache)
    t0 = time.perf_counter()
    r = native.TvsReader(path, verify=False)
    try:
        r.read_all()
    finally:
        r.close()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snapshot._open_archive(path)
    read_crc_s = time.perf_counter() - t0
    if (launches["f32"] == 0 or launches["f32+mask"] == 0 or bu
            or any(launches[f] for f in launches if f not in ("f32", "f32+mask"))):
        raise AssertionError(f"snapshot: the reloaded table's launches {launches}, beam_update {bu}")
    a = dict(rows=len(loaded), cap=loaded.cap, bytes=nbytes, save_s=save_s, save_gb_s=nbytes / save_s / 1e9,
             load_s=load_s, load_gb_s=nbytes / load_s / 1e9, read_s=read_s, read_crc_s=read_crc_s,
             routes_bitwise_equal=bitwise, launches=launches)
    _log(f"snapshot: 9a: config 5 ({len(t)} rows, cap {t.cap}) saved through tvstore: {nbytes} bytes "
         f"in {save_s:.2f}s = {a['save_gb_s']:.3f} GB/s; loaded on the card in {load_s:.2f}s = "
         f"{a['load_gb_s']:.3f} GB/s (the file's read alone {read_s:.2f}s, with the CRC check "
         f"{read_crc_s:.2f}s); host state, scalars, raw and every graph field equal, "
         f"integrity_check() == []; knn_many of {NQ} on {list(routes)}: bitwise equal {bitwise}; "
         f"loop kernel launches {launches}")
    del loaded, got
    gc.collect()
    torch.cuda.empty_cache()

    # 9b. a reader in a second OS process
    proc, out, spawned = _follower(tmp, path, q, "9b")
    try:
        rep = _follower_report("9b", proc, out, "first", want["HNSW"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if rep["rows"] != len(t) or rep["refreshed_unchanged"]:
        raise AssertionError(f"snapshot: 9b: reader report {rep}")
    b = dict(start_to_first_answer_s=rep["first_answer_at"] - spawned, load_s=rep["load_s"],
             rows=rep["rows"], answers_equal=True)
    _log(f"snapshot: 9b: a second process (tpuvec_torch only) followed the file on the card: load "
         f"{rep['load_s']:.2f}s, start to first answer {b['start_to_first_answer_s']:.2f}s; its "
         f"{NQ} HNSW answers equal the writer's bitwise")
    os.unlink(path)
    big = _past_2gib(native, tmp)
    a["past_2gib"] = big
    _log(f"snapshot: 9a: a tvstore file of {big['bytes']} bytes (past 2^31) written in "
         f"{big['write_s']:.2f}s and read in {big['read_s']:.2f}s through the port's bindings: equal")

    # 9c. npz, autosave and a follower's refresh, at C9_N rows
    x, parts = c5["head"], c5["head_parts"]
    rows = [{"e": x[i], "tenant": int(parts[i])} for i in range(C9_N)]
    cols = [ColumnSpec.vector("e", C5_D, metric=DistanceMetric.COSINE), ColumnSpec.partition_key("tenant")]
    _reset_launches()

    def timed_insert(table):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table.insert_many(rows, rowids=list(range(C9_N)))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain = VecTable("bench5", cols, initial_cap=C9_N, device=device)
    off_s = timed_insert(plain)
    npz = os.path.join(tmp, "cut.npz")
    t0 = time.perf_counter()
    snapshot.save(plain, npz, engine="npz")
    npz_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = snapshot.load(npz, device=device)
    torch.cuda.synchronize()
    npz_load_s = time.perf_counter() - t0
    _hold_loaded(torch, f"{C9_N} rows, npz", loaded, plain)
    npz_bitwise = _same_answers(f"{C9_N} rows, npz", _answers(torch, loaded, q, routes),
                                _answers(torch, plain, q, routes))
    del loaded

    saves, real_save = [], snapshot.save

    def counted_save(*args, **kw):
        real_save(*args, **kw)
        saves.append(time.perf_counter())

    tvs = os.path.join(tmp, "auto.tvs")
    snapshot.save = counted_save
    try:
        with writer_lock(tvs):
            writer = VecTable("bench5", cols, initial_cap=C9_N, autosave_path=tvs, device=device)
            on_s = timed_insert(writer)
            t0 = time.perf_counter()
            writer.wait_autosave()
            wait_s = time.perf_counter() - t0
            autosaves = len(saves)
            if autosaves == 0:
                raise AssertionError("snapshot: 9c: no autosave completed")
            try:
                with writer_lock(tvs):
                    raise AssertionError("snapshot: 9c: a second writer_lock on the path was granted")
            except InvalidState:
                pass
            proc, out, _ = _follower(tmp, tvs, q, "9c", wait=True)
            try:
                first = _first_line("9c", proc)
                t0 = time.perf_counter()
                snapshot.save(writer, tvs)  # the writer's commit of the rows since its last autosave
                commit_s = time.perf_counter() - t0
                want9c = _answers(torch, writer, q, {"HNSW": {}})["HNSW"]
                proc.stdin.write("refresh\n")
                proc.stdin.flush()
                rep = _follower_report("9c", proc, out, "after", want9c)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    finally:
        snapshot.save = real_save
    launches_9c, bu = _launches()
    if not rep["refreshed"] or rep["rows"] != C9_N or bu:
        raise AssertionError(f"snapshot: 9c: reader report {rep}, beam_update {bu}")
    c = dict(rows=C9_N, reduced=f"the first {C9_N} of config 5's {C5_N} rows",
             npz=dict(bytes=os.path.getsize(npz), save_s=npz_save_s, load_s=npz_load_s,
                      routes_bitwise_equal=npz_bitwise),
             insert_vec_s_autosave_off=C9_N / off_s, insert_vec_s_autosave_on=C9_N / on_s,
             wait_autosave_s=wait_s, autosave_every=writer.autosave_every, autosaves_completed=autosaves,
             rows_in_last_autosave=first["rows"], commit_s=commit_s, tvstore_bytes=os.path.getsize(tvs),
             follower=dict(refreshed=rep["refreshed"], rows=rep["rows"], refresh_s=rep["refresh_s"],
                           answers_equal=True),
             second_writer_lock_raised=True, launches=launches_9c)
    _log(f"snapshot: 9c: {C9_N} rows of config 5: npz {c['npz']['bytes']} bytes, save "
         f"{npz_save_s:.2f}s, load {npz_load_s:.2f}s, held equal, knn_many bitwise equal "
         f"{npz_bitwise}; insert_many {c['insert_vec_s_autosave_off']:.0f} vec/s with autosave off, "
         f"{c['insert_vec_s_autosave_on']:.0f} vec/s with autosave_every=16 ({autosaves} saves "
         f"completed, wait_autosave {wait_s:.2f}s); the reader loaded the last autosave's "
         f"{first['rows']} rows, then after the writer's commit ({commit_s:.2f}s) refresh() == True "
         f"in {rep['refresh_s']:.2f}s with all {rep['rows']} rows, answers equal the writer's; a "
         f"second writer_lock raised InvalidState; loop kernel launches {launches_9c}")
    return dict(config5_tvstore=a, follower_process=b, cut=c)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N, help="corpus rows (bench.py's size: 1000000)")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH",
                    help="also build the loop kernel from another beam_update.cu (an earlier "
                         "commit's, or a variant) and time it at every held shape, in turns "
                         "with this tree's")
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
    others = _start_other_builds(args.against)
    built = kernels.build_all()
    entry_points = {name: [fn for fn in kernels.SOURCES[name] if "cuda_error" not in fn] for name in built}
    _log(f"build: {entry_points} compiled and loaded in {time.time() - t0:.1f}s")
    for name in built:
        _log_ptxas(name, kernels.ptxas_report(name))
    global _PHASE_CLOCKS
    _PHASE_CLOCKS = _load_other_builds(others)

    update_shapes = check_beam_kernel(torch, device)
    run = run_main_path(torch, device, args.n)
    loop_shapes = check_loop_kernel(torch, device, run)
    trace_main_path(torch, device, run)
    qruns = run_quantized(torch, device, args.n)
    qshapes = check_quantized_loops(torch, device, qruns)
    filt = run_filtered(torch, device, run, qruns)
    mshapes = check_masked_loops(torch, device, run, qruns, filt)
    t8 = time.time()
    with _loop_shapes_seen(torch) as seen:
        c5 = run_table_config5(torch, device)
    c5_shapes = check_table_loops(torch, device, c5)
    _check_held("8a", seen, c5_shapes)
    t9 = time.time()
    with tempfile.TemporaryDirectory(prefix="tpuvec-snapshots-") as tmp, \
            _loop_shapes_seen(torch) as seen:
        snap = run_snapshots(torch, device, c5, tmp)
    _check_held("9", seen, c5_shapes)
    _log(f"snapshot: phase 9 took {time.time() - t9:.1f}s")
    del c5["table"]
    torch.cuda.empty_cache()
    with _loop_shapes_seen(torch) as seen:
        c4t = run_table_config4(torch, device, args.n)
    c4_shapes = check_table4_loops(torch, device, c4t)
    _check_held("8b", seen, c4_shapes)
    del c4t["table"]
    _log(f"table: phase 8 took {time.time() - t8:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t10 = time.time()
    with _loop_shapes_seen(torch) as seen:
        sq = run_sql(torch, device, run)
    sql_shapes = check_sql_loops(torch, device, sq)
    _check_held("10", seen, sql_shapes)
    sq["db"].close()
    del sq["db"], sq["graph"]
    sq["sql"]["seconds"] = time.time() - t10
    _log(f"sql: phase 10 took {sq['sql']['seconds']:.1f}s")

    def on(phase, shapes):  # each shape with the phase whose graph held it
        return [dict(s, on=phase) for s in shapes]

    def entry(name, replaces, launches, shapes, main_shape):
        return {
            "name": name,
            "route": "cuda",
            "source": "tpuvec_torch/csrc/beam_update.cu",
            "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": main_shape["ms"],
            "ms_source": main_shape["ms_source"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": None,
            "shapes": shapes,
        }

    # main shape: the construction shape, most of the path's time (for the
    # int8 form, of its squared-L2 form, the one config 3 runs)
    loop_src = "tpuvec/ops/pallas_beam.py:144 + tpuvec/index/search.py:336-357"
    kernels_line = [
        entry("beam_update", "tpuvec/ops/pallas_beam.py:144",
              {"phase 4": run["launches"]["beam_update"]}, on("phase 3", update_shapes),
              update_shapes[-1]),
        entry("beam_search_level0[f32]", loop_src,
              {"phase 4": run["launches"]["f32"], "phase 8a": c5["launches"]["f32"],
               "phase 9": snap["config5_tvstore"]["launches"]["f32"],
               "phase 9c": snap["cut"]["launches"]["f32"], "phase 10": sq["launches"]["f32"]},
              on("phase 3b", loop_shapes) + on("phase 8a", c5_shapes["f32"])
              + on("phase 10", sql_shapes["f32"]), loop_shapes[-1]),
        entry("beam_search_level0[int8]", loop_src, {"phase 6": qruns["int8"]["launches"]},
              on("phase 3c", qshapes["int8"]), qshapes["int8"][1]),
        entry("beam_search_level0[words]", loop_src,
              {"phase 6": qruns["words"]["launches"], "phase 8b": c4t["launches"]["words"]},
              on("phase 3c", qshapes["words"]) + on("phase 8b", c4_shapes["words"]),
              qshapes["words"][1]),
    ]
    # the masked forms under the 10% mask; main shape: f32's at ef=64,
    # int8's and words' the one shape of configs 3 and 4 (k=48, ef=64)
    masked_src = "tpuvec/index/search.py:295-316 + 363-383"
    masked_paths = {
        "f32": {"phase 7": filt["launches"]["f32+mask"], "phase 8a": c5["launches"]["f32+mask"],
                "phase 9": snap["config5_tvstore"]["launches"]["f32+mask"],
                "phase 9c": snap["cut"]["launches"]["f32+mask"], "phase 10": sq["launches"]["f32+mask"]},
        "int8": {"phase 7": filt["launches"]["int8+mask"]},
        "words": {"phase 7": filt["launches"]["words+mask"],
                  "phase 8b": c4t["launches"]["words+mask"]},
    }
    table_masked = {"f32": on("phase 8a", c5_shapes["f32+mask"]) + on("phase 10", sql_shapes["f32+mask"]),
                    "words": on("phase 8b", c4_shapes["words+mask"])}
    kernels_line += [
        entry(f"beam_search_level0[{form}+mask]", masked_src, paths,
              on("phase 3d", mshapes[form]) + table_masked.get(form, []), mshapes[form][0])
        for form, paths in masked_paths.items()
    ]
    _log(json.dumps({"snapshot": snap}))
    _log(json.dumps({"sql": sq["sql"]}))
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
