"""The port's build vs the JAX package's: its stages on shared inputs, then
the slice as a whole (build + search + exact oracle).

This file holds the only JAX build_graph call of the port's tests (one
module-scoped fixture): a JAX build costs tens of seconds on the CPU.
"""

import ctypes
import ctypes.util
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuvec.index import build as jax_build  # noqa: E402
from tpuvec.index import graph as jax_graph  # noqa: E402
from tpuvec.index.params import HnswParams as JaxParams  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec.utils.prng import sample_levels  # noqa: E402
from tpuvec_torch import interop  # noqa: E402
from tpuvec_torch.index import build  # noqa: E402
from tpuvec_torch.index.bruteforce import bruteforce_knn  # noqa: E402
from tpuvec_torch.index.graph import config_for, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import search_graph  # noqa: E402
from tpuvec_torch.types import DistanceMetric  # noqa: E402
from tpuvec_torch.utils.data import synthetic_embeddings  # noqa: E402
from tpuvec_torch.utils.prng import sample_levels_np  # noqa: E402


def _trim_heap():
    gc.collect()
    ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Hand freed heap back to the OS before and after this module, and
    drop the programs JAX compiled for it: glibc keeps freed XLA and torch
    buffers mapped, so a worker's memory only grows from file to file, and
    the suite's workers share one machine's memory."""
    _trim_heap()
    yield
    jax.clear_caches()
    _trim_heap()


N, D, NQ = 300, 32, 32
PARAMS = dict(m=8, max_m0=16, ef_construction=64, ef_search=32)
CFG = config_for(D, metric=DistanceMetric.COSINE, cap=512, params=HnswParams(**PARAMS))
JCFG = jax_graph.config_for(D, metric=JaxMetric.COSINE, cap=512, params=JaxParams(**PARAMS))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- stages


def test_heuristic_select_matches_jax():
    rng = np.random.default_rng(1)
    nb, c = 8, 48
    cvecs = rng.standard_normal((nb, c, 128)).astype(np.float32)
    cvecs /= np.linalg.norm(cvecs, axis=-1, keepdims=True)
    cand_d = np.sort(rng.random((nb, c)).astype(np.float32) * 4, axis=1)
    cand_d[:, 40:] = np.inf
    cand_i = rng.permutation(1000)[: nb * c].reshape(nb, c).astype(np.int32)
    cand_i[:, 40:] = -1
    sd_t, si_t = build.heuristic_select(CFG, _t(cand_d), _t(cand_i), _t(cvecs), 16)
    sd_j, si_j = jax_build.heuristic_select(
        JCFG, jnp.asarray(cand_d), jnp.asarray(cand_i), jnp.asarray(cvecs), 16
    )
    np.testing.assert_array_equal(si_t.numpy(), np.asarray(si_j))
    np.testing.assert_array_equal(sd_t.numpy(), np.asarray(sd_j))


def test_reverse_edges_match_jax():
    """_reverse_compute + the masked row write vs the JAX compute + its
    .at[].set(mode="drop"), including padding entrants and leaders whose
    target row is full."""
    rng = np.random.default_rng(2)
    cap, m0, nb, protect = 64, 16, 12, 8
    adj = rng.integers(0, cap, (cap, m0)).astype(np.int32)
    adj_d = np.sort(rng.random((cap, m0)).astype(np.float32), axis=1)
    adj[:, 12:], adj_d[:, 12:] = -1, np.inf
    new_ids = rng.permutation(cap)[:nb].astype(np.int32)
    new_ids[-2:] = -1
    fwd_i = rng.integers(0, 20, (nb, m0)).astype(np.int32)  # crowded targets
    fwd_d = np.sort(rng.random((nb, m0)).astype(np.float32) + 0.5, axis=1)
    fwd_i[:, 13:], fwd_d[:, 13:] = -1, np.inf
    ok_new = new_ids >= 0

    at, dt = _t(adj).clone(), _t(adj_d).clone()
    tgt, rows, rowsd = build._reverse_compute(
        at, dt, _t(new_ids), _t(fwd_i), _t(fwd_d), _t(ok_new), cap, m0, protect
    )
    build._write_rows(at[:, protect:], tgt, rows, tgt < cap)
    build._write_rows(dt[:, protect:], tgt, rowsd, tgt < cap)
    aj, dj = jax_build._reverse_pass(
        *map(jnp.asarray, (adj, adj_d, new_ids, fwd_i, fwd_d, ok_new)), cap, m0, protect
    )
    assert not np.array_equal(np.asarray(aj), adj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_levels_schedule_and_budget_match_jax():
    ids = np.arange(N, dtype=np.int32)
    lv_t = sample_levels_np(ids, CFG.rng_seed, CFG.level_factor, CFG.lu)
    lv_j = np.asarray(sample_levels(jnp.asarray(ids), JCFG.rng_seed, JCFG.level_factor, JCFG.lu))
    np.testing.assert_array_equal(lv_t, lv_j)  # the ids this file builds
    for total, mb, start in [(300, 64, 1), (100_000, 1024, 1), (5000, 1024, 777)]:
        assert build.plan_batch_sizes(total, mb, start) == jax_build.plan_batch_sizes(total, mb, start)
    for cap, efc, e in [(512, 64, 2), (100_096, 200, 2), (1_000_064, 200, 2), (512, 16, 1)]:
        assert build._build_iter_budget(cap, efc, e) == jax_build._build_iter_budget(cap, efc, e)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def slice_run():
    data = synthetic_embeddings(N + NQ, D, intrinsic_dim=12, n_clusters=16, seed=6)
    xp = prepare_vectors(CFG, data[:N], device="cpu")
    qp = prepare_vectors(CFG, data[N:], device="cpu")
    port = build.build_graph(CFG, xp, max_batch=64, device="cpu")
    ref = jax_build.build_graph(JCFG, xp.numpy(), max_batch=64)
    ref = interop.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(ref).items()}, device="cpu"
    )
    _, gt = bruteforce_knn(
        qp, xp, torch.ones(N, dtype=torch.bool), metric=CFG.graph_metric, k=10,
        normalized=True,
    )
    return port, ref, qp, gt


def test_builds_agree_on_node_bookkeeping(slice_run):
    port, ref, _, _ = slice_run
    for name in ["levels", "upper_slot", "upper_nodes", "entry_point", "entry_level", "count", "upper_count"]:
        np.testing.assert_array_equal(getattr(port, name).numpy(), getattr(ref, name).numpy(), err_msg=name)


def test_port_graph_structural_invariants(slice_run):
    """The invariants of tests/test_hnsw.py (structure, stored distances,
    upper graph, reachability, edge budget) on the port's graph."""
    state, _, _, _ = slice_run
    levels, adj0 = state.levels.numpy(), state.adj0.numpy()
    vec, dist = state.vectors.numpy(), state.adj0_dist.numpy()
    assert int(state.count) == N and (levels[:N] >= 0).all() and (levels[N:] == -1).all()
    ep = int(state.entry_point)
    assert ep >= 0 and int(state.entry_level) == levels[ep] == levels[:N].max()
    for i in range(N):
        row = adj0[i][adj0[i] >= 0]
        assert 0 < len(row) <= CFG.max_m0, f"row {i}"
        assert i not in row and len(set(row.tolist())) == len(row), f"row {i}"
        assert (levels[row] >= 0).all()
        for j, nb in enumerate(adj0[i]):
            if nb >= 0:
                assert abs(dist[i, j] - ((vec[i] - vec[nb]) ** 2).sum()) < 1e-4
    slots, nodes = state.upper_slot.numpy(), state.upper_nodes.numpy()
    for i in np.flatnonzero(levels >= 1):
        assert slots[i] >= 0 and nodes[slots[i]] == i
    assert 2.0 <= (adj0[:N] >= 0).sum(1).mean() <= CFG.max_m0
    und = [set(r[r >= 0].tolist()) for r in adj0[:N]]
    for i, row in enumerate(list(map(set, und))):
        for j in row:
            und[j].add(i)
    seen, frontier = {ep}, [ep]
    while frontier:
        frontier = [j for i in frontier for j in und[i] if not (j in seen or seen.add(j))]
    assert len(seen) >= 0.99 * N


def test_adjacency_agrees_with_jax(slice_run):
    """Level-0 rows agree with the JAX build's as sets on >= 95% of
    entries: candidate-beam merges and distance sums differ in float
    order, so near-ties can flip a few edges."""
    port, ref, _, _ = slice_run
    a, b = port.adj0.numpy()[:N], ref.adj0.numpy()[:N]
    same = sum(len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist())) for x, y in zip(a, b))
    total = sum(int((y >= 0).sum()) for y in b)
    assert same / total >= 0.95, same / total


def test_recall_close_to_jax(slice_run):
    port, ref, qp, gt = slice_run

    def recall(state):
        _, found = search_graph(CFG, state, qp, k=10, ef=32)
        return np.mean([len(set(f.tolist()) & set(g.tolist())) / 10 for f, g in zip(found, gt)])

    r_port, r_ref = recall(port), recall(ref)
    assert r_port >= 0.9 and abs(r_port - r_ref) <= 0.02, (r_port, r_ref)
