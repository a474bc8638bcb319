"""VecTable in the port vs the JAX package.

One JAX VecTable and one port VecTable (``device="cpu"``) with the same
columns run the same script: ``insert_many`` of 600 seeded rows under
explicit rowids (no growth at the default ``initial_cap=1024``; the flush
schedule runs both of the JAX package's padded widths, 16 and 256),
``delete_many`` of 16 rowids, ``update_many`` of 5 rows. After it the host
state and the graph must be equal (ids exactly, distances within 1e-5) and
``knn_many`` must return identical rowids, distances within 1e-5, on every
route. The data is tie-free. The column's ``max_level=2`` keeps two upper
levels, so the descent runs over more than one: the JAX package unrolls
its upper stage per level, and the default 16 levels would more than
double the compile time of its two insert programs.

The BINARY column's read routes are held against a JAX VecTable that
holds the port table's rows and graph: JAX and port builds of a Hamming
graph agree only up to tie order (tests/test_torch_quantized.py), so the
JAX table takes the port's state and runs no insert of its own.

The rest is held by the port alone: capacity growth, ``knn_many`` against
``knn``, row round trips, the errors, the BINARY column's rerank against
the direct calls and ``rebuild``.
"""

import copy
import ctypes
import ctypes.util
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuvec.index.graph import GraphState as JaxGraphState  # noqa: E402
from tpuvec.index.params import HnswParams as JaxParams  # noqa: E402
from tpuvec.store.table import ColumnSpec as JaxColumnSpec  # noqa: E402
from tpuvec.store.table import VecTable as JaxVecTable  # noqa: E402
from tpuvec.types import IndexQuantization as JaxQuant  # noqa: E402
from tpuvec_torch import interop  # noqa: E402
from tpuvec_torch.codec import Vector  # noqa: E402
from tpuvec_torch.index.build import build_graph  # noqa: E402
from tpuvec_torch.index.graph import prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.index.search import search_graph  # noqa: E402
from tpuvec_torch.ops.rerank import expand_rerank_topk, rerank_topk  # noqa: E402
from tpuvec_torch.parallel import make_mesh  # noqa: E402
from tpuvec_torch.store import table as table_mod  # noqa: E402
from tpuvec_torch.store.table import ColumnSpec, VecTable  # noqa: E402
from tpuvec_torch.types import (  # noqa: E402
    DimensionMismatch,
    DistanceMetric,
    IndexQuantization,
    InvalidParameter,
    InvalidState,
    InvalidVectorFormat,
    VectorType,
)
from tpuvec_torch.utils.data import synthetic_embeddings  # noqa: E402


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


N, D, NQ, K, N_DEL, N_UPD = 600, 32, 16, 5, 16, 5
PARAMS = dict(m=8, max_m0=16, ef_construction=64, ef_search=32, max_level=2)


def _columns(spec_cls, params_cls):
    return [
        spec_cls.vector("e", D, params=params_cls(**PARAMS)),
        spec_cls.partition_key("tenant"),
        spec_cls.metadata("tag"),
    ]


@pytest.fixture(scope="module")
def script():
    """The rows, rowids, deletions, updates and queries of the script."""
    data = synthetic_embeddings(N + N_UPD + NQ, D, intrinsic_dim=12, n_clusters=16, seed=6)
    rng = np.random.default_rng(1)
    tenants, tags = rng.integers(0, 8, N), rng.integers(0, 2, N)
    rowids = (rng.permutation(5 * N)[:N] + 1).tolist()
    rows = [{"e": data[i], "tenant": int(tenants[i]), "tag": int(tags[i])} for i in range(N)]
    dels = rng.choice(rowids, N_DEL, replace=False).tolist()
    ups = rng.choice(sorted(set(rowids) - set(dels)), N_UPD, replace=False).tolist()
    upd = [{"e": data[N + j], "tag": j % 2} for j in range(N_UPD)]
    return dict(rows=rows, rowids=rowids, dels=dels, ups=ups, upd=upd, queries=data[N + N_UPD :])


def _run_script(table, s):
    table.insert_many(s["rows"], rowids=s["rowids"])
    table.delete_many(s["dels"])
    table.update_many(s["ups"], s["upd"])
    return table


@pytest.fixture(scope="module")
def tables(script):
    """(JAX table, port table) after the same script."""
    ref = _run_script(JaxVecTable("t", _columns(JaxColumnSpec, JaxParams)), script)
    port = _run_script(VecTable("t", _columns(ColumnSpec, HnswParams), device="cpu"), script)
    return ref, port


def test_host_state_matches_jax(tables):
    ref, port = tables
    assert port.cap == ref.cap == 1024
    np.testing.assert_array_equal(port.vector_cols["e"].raw, ref.vector_cols["e"].raw)
    np.testing.assert_array_equal(port._live, ref._live)
    assert port._rowid_to_slot == ref._rowid_to_slot
    assert port._slot_to_rowid == ref._slot_to_rowid
    assert port._free_slots == ref._free_slots
    assert (port._next_slot, port._max_rowid, len(port)) == (ref._next_slot, ref._max_rowid, len(ref))
    for name, col in port._scalars.items():
        np.testing.assert_array_equal(col.codes, ref._scalars[name].codes, err_msg=name)
        assert col.values == ref._scalars[name].values


def test_graph_state_matches_jax(tables):
    """Every GraphState field: ids and levels exactly, distances and the
    normalized rows within 1e-5."""
    ref, port = tables
    got = interop.state_to_numpy(port.vector_cols["e"].state)
    want = {k: np.asarray(v) for k, v in vars(ref.vector_cols["e"].state).items()}
    assert int(got["count"]) == N - N_DEL
    for name, a in got.items():
        assert a.dtype == want[name].dtype and a.shape == want[name].shape, name
        if a.dtype == np.float32:
            np.testing.assert_array_equal(np.isinf(a), np.isinf(want[name]), err_msg=name)
            fin = np.isfinite(a)
            np.testing.assert_allclose(a[fin], want[name][fin], atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, want[name], err_msg=name)


# route -> (knn_many keywords, the table method that must answer it)
ROUTES = {
    "hnsw": ({}, "_hnsw"),
    "predicate 50%": (dict(predicate=lambda rid, vals: rid % 2 == 0), "_hnsw"),
    "filters tag": (dict(filters={"tag": 1}), "_hnsw"),
    "partition": (dict(partition=3), "_exact_coded"),
    "per-query partitions": (
        dict(partition=[b % 8 for b in range(NQ - 2)] + [99, None]), "_exact_coded"),
    "exact": (dict(exact=True), "_exact"),
}


def _spy(monkeypatch, table, name):
    """Record the last positional argument (the mask, where one is
    passed) of every call of ``table.<name>``."""
    calls, method = [], getattr(table, name)

    def spy(vc, qp, k, *args):
        calls.append(args[-1] if args else None)
        return method(vc, qp, k, *args)

    monkeypatch.setattr(table, name, spy)
    return calls


def _pairs(results):
    return [[(r.rowid, r.distance) for r in res] for res in results]


@pytest.mark.parametrize("route", list(ROUTES))
def test_knn_matches_jax(tables, script, monkeypatch, route):
    """knn_many of 16 queries at k=5 through one route: identical rowids,
    distances within 1e-5. The two filtered HNSW routes keep more than 50 k
    rows, so they take the in-beam search (with no fallback to the exact
    scan); the partitions take the coded exact scan."""
    ref, port = tables
    kw, method = ROUTES[route]
    calls = _spy(monkeypatch, port, method)
    exact_calls = _spy(monkeypatch, port, "_exact") if method == "_hnsw" else []
    got = _pairs(port.knn_many("e", script["queries"], k=K, **kw))
    want = _pairs(ref.knn_many("e", script["queries"], k=K, **kw))
    assert len(calls) == 1 and not exact_calls
    if route in ("predicate 50%", "filters tag"):
        assert 50 * K < int(calls[0].sum()) < len(port)
    assert [[r for r, _ in g] for g in got] == [[r for r, _ in w] for w in want]
    np.testing.assert_allclose(
        [d for g in got for _, d in g], [d for w in want for _, d in w], atol=1e-5, rtol=0
    )
    deleted = set(script["dels"])
    assert not any(r in deleted for g in got for r, _ in g)
    if route == "per-query partitions":  # an unseen value and None match no row
        assert got[-2] == [] and got[-1] == []
    else:
        assert all(len(g) == K for g in got)


def test_integrity_check_clean(tables):
    ref, port = tables
    assert port.integrity_check() == [] == ref.integrity_check()


@pytest.mark.parametrize("route", ["hnsw", "predicate 50%", "partition", "exact"])
def test_knn_many_equals_knn(tables, script, route):
    """A batch answers each query as a call of its own: rowids identical,
    distances within 1e-6 (the CPU's products sum in another order at
    batch 1)."""
    port = tables[1]
    kw = ROUTES[route][0]
    batch = _pairs(port.knn_many("e", script["queries"], k=K, **kw))
    for q, want in zip(script["queries"], batch):
        got = _pairs([port.knn("e", q, k=K, **kw)])[0]
        assert [r for r, _ in got] == [r for r, _ in want]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want], atol=1e-6, rtol=0)


def test_per_query_partitions_equal_single_tenant_calls(tables, script):
    port = tables[1]
    parts = [b % 8 for b in range(NQ)]
    batch = _pairs(port.knn_many("e", script["queries"], k=K, partition=parts))
    for q, p, want in zip(script["queries"], parts, batch):
        got = _pairs([port.knn("e", q, k=K, partition=p)])[0]
        assert [r for r, _ in got] == [r for r, _ in want]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want], atol=1e-6, rtol=0)


def test_capacity_growth():
    """From initial_cap=128, 600 rows grow the table twice (128 -> 512 at
    the first flush, 512 -> 1024 at the second): every state tensor padded
    with its fill, cap_u = max(cap // 8, 128), each row its own nearest
    neighbour."""
    data = synthetic_embeddings(N, D, intrinsic_dim=12, n_clusters=16, seed=7)
    t = VecTable("g", [ColumnSpec.vector("e", D, params=HnswParams(**PARAMS))],
                 initial_cap=128, device="cpu")
    t.insert_many([{"e": v} for v in data])
    vc = t.vector_cols["e"]
    c, s = vc.config, vc.state
    assert (t.cap, c.cap, c.cap_u) == (1024, 1024, max(1024 // 8, 128))
    assert t._live.shape == (1024,) and vc.raw.shape == (1024, D)
    for name in ("vectors", "adj0", "adj0_dist", "levels", "upper_slot"):
        assert getattr(s, name).shape[0] == c.cap, name
    for name in ("upper_nodes", "upper_adj", "upper_dist"):
        assert getattr(s, name).shape[0] == c.cap_u, name
    assert bool((s.levels[N:] == -1).all()) and bool((s.adj0[N:] == -1).all())
    assert bool(torch.isinf(s.adj0_dist[N:]).all()) and bool((s.vectors[N:] == 0).all())
    assert int(s.count) == N and t.integrity_check() == []
    hits = t.knn_many("e", data[::40], k=1)
    assert [h[0].rowid for h in hits] == list(range(1, N + 1, 40))


@pytest.mark.parametrize("vec_type, dims", [
    (VectorType.FLOAT32, 12), (VectorType.INT8, 12), (VectorType.BIT, 20),
])
def test_row_round_trip(vec_type, dims):
    """Stored originals come back as inserted, and each row is its own
    nearest neighbour in the column's metric."""
    rng = np.random.default_rng(2)
    if vec_type is VectorType.FLOAT32:
        vals = rng.standard_normal((40, dims)).astype(np.float32)
        metric = DistanceMetric.L2
    elif vec_type is VectorType.INT8:
        vals = rng.integers(-128, 128, (40, dims)).astype(np.int8)
        metric = DistanceMetric.L2
    else:
        vals = rng.integers(0, 2, (40, dims)).astype(np.uint8)
        metric = DistanceMetric.HAMMING
    t = VecTable("r", [ColumnSpec.vector("v", dims, vec_type=vec_type, metric=metric),
                       ColumnSpec.aux("note")], initial_cap=128, device="cpu")
    t.insert_many([{"v": v, "note": f"n{i}"} for i, v in enumerate(vals)])
    for i in (0, 17, 39):
        row = t.row(i + 1)
        assert row["note"] == f"n{i}"
        assert row["v"].vec_type is vec_type
        assert row["v"].to_numpy().tolist() == vals[i].tolist()
        hit = t.knn("v", vals[i], k=1, exact=True)[0]
        assert hit.rowid == i + 1 and hit.distance == 0.0


def test_errors(tmp_path):
    cols = [ColumnSpec.vector("e", 4), ColumnSpec.metadata("tag")]
    t = VecTable("x", cols, device="cpu")
    t.insert({"e": [1.0, 0.0, 0.0, 0.0]}, rowid=5)
    with pytest.raises(DimensionMismatch):
        t.insert({"e": [1.0, 0.0, 0.0]})
    with pytest.raises(InvalidVectorFormat):
        t.insert({"e": Vector.from_i8([1, 2, 3, 4])})
    with pytest.raises(InvalidState):
        t.insert({"e": [0.0, 1.0, 0.0, 0.0]}, rowid=5)
    with pytest.raises(InvalidParameter):
        t.insert({"tag": 1})
    with pytest.raises(InvalidParameter):
        t.insert({"e": [0.0, 1.0, 0.0, 0.0], "tag": [1, 2]})
    with pytest.raises(InvalidParameter):
        t.knn("e", [1.0, 0.0, 0.0, 0.0], k=0)
    with pytest.raises(InvalidParameter):
        t.knn("e", [1.0, 0.0, 0.0, 0.0], k=1, partition="a")
    with pytest.raises(InvalidParameter):
        t.knn("e", [1.0, 0.0, 0.0, 0.0], k=1, partition=["a"])
    with pytest.raises(InvalidState):
        t.delete(6)
    # the mesh is ported (tests/test_torch_sharding.py): its own rule, one
    # vector column on a mesh-backed table, raises
    with pytest.raises(InvalidParameter, match="exactly one vector column"):
        VecTable("x", cols + [ColumnSpec.vector("f", 4)], mesh=make_mesh(2, device="cpu"))
    # autosave is ported (tests/test_torch_snapshot.py): no longer an
    # error, and nothing is written before the first flush
    VecTable("x", cols, autosave_path=str(tmp_path / "t.npz"), device="cpu")
    assert not (tmp_path / "t.npz").exists()
    assert len(t) == 1 and t.integrity_check() == []


def test_device_defaults_to_cuda():
    """The default device is the card: without one the table raises, with
    one every column lives there."""
    cols = [ColumnSpec.vector("e", 4)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VecTable("x", cols)
        return
    t = VecTable("x", cols)
    assert t.vector_cols["e"].state.adj0.device.type == "cuda"


BD, BN = 64, 300
BPARAMS = dict(m=8, max_m0=16, ef_construction=32, ef_search=32)


def _binary_columns(spec_cls, params_cls, quant):
    return [spec_cls.vector("b", BD, quantization=quant.BINARY, params=params_cls(**BPARAMS)),
            spec_cls.metadata("bucket")]


@pytest.fixture(scope="module")
def binary_table():
    """A BINARY-quantized f32 cosine column with a device shadow, and
    held-out queries."""
    data = synthetic_embeddings(BN + NQ, BD, seed=8)
    t = VecTable("b", _binary_columns(ColumnSpec, HnswParams, IndexQuantization),
                 initial_cap=512, device="cpu")
    t.insert_many([{"b": v, "bucket": i % 10} for i, v in enumerate(data[:BN])])
    t.delete_many(range(1, BN + 1, 7))
    return t, data[BN:]


@pytest.fixture(scope="module")
def binary_ref(binary_table):
    """A JAX VecTable with the binary table's columns that holds its rows,
    host state and graph (carried over as tests/test_torch_quantized.py
    carries a graph), with the shadow made from the rows by the JAX
    package's own refresh_shadow."""
    t, _ = binary_table
    ref = JaxVecTable("b", _binary_columns(JaxColumnSpec, JaxParams, JaxQuant), initial_cap=512)
    rvc, vc = ref.vector_cols["b"], t.vector_cols["b"]
    assert interop.config_to_dict(vc.config) == {
        k: getattr(v, "value", v) for k, v in vars(rvc.config).items()}
    rvc.raw = vc.raw.copy()
    rvc.state = JaxGraphState(
        **{k: jnp.asarray(v) for k, v in interop.state_to_numpy(vc.state).items()})
    rvc.refresh_shadow()
    for name in ("_rowid_to_slot", "_slot_to_rowid", "_free_slots", "_live", "_next_slot",
                 "_max_rowid"):
        setattr(ref, name, copy.deepcopy(getattr(t, name)))
    for name, col in t._scalars.items():
        for attr in ("codes", "values", "_code_of"):
            setattr(ref._scalars[name], attr, copy.deepcopy(getattr(col, attr)))
    ref._version += 1
    assert rvc.shadow is not None and len(ref) == len(t)
    return ref


# route -> knn_many keywords. BN rows hold fewer than 8 coarse_k = 768
# live rows, so a filter at the default coarse_k takes the exact Hamming
# scan; coarse_k=12 puts the 50% predicate (~128 rows) over 8 coarse_k and
# through the in-beam filtered Hamming search.
BINARY_ROUTES = {
    "graph, expansion by default": {},
    "graph, no expansion": dict(expand=False),
    "filter, exact scan": dict(filters={"bucket": 3}),
    "filter, exact scan, expansion": dict(filters={"bucket": 3}, expand=True),
    "predicate in-beam": dict(predicate=lambda rid, vals: rid % 2 == 0, coarse_k=12),
    "predicate in-beam, no expansion": dict(
        predicate=lambda rid, vals: rid % 2 == 0, coarse_k=12, expand=False),
    "host rerank": dict(host=True),
    "host rerank, filter": dict(host=True, filters={"bucket": 3}),
}


def _same_hamming_lists(port, jax_):
    """Two coarse Hamming lists (distances, slots) of the same graph search:
    distances equal in order, slots equal as a set per distinct distance
    below each row's last one. The JAX package's filtered search ends in an
    unstable bitonic sort, so the slots tied at the cut may differ."""
    (dp, ip), (dj, ij) = (np.asarray(x) for x in port), (np.asarray(x) for x in jax_)
    np.testing.assert_array_equal(dp, dj)
    for drow, irow, jrow in zip(dp, ip, ij):
        last = drow[np.isfinite(drow)].max(initial=-np.inf)
        for v in np.unique(drow[drow < last]):
            assert set(irow[drow == v].tolist()) == set(jrow[drow == v].tolist()), (v, irow, jrow)


@pytest.mark.parametrize("route", list(BINARY_ROUTES))
def test_binary_rerank_matches_jax(binary_table, binary_ref, monkeypatch, route):
    """knn_many on the BINARY column through _binary_rerank, in the port
    and in the JAX package on the same graph, for the device shadow's routes
    (coarse_k, the graph_used cutoff at 8 coarse_k, the expansion's default,
    the mask gather and the filter mask the expansion takes) and the host
    route (no shadow). Where the graph is searched, the two coarse Hamming
    lists agree up to the order of ties at the cut, and the JAX table goes
    on from the port's list, so that both rerank the same candidates: then
    rowids are identical and distances within 1e-5."""
    t, qs = binary_table
    kw = dict(BINARY_ROUTES[route])
    host = kw.pop("host", False)
    cols = (t.vector_cols["b"], binary_ref.vector_cols["b"])
    coarse, port_hnsw, ref_hnsw = {}, t._hnsw, binary_ref._hnsw

    def spy_port(vc, qp, k, ef, mask=None):
        coarse["port"] = port_hnsw(vc, qp, k, ef, mask)
        return coarse["port"]

    def spy_ref(vc, qp, k, ef, mask=None):
        coarse["jax"] = ref_hnsw(vc, qp, k, ef, mask)
        return tuple(jnp.asarray(x.numpy()) for x in coarse["port"])

    monkeypatch.setattr(t, "_hnsw", spy_port)
    monkeypatch.setattr(binary_ref, "_hnsw", spy_ref)
    if host:
        monkeypatch.setattr(table_mod, "SHADOW_BUDGET_BYTES", 0)
        monkeypatch.setenv("TPUVEC_SHADOW_BUDGET_MB", "0")
        for vc in cols:
            vc.refresh_shadow()
    try:
        assert all((vc.shadow is None) == host for vc in cols)
        got = _pairs(t.knn_many("b", qs, k=K, **kw))
        want = _pairs(binary_ref.knn_many("b", qs, k=K, **kw))
    finally:
        monkeypatch.undo()
        for vc in cols:
            vc.refresh_shadow()
    graph_used = "filters" not in kw
    assert set(coarse) == ({"port", "jax"} if graph_used else set())
    if graph_used:
        _same_hamming_lists(coarse["port"], coarse["jax"])
    assert [[r for r, _ in g] for g in got] == [[r for r, _ in w] for w in want]
    np.testing.assert_allclose(
        [d for g in got for _, d in g], [d for w in want for _, d in w], atol=1e-5, rtol=0
    )
    assert all(len(g) == K for g in got)
    if "filters" in kw:
        assert all(t.row(r)["bucket"] == 3 for g in got for r, _ in g)
    if "predicate" in kw:
        assert all(r % 2 == 0 for g in got for r, _ in g)


def _rowids_of(table, slots):
    return [[table._slot_to_rowid[int(s)] for s in row if s >= 0] for row in slots.tolist()]


@pytest.mark.parametrize("expand", [True, False])
def test_binary_device_rerank_equals_direct_calls(binary_table, expand):
    """The shadow route is the Hamming search at coarse_k = max(10 k, 96)
    followed by rerank_topk / expand_rerank_topk on the column's own
    state and shadow."""
    t, qs = binary_table
    vc = t.vector_cols["b"]
    assert vc.shadow is not None and vc.shadow.shape == (vc.config.cap, BD)
    got = _pairs(t.knn_many("b", qs, k=K, expand=expand))
    qp = prepare_vectors(vc.config, qs, device="cpu")
    _, i = search_graph(vc.config, vc.state, qp, k=96)
    qf = torch.from_numpy(qs)
    if expand:
        live = torch.from_numpy(t._live[: t.cap].copy())
        d, s = expand_rerank_topk(vc.shadow, vc.state.adj0, i, i >= 0, qf,
                                  metric=DistanceMetric.COSINE, k=K, filter_mask=live)
    else:
        d, s = rerank_topk(vc.shadow, i, i >= 0, qf, metric=DistanceMetric.COSINE, k=K)
    assert [[r for r, _ in g] for g in got] == _rowids_of(t, s)
    np.testing.assert_allclose([x for g in got for _, x in g],
                               d[torch.isfinite(d)].tolist(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("filters", [None, {"bucket": 3}])
def test_binary_host_rerank_equals_device(binary_table, monkeypatch, filters):
    """With no shadow (a budget of 0 bytes) the rerank runs on the host
    and equals the device route without the expansion."""
    t, qs = binary_table
    vc = t.vector_cols["b"]
    dev = _pairs(t.knn_many("b", qs, k=K, expand=False, filters=filters))
    monkeypatch.setattr(table_mod, "SHADOW_BUDGET_BYTES", 0)
    vc.refresh_shadow()
    try:
        assert vc.shadow is None
        host = _pairs(t.knn_many("b", qs, k=K, filters=filters))
    finally:
        monkeypatch.undo()
        vc.refresh_shadow()
    assert vc.shadow is not None
    assert [[r for r, _ in h] for h in host] == [[r for r, _ in g] for g in dev]
    np.testing.assert_allclose([x for h in host for _, x in h], [x for g in dev for _, x in g],
                               atol=1e-5, rtol=0)
    if filters:
        assert all(t.row(r)["bucket"] == 3 for h in host for r, _ in h)


def test_binary_coarse_k_widens_rerank(binary_table, monkeypatch):
    """coarse_k sets the Hamming search's k and the rerank pool's width."""
    t, qs = binary_table
    widths = []

    def spy(shadow, slots, *args, **kw):
        widths.append(slots.shape[1])
        return rerank_topk(shadow, slots, *args, **kw)

    monkeypatch.setattr(table_mod, "rerank_topk", spy)
    narrow = t.knn_many("b", qs, k=K, expand=False)
    wide = t.knn_many("b", qs, k=K, expand=False, coarse_k=200)
    assert widths == [96, 200]
    assert all(len(a) == len(b) == K for a, b in zip(narrow, wide))


def test_rebuild_equals_build_graph():
    """rebuild() builds the column's graph over the live rows at their
    slots, as build_graph does over the same prepared rows."""
    data = synthetic_embeddings(200, D, intrinsic_dim=12, n_clusters=16, seed=9)
    t = VecTable("rb", [ColumnSpec.vector("e", D, params=HnswParams(**PARAMS))],
                 initial_cap=256, device="cpu")
    t.insert_many([{"e": v} for v in data])
    t.delete_many(range(3, 201, 9))
    t.rebuild("e")
    vc = t.vector_cols["e"]
    slots = np.array(sorted(t._slot_to_rowid), dtype=np.int32)
    want = build_graph(vc.config, prepare_vectors(vc.config, vc.raw[slots], device="cpu"),
                       ids=slots, device="cpu")
    got = interop.state_to_numpy(vc.state)
    for name, a in interop.state_to_numpy(want).items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    assert int(vc.state.count) == len(t) and t.integrity_check() == []
    hit = t.knn("e", data[0], k=1)[0]
    assert hit.rowid == 1
