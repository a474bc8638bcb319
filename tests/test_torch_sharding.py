"""The mesh in the port (tpuvec_torch/parallel/sharding.py, the mesh-backed
VecTable, mesh snapshots and Database(mesh=)) vs the JAX package's.

The port's mesh is S=8 logical shards on the CPU; the JAX side is the
8-device virtual CPU mesh of tests/conftest.py. The JAX side compiles no
sharded insert and no build:

* routing and allocation are held against JAX ``ShardedHnsw`` and mesh
  ``VecTable`` objects that run the same script with their two device
  programs (``_sharded_insert``, ``_sharded_delete``) replaced by
  recorders: the host bookkeeping (shard of each row, slots, free lists,
  both round-robin pointers, partition codes, growth and its remap) runs
  as it is, and each recorded round is held against the port's
  per-shard ``insert_batch`` calls (ids, local-slot levels, width);
* each port shard's sub-graph is held against the port's own
  single-device ``insert_batch`` sequence over that shard's rows;
* the port's files (``save_sharded``, a mesh table's snapshot) load in the
  JAX package, whose search programs (one B, k and ef) must answer as the
  port does, and the JAX package's re-saves load back in the port equal.

Data is Gaussian (tie-free distances), so merged ids compare exactly
wherever distances are more than the tolerance apart, and as a set within
a group of near-equal distances.
"""

import contextlib
import ctypes
import ctypes.util
import gc
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from tpuvec.parallel import load_sharded as jax_load_sharded  # noqa: E402
from tpuvec.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tpuvec.parallel import save_sharded as jax_save_sharded  # noqa: E402
from tpuvec.parallel import sharding as jax_sharding  # noqa: E402
from tpuvec.index.params import HnswParams as JaxHnswParams  # noqa: E402
from tpuvec.store import ColumnSpec as JaxColumnSpec  # noqa: E402
from tpuvec.store import VecTable as JaxVecTable  # noqa: E402
from tpuvec.store import snapshot as jax_snapshot  # noqa: E402
from tpuvec.types import DistanceMetric as JaxMetric  # noqa: E402
from tpuvec_torch.index.build import insert_batch, plan_batch_sizes  # noqa: E402
from tpuvec_torch.index.graph import allocate, prepare_vectors  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.parallel import sharding  # noqa: E402
from tpuvec_torch.parallel.sharding import (  # noqa: E402
    ShardedHnsw,
    ShardFullError,
    load_sharded,
    make_mesh,
    save_sharded,
)
from tpuvec_torch.sql.engine import Database, connect  # noqa: E402
from tpuvec_torch.store import ColumnSpec, SnapshotFollower, VecTable, snapshot  # noqa: E402
from tpuvec_torch.types import DistanceMetric, InvalidParameter, InvalidState  # noqa: E402
from tpuvec_torch.utils.prng import sample_levels_np  # noqa: E402


def _trim_heap():
    gc.collect()
    ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Hand freed heap back to the OS before and after this module, and
    drop the programs JAX compiled for it."""
    _trim_heap()
    yield
    jax.clear_caches()
    _trim_heap()


S, D, K, NQ, BATCH = 8, 32, 5, 8, 32
PARAMS = dict(m=8, max_m0=16, ef_construction=32, ef_search=32)
TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(S, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= S, "conftest must provide 8 virtual devices"
    return jax_make_mesh(S)


def _data(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


@contextlib.contextmanager
def _jax_device_programs_recorded(calls):
    """JAX ShardedHnsw's insert and delete programs replaced by recorders of
    their host arguments: nothing compiles, the graph stays as it is."""
    orig = jax_sharding._sharded_insert, jax_sharding._sharded_delete

    def insert(config, mesh, stacked, ids, vecs, levels):
        calls.append(("insert", np.asarray(ids), np.asarray(levels), np.asarray(vecs)))
        return stacked

    def delete(config, mesh, stacked, ids):
        calls.append(("delete", np.asarray(ids)))
        return stacked

    jax_sharding._sharded_insert, jax_sharding._sharded_delete = insert, delete
    try:
        yield
    finally:
        jax_sharding._sharded_insert, jax_sharding._sharded_delete = orig


@contextlib.contextmanager
def _port_calls_recorded(idx_of, calls):
    """The port's per-shard insert_batch and delete_ids calls recorded as
    (kind, shard, ids, levels, width, rows) and passed on. ``idx_of()`` is
    the ShardedHnsw whose states the calls receive."""
    orig_insert, orig_delete = sharding.insert_batch, sharding.delete_ids

    def shard_of(state):
        return next(s for s, st in enumerate(idx_of().states) if st is state)

    def insert(config, state, ids, vecs, levels, *, width=None):
        calls.append(("insert", shard_of(state), ids.numpy().copy(), levels.numpy().copy(),
                      width, vecs.numpy().copy()))
        return orig_insert(config, state, ids, vecs, levels, width=width)

    def delete(config, state, ids):
        calls.append(("delete", shard_of(state), ids.numpy().copy()))
        return orig_delete(config, state, ids)

    sharding.insert_batch, sharding.delete_ids = insert, delete
    try:
        yield
    finally:
        sharding.insert_batch, sharding.delete_ids = orig_insert, orig_delete


def _per_shard(jax_calls):
    """JAX rounds ([S, batch] ids, -1 padded at the end of each shard's row)
    as the port's calls: one per shard with rows, inserts with their width."""
    out = []
    for call in jax_calls:
        if call[0] == "insert":
            _, ids, levels, vecs = call
            for s in range(ids.shape[0]):
                n = int((ids[s] >= 0).sum())
                assert (ids[s, :n] >= 0).all() and (ids[s, n:] == -1).all()
                if n:
                    out.append(("insert", s, ids[s, :n], levels[s, :n], ids.shape[1], vecs[s, :n]))
        else:
            for s in range(call[1].shape[0]):
                ids = call[1][s][call[1][s] >= 0]
                if ids.size:
                    out.append(("delete", s, ids))
    return out


def _assert_calls_equal(port_calls, jax_calls):
    want = _per_shard(jax_calls)
    got = [c for c in port_calls if c[0] == "insert" or len(c[2])]  # empty deletes run nothing
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])  # local slot ids
        if g[0] == "insert":
            np.testing.assert_array_equal(g[3], w[3])  # levels from local slots
            assert g[4] == w[4]  # the padded width
            np.testing.assert_array_equal(g[5], w[5][:, : g[5].shape[1]])


def _host_state(idx):
    return dict(counts=[int(c) for c in idx._counts], free=[[int(s) for s in f] for f in idx._free],
                rr=int(idx._rr), part_codes=np.asarray(idx._part_codes).copy(),
                part_list=list(idx._part_list), cap=idx.config.cap, cap_u=idx.config.cap_u)


def _assert_host_equal(got, want):
    codes_got, codes_want = got.pop("part_codes"), want.pop("part_codes")
    assert got == want
    np.testing.assert_array_equal(codes_got, codes_want)


# --------------------------------------------------------------------- #
# ShardedHnsw: one script on the port and on the JAX package's host side
# --------------------------------------------------------------------- #

X = _data(360, 0)
TENANTS = [i % 10 for i in range(360)]
Y = _data(16, 1)


def _sharded_script(idx):
    """Adds with and without partitions, deletes, updates with and without
    partitions, a grow, and adds that recycle freed slots. Yields (step,
    returned global ids or None) after each step."""
    g1 = idx.add(X[:160], partitions=TENANTS[:160], batch=BATCH)
    yield "add with partitions", g1
    g2 = idx.add(X[160:240], batch=BATCH)
    yield "add round robin", g2
    idx.delete(np.concatenate([g1[::7], g2[::9]]))
    yield "delete", None
    idx.update(g1[[1, 2, 3, 4, 5, 6, 8, 9]], Y[:8])  # rows the delete left
    idx.update(g2[1:9], Y[8:16], partitions=[f"u{j % 3}" for j in range(8)])
    yield "update", None
    idx.grow(256)
    yield "grow", None
    g3 = idx.add(X[240:320], partitions=TENANTS[240:320], batch=BATCH)
    yield "add after grow", g3


STEPS = ["add with partitions", "add round robin", "delete", "update", "grow", "add after grow"]


@pytest.fixture(scope="module")
def script(mesh, jmesh):
    """The script on a port ShardedHnsw and on a JAX one whose device
    programs are recorders: per step the returned ids, the host state and
    the device calls."""
    port = ShardedHnsw(mesh, D, metric=DistanceMetric.L2, params=HnswParams(**PARAMS),
                       cap_per_shard=128)
    jidx = jax_sharding.ShardedHnsw(jmesh, D, metric=JaxMetric.L2, params=JaxHnswParams(**PARAMS),
                                    cap_per_shard=128)
    steps = {}
    p_calls, j_calls = [], []
    with _jax_device_programs_recorded(j_calls), _port_calls_recorded(lambda: port, p_calls):
        for (name, pg), (_, jg) in zip(_sharded_script(port), _sharded_script(jidx)):
            steps[name] = dict(port_ids=pg, jax_ids=jg, port=_host_state(port), jax=_host_state(jidx),
                               port_calls=list(p_calls), jax_calls=list(j_calls))
            p_calls.clear()
            j_calls.clear()
    return port, steps


@pytest.mark.parametrize("step", STEPS)
def test_routing_matches_jax(script, step):
    """Global ids, per-shard high-water counts, free lists, the round-robin
    pointer, interned partitions and codes, and the grown capacity equal
    the JAX ShardedHnsw's after each step of one script."""
    st = script[1][step]
    if st["port_ids"] is not None:
        np.testing.assert_array_equal(st["port_ids"], st["jax_ids"])
    _assert_host_equal(dict(st["port"]), dict(st["jax"]))


@pytest.mark.parametrize("step", ["add with partitions", "add round robin", "delete", "update",
                                  "add after grow"])
def test_device_calls_match_jax(script, step):
    """Each insert round gives every shard with rows that round's rows of
    the JAX package's [S, batch] round (ids, levels from LOCAL slots, the
    prepared rows) at the padded width ``batch``; a delete gives each shard
    its own slots."""
    st = script[1][step]
    assert st["jax_calls"]
    _assert_calls_equal(st["port_calls"], st["jax_calls"])


def test_shard_graphs_equal_single_device_inserts(mesh):
    """Each shard's sub-graph equals the port's single-device insert_batch
    sequence over that shard's rows: the schedule over the largest shard's
    rows, up to each round's size from each shard, at width=batch with
    local-slot levels. Uneven tenants make the shared schedule differ from
    each shard's own."""
    params = HnswParams(**PARAMS)
    parts = [int(t) for t in np.random.default_rng(3).integers(0, 5, 200)]
    idx = ShardedHnsw(mesh, D, metric=DistanceMetric.L2, params=params, cap_per_shard=128)
    gids = idx.add(X[:200], partitions=parts, batch=BATCH)
    cfg = idx.config
    shard, slot = gids // cfg.cap, gids % cfg.cap
    rows = [np.nonzero(shard == s)[0] for s in range(S)]
    assert len({len(r) for r in rows}) > 2
    prepared = prepare_vectors(cfg, X[:200], device="cpu")
    for s in range(S):
        state, pos = allocate(cfg, device="cpu"), 0
        for take in plan_batch_sizes(max(len(r) for r in rows), BATCH):
            r = rows[s][pos : pos + take]
            pos += len(r)
            if len(r):
                ids = slot[r].astype(np.int32)
                state = insert_batch(cfg, state, torch.as_tensor(ids), prepared[torch.as_tensor(r)],
                                     torch.as_tensor(sample_levels_np(ids, cfg.rng_seed, cfg.level_factor,
                                                                      cfg.lu)), width=BATCH)
        for f in ("vectors", "adj0", "adj0_dist", "levels", "upper_slot", "upper_nodes", "upper_adj",
                  "upper_dist", "entry_point", "entry_level", "count", "upper_count"):
            assert torch.equal(getattr(idx.states[s], f), getattr(state, f)), (s, f)


def test_all_pad_batch_leaves_graph_unchanged(script):
    """An insert_batch of padding only (ids -1) changes no field: why a
    round may skip a shard that has no rows in it."""
    port = script[0]
    state = port.states[7]
    before = {f: t.clone() for f, t in vars(state).items()}
    cfg = port.config
    after = insert_batch(cfg, state, torch.full((4,), -1, dtype=torch.int32),
                         torch.zeros((4, cfg.padded_dim)), torch.zeros(4, dtype=torch.int32),
                         width=BATCH)
    for f, t in before.items():
        assert torch.equal(getattr(after, f), t), f


def test_make_mesh():
    m = make_mesh(3, "x", device="cpu")
    assert m.devices.size == 3 and m.axis_names == ("x",)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert make_mesh(device="cpu").devices.size == 1  # one shard per visible device
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    if torch.cuda.is_available():
        assert make_mesh(2).devices[1].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)


# --------------------------------------------------------------------- #
# ShardedHnsw search and files, both ways
# --------------------------------------------------------------------- #


def _assert_same_answers(got, want, tol=TOL):
    """Equal distances (within ``tol``) and, per row, equal ids within each
    group of distances less than ``tol`` apart."""
    (gd, gi), (wd, wi) = [tuple(np.asarray(a) for a in x) for x in (got, want)]
    assert gd.shape == wd.shape
    np.testing.assert_allclose(gd, wd, rtol=tol, atol=tol)
    for b in range(gd.shape[0]):
        start = 0
        for j in range(1, gd.shape[1] + 1):
            if j == gd.shape[1] or not (wd[b, j] == wd[b, j - 1] or abs(wd[b, j] - wd[b, j - 1]) <= tol):
                assert set(gi[b, start:j].tolist()) == set(wi[b, start:j].tolist()), (b, j)
                start = j


@pytest.fixture(scope="module")
def sharded_files(script, jmesh, tmp_path_factory):
    """The script's index saved by the port, loaded by the JAX package, and
    saved again by it."""
    port = script[0]
    d = tmp_path_factory.mktemp("sharded")
    path, jpath = str(d / "port.npz"), str(d / "jax.npz")
    save_sharded(port, path)
    jidx = jax_load_sharded(path, jmesh)
    jax_save_sharded(jidx, jpath)
    return port, jidx, path, jpath


QUERIES = X[320:328]


@pytest.mark.parametrize("route", ["all shards", "partition 3", "partition 9", "unknown partition"])
def test_port_file_answers_in_jax(sharded_files, route):
    """JAX load_sharded of the port's file answers as the port does: the
    merge over all shards, and one shard's exact masked scan for a tenant
    (an unknown one: no rows)."""
    port, jidx, _, _ = sharded_files
    kw = {} if route == "all shards" else {"partition": {"partition 3": 3, "partition 9": 9,
                                                        "unknown partition": "nobody"}[route]}
    got = port.search(QUERIES, k=K, **kw)
    _assert_same_answers(got, jidx.search(QUERIES, k=K, **kw))
    ids = np.asarray(got[1])
    if route == "unknown partition":
        assert (ids == -1).all()
    elif route != "all shards":
        codes = port._part_codes.reshape(-1)[ids[ids >= 0]]
        assert (codes == port._part_code_of[kw["partition"]]).all()


def test_jax_resave_loads_in_port(sharded_files, mesh):
    """The JAX package's save of what it loaded holds the port's arrays
    and meta exactly, and loads in the port answering as before."""
    port, _, path, jpath = sharded_files
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            if f == "__meta__":
                assert json.loads(bytes(a[f]).decode()) == json.loads(bytes(b[f]).decode())
            else:
                assert a[f].dtype == b[f].dtype, f
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    back = load_sharded(jpath, mesh)
    _assert_host_equal(_host_state(back), _host_state(port))
    for kw in ({}, {"partition": 3}):
        d1, i1 = port.search(QUERIES, k=K, **kw)
        d2, i2 = back.search(QUERIES, k=K, **kw)
        assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_sharded_recall(mesh):
    """recall@10 of the merged search against the exact scan (the port's
    counterpart of tests/test_sharding.py::test_sharded_recall, smaller)."""
    from tpuvec_torch.index.bruteforce import bruteforce_knn

    x, q = _data(400, 4), _data(8, 5)
    idx = ShardedHnsw(mesh, D, metric=DistanceMetric.L2,
                      params=HnswParams(m=8, max_m0=16, ef_construction=64, ef_search=64),
                      cap_per_shard=128)
    gids = idx.add(x, batch=BATCH)
    assert len(set(gids.tolist())) == 400 and len(idx) == 400
    d_s, i_s = idx.search(q, k=10)
    _, gt = bruteforce_knn(torch.as_tensor(q), torch.as_tensor(x), torch.ones(400, dtype=torch.bool),
                           metric=DistanceMetric.L2, k=10)
    hits = sum(len({int(gids[j]) for j in gt[b]} & set(i_s[b].tolist())) for b in range(8))
    assert hits / 80 >= 0.95
    assert (torch.diff(d_s, dim=1) >= 0).all()


def test_partition_affinity_and_filtered_route(mesh):
    """A tenant's rows co-locate on its shard; a tenant of more than 50 k
    members takes the in-beam filtered search on its shard and returns only
    its rows, the probe first; a small one the exact masked scan."""
    x = _data(400, 6)
    tenants = [0 if i % 4 else i % 10 for i in range(400)]  # tenant 0: 300 rows
    idx = ShardedHnsw(mesh, D, metric=DistanceMetric.L2, params=HnswParams(**PARAMS),
                      cap_per_shard=512)
    gids = idx.add(x, partitions=tenants, batch=BATCH)
    cap = idx.config.cap
    for t in set(tenants):
        assert all(gids[r] // cap == idx.shard_of_partition(t) for r in range(400) if tenants[r] == t)
    calls = []
    orig = sharding.search_graph
    sharding.search_graph = lambda *a, **kw: calls.append(kw.get("filter_mask")) or orig(*a, **kw)
    try:
        _, big = idx.search(x[1:3], k=K, partition=0)
        _, small = idx.search(x[4:5], k=K, partition=4)
    finally:
        sharding.search_graph = orig
    assert len(calls) == 1 and calls[0] is not None
    members = {int(gids[r]) for r in range(400) if tenants[r] == 0}
    assert big[:, 0].tolist() == [int(gids[1]), int(gids[2])]
    assert set(big.reshape(-1).tolist()) <= members
    assert small[0, 0] == int(gids[4]) and set(small[0].tolist()) - {-1} <= {
        int(gids[r]) for r in range(400) if tenants[r] == 4}


def test_delete_update_churn(mesh):
    """Deleted ids never come back, a second delete raises KeyError, adds
    recycle the freed slots, an update keeps its global id and its tenant
    (tests/test_sharding.py's churn and update-preserves-codes cases)."""
    x = _data(240, 7)
    tenants = [i % 4 for i in range(240)]
    idx = ShardedHnsw(mesh, D, metric=DistanceMetric.L2, params=HnswParams(**PARAMS),
                      cap_per_shard=128)
    gids = idx.add(x, partitions=tenants, batch=BATCH)
    dead = gids[::3]
    idx.delete(dead)
    assert len(idx) == 240 - dead.size
    with pytest.raises(KeyError):
        idx.delete([int(dead[0])])
    live = {int(g) for j, g in enumerate(gids) if j % 3}
    _, i_s = idx.search(x[:12], k=K)
    for b in range(12):
        got = set(i_s[b].tolist()) - {-1}
        assert got and got <= live
        if b % 3:
            assert int(gids[b]) in got
    again = idx.add(_data(dead.size, 8), partitions=[tenants[j] for j in range(0, 240, 3)], batch=BATCH)
    assert set(again.tolist()) == set(dead.tolist())
    rows = [r for r in range(240) if tenants[r] == 2 and r % 3][:3]
    z = _data(3, 9)
    idx.update(gids[rows], z)
    _, i_u = idx.search(z, k=1)
    assert i_u[:, 0].tolist() == [int(gids[r]) for r in rows]
    _, i_p = idx.search(z[:1], k=3, partition=2)
    assert int(gids[rows[0]]) in i_p[0].tolist()


def test_thousand_partitions(mesh):
    """BASELINE config 5's shape: 1,000 partition keys routed over the
    shards, two rows each; a tenant query returns exactly its two rows."""
    x = np.random.default_rng(11).standard_normal((2000, 16)).astype(np.float32)
    tenants = [i % 1000 for i in range(2000)]
    idx = ShardedHnsw(mesh, 16, metric=DistanceMetric.L2,
                      params=HnswParams(m=4, max_m0=8, ef_construction=16, ef_search=16),
                      cap_per_shard=512)
    gids = idx.add(x, partitions=tenants, batch=64)
    for t in (3, 512, 998):
        _, ids = idx.search(x[t][None], k=2, partition=t)
        assert set(ids[0].tolist()) == {int(gids[t]), int(gids[t + 1000])}


def test_port_save_load_roundtrip(script, mesh, tmp_path):
    """Port save, port load: host state, every shard's graph and every
    answer equal; an emptied tenant stays empty and adds after the load
    recycle its freed slots exactly."""
    port = script[0]
    path = str(tmp_path / "s.npz")
    save_sharded(port, path)
    back = load_sharded(path, mesh)
    assert len(back) == len(port)
    _assert_host_equal(_host_state(back), _host_state(port))
    for a, b in zip(back.states, port.states):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in vars(b))
    tenant = 7
    rows = np.nonzero(port._part_codes.reshape(-1) == port._part_code_of[tenant])[0]
    back.delete(rows)
    _, i_s = back.search(QUERIES[:1], k=3, partition=tenant)
    assert (i_s == -1).all()
    again = back.add(_data(rows.size, 12), partitions=[tenant] * rows.size, batch=BATCH)
    assert set(again.tolist()) == set(rows.tolist())


# --------------------------------------------------------------------- #
# the mesh-backed VecTable
# --------------------------------------------------------------------- #

TX = _data(460, 20)


def _table_rows(lo, hi):
    """Rows ``lo..hi-1``: six tenants of 40, then 150 rows of tenant "big"
    (its shard outgrows 128 slots), then rows with no tenant."""
    out = []
    for i in range(lo, hi):
        tenant = f"t{i % 6}" if i < 240 else "big" if i < 390 else None
        out.append({"emb": TX[i], "tenant": tenant, "tag": f"g{i % 3}"})
    return out


def _table_script(t):
    t.insert_many(_table_rows(0, 420))
    t.delete_many(list(range(1, 421, 9)))
    kept = [r for r in range(2, 120, 7) if r % 9 != 1][:12]  # rowids the delete left
    t.update_many(kept, [{"emb": TX[420 + j]} for j in range(12)])
    t.update(5, {"emb": TX[440], "tenant": "t3"})
    t.insert_many(_table_rows(441, 460))


def _cols(col_spec, metric):
    return [col_spec.vector("emb", D, metric=metric, params=_PARAMS_OF[col_spec](**PARAMS)),
            col_spec.partition_key("tenant"), col_spec.metadata("tag")]


_PARAMS_OF = {ColumnSpec: HnswParams, JaxColumnSpec: JaxHnswParams}


def _table_host(t):
    vc = next(iter(t.vector_cols.values()))
    return dict(
        rowid_to_slot=dict(t._rowid_to_slot), rr=t._rr, free_slots=list(t._free_slots),
        live=np.nonzero(t._live[: t.cap])[0].tolist(), cap=t.cap,
        codes={n: sc.codes[: t.cap].tolist() for n, sc in t._scalars.items()},
        idx=_host_state(vc.idx),
    )


@pytest.fixture(scope="module")
def mesh_table(mesh, jmesh):
    """A port mesh table after the script, the JAX mesh table's host state
    after the same script (device programs recorded), and both sides'
    device calls."""
    t = VecTable("m", _cols(ColumnSpec, DistanceMetric.L2), mesh=mesh, initial_cap=1024)
    jt = JaxVecTable("m", _cols(JaxColumnSpec, JaxMetric.L2), mesh=jmesh, initial_cap=1024)
    p_calls, j_calls = [], []
    with _port_calls_recorded(lambda: t.vector_cols["emb"].idx, p_calls):
        _table_script(t)
    with _jax_device_programs_recorded(j_calls):
        _table_script(jt)
    return t, _table_host(jt), p_calls, j_calls


def test_mesh_table_host_state_matches_jax(mesh_table):
    """Rowid -> global slot, the live slots, scalar codes (remapped by the
    growth), the table's and the index's round-robin pointers, free lists,
    counts and partition codes equal the JAX mesh table's after the same
    insert / delete / update script, which grows the table once."""
    t, jhost, _, _ = mesh_table
    assert t.cap == 2 * 1024
    host = _table_host(t)
    _assert_host_equal(host.pop("idx"), jhost.pop("idx"))
    assert host == jhost


def test_mesh_table_device_calls_match_jax(mesh_table):
    """Each flush's rounds (one schedule seeded with the per-shard graph
    size, every round at width 256) and each delete give every shard the
    JAX package's rows."""
    _, _, p_calls, j_calls = mesh_table
    _assert_calls_equal(p_calls, j_calls)


# queries off the table's rows: a self-distance, the square root of a
# float32 cancellation error, differs between any two summation orders
TQ = _data(NQ, 21)


def _routes():
    return {
        "hnsw": dict(),
        "exact": dict(exact=True),
        "partition t2": dict(partition="t2"),
        "partition big": dict(partition="big"),
        "filter": dict(filters={"tag": "g1"}),
    }


def _table_answers(t, route):
    res = t.knn_many("emb", list(TQ), k=K, **route)
    return [[(r.rowid, r.distance) for r in row] for row in res]


def _assert_same_rows(got, want):
    """Table answers equal: rowids and distances, tie-aware as
    ``_assert_same_answers``."""
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gd = np.array([[x[1] for x in g]]) if g else np.zeros((1, 0))
        wd = np.array([[x[1] for x in w]]) if w else np.zeros((1, 0))
        gi = np.array([[x[0] for x in g]]) if g else np.zeros((1, 0))
        wi = np.array([[x[0] for x in w]]) if w else np.zeros((1, 0))
        _assert_same_answers((gd, gi), (wd, wi))


@pytest.fixture(scope="module")
def mesh_table_in_jax(mesh_table, jmesh, tmp_path_factory):
    t = mesh_table[0]
    d = tmp_path_factory.mktemp("mesh_table")
    path, jpath = str(d / "port.npz"), str(d / "jax.npz")
    snapshot.save(t, path, engine="npz")
    jt = jax_snapshot.load(path, mesh=jmesh)
    jax_snapshot.save(jt, jpath, engine="npz")
    return t, jt, path, jpath


@pytest.mark.parametrize("route", ["hnsw", "exact", "partition t2"])
def test_mesh_table_file_answers_in_jax(mesh_table_in_jax, route):
    """JAX snapshot.load(mesh=) of the port's mesh snapshot answers as the
    port's table: the merged HNSW search, the sharded exact scan, and a
    tenant (the masked sharded scan)."""
    t, jt, _, _ = mesh_table_in_jax
    r = _routes()[route]
    _assert_same_rows(_table_answers(t, r), _table_answers(jt, r))
    assert jt.integrity_check() == []


@pytest.mark.parametrize("engine", ["npz", "native", "jax re-save"])
def test_mesh_table_loads_back_in_port(mesh_table_in_jax, mesh, tmp_path, engine):
    """The port's snapshot (npz and tvstore), and the JAX package's save of
    what it loaded, load in the port: host state, every shard's graph, and
    identical answers on every route, the filters included."""
    t, _, _, jpath = mesh_table_in_jax
    if engine == "jax re-save":
        path = jpath
    else:
        path = str(tmp_path / ("t.npz" if engine == "npz" else "t.tvs"))
        snapshot.save(t, path, engine=engine)
    back = snapshot.load(path, mesh=mesh)
    host, want = _table_host(back), _table_host(t)
    # a load interns scalars and partitions again, in rowid order: compare
    # the values the codes stand for
    for h, tab in ((host, back), (want, t)):
        h["codes"] = {n: [sc.get(s) for s in h["live"]] for n, sc in tab._scalars.items()}
        lut = np.array(h["idx"].pop("part_list") + [None], dtype=object)
        h["idx"]["part_codes"] = lut[h["idx"]["part_codes"]]
    _assert_host_equal(host.pop("idx"), want.pop("idx"))
    assert host == want
    for a, b in zip(back.vector_cols["emb"].idx.states, t.vector_cols["emb"].idx.states):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in vars(b))
    np.testing.assert_array_equal(back.vector_cols["emb"].raw, t.vector_cols["emb"].raw)
    for route in _routes().values():
        assert _table_answers(back, route) == _table_answers(t, route)
    assert back.integrity_check() == []


def test_mesh_crud_search_and_growth(mesh):
    """tests/test_table_mesh.py's CRUD and growth cases on the port: self
    queries, HNSW against exact, batched equal to single, tenant and
    metadata filters after the growth's remap, delete + reinsert, update."""
    t = VecTable("g", _cols(ColumnSpec, DistanceMetric.L2), mesh=mesh, initial_cap=1024)
    rids = t.insert_many(_table_rows(0, 420))
    assert len(t) == 420 and t.cap == 2048 and t.integrity_check() == []
    for probe in (0, 100, 300, 419):
        res = t.knn("emb", TX[probe], k=1)
        assert res and res[0].rowid == rids[probe]
        assert np.array_equal(t.row(rids[probe])["emb"].as_f32(), TX[probe])
    got = [r.rowid for r in t.knn("emb", TX[7], k=5)]
    assert len(set(got) & {r.rowid for r in t.knn("emb", TX[7], k=5, exact=True)}) >= 4
    batched = t.knn_many("emb", [TX[3], TX[9]], k=3)
    assert [r.rowid for r in batched[0]] == [r.rowid for r in t.knn("emb", TX[3], k=3)]
    res = t.knn("emb", TX[14], k=4, partition="t2")
    assert res and all((r.rowid - 1) % 6 == 2 and r.rowid <= 240 for r in res)
    res = t.knn("emb", TX[300], k=2, partition="big")  # 150 rows > 50 k: the masked sharded search
    assert res[0].rowid == rids[300] and all(240 < r.rowid <= 390 for r in res)
    res = t.knn("emb", TX[9], k=3, filters={"tag": "g0"})
    assert res[0].rowid == rids[9]
    t.delete_many(rids[::4])
    assert len(t) == 315 and t.integrity_check() == []
    assert not {r.rowid for r in t.knn("emb", TX[4], k=5)} & set(rids[::4])
    t.update(rids[1], {"emb": TX[455]})
    assert t.knn("emb", TX[455], k=1)[0].rowid == rids[1]


def test_mesh_rebuild(mesh):
    t = VecTable("r", _cols(ColumnSpec, DistanceMetric.L2), mesh=mesh, initial_cap=1024)
    rids = t.insert_many(_table_rows(0, 150))
    before = _table_host(t)
    t.rebuild("emb", params=HnswParams(m=4, max_m0=8, ef_construction=32, ef_search=32))
    assert _table_host(t)["idx"]["counts"] == before["idx"]["counts"]
    assert t.integrity_check() == []
    assert t.knn("emb", TX[42], k=1)[0].rowid == rids[42]


def test_mesh_sql_surface_and_follower(mesh, tmp_path):
    """connect(mesh=) makes every vec0 table mesh-backed: DDL with a
    partition key, inserts routed by tenant, MATCH with and without the
    tenant equal to the table's knn; a SnapshotFollower(mesh=) reads the
    table's snapshot."""
    db = connect(mesh=mesh)
    db.execute("CREATE VIRTUAL TABLE mt USING vec0(emb float[16] hnsw(m=4, ef_construction=16), "
               "tenant text partition key, capacity=2048)")
    x = np.random.default_rng(5).standard_normal((120, 16)).astype(np.float32)
    for i, v in enumerate(x):
        db.execute("INSERT INTO mt(rowid, emb, tenant) VALUES (?, ?, ?)", (i + 1, v.tobytes(), f"t{i % 5}"))
    t = db.table("mt")
    assert t.mesh is mesh and t.cap == 2048
    rows = db.execute("SELECT rowid, distance FROM mt WHERE emb MATCH ? AND k = 3",
                      (x[7].tobytes(),)).fetchall()
    assert rows[0][0] == 8 and rows == [(r.rowid, r.distance) for r in t.knn("emb", x[7], k=3)]
    rows = db.execute("SELECT rowid, distance FROM mt WHERE emb MATCH ? AND tenant = ? AND k = 4",
                      (x[10].tobytes(), "t0")).fetchall()
    assert rows and all((r[0] - 1) % 5 == 0 for r in rows)
    assert rows == [(r.rowid, r.distance) for r in t.knn("emb", x[10], k=4, partition="t0")]
    assert db.integrity_check("mt") == []
    path = str(tmp_path / "mt.npz")
    snapshot.save(t, path, engine="npz")
    f = SnapshotFollower(path, mesh=mesh)
    assert len(f) == 120 and f.table.mesh is mesh
    assert [r.rowid for r in f.knn("emb", x[7], k=3)] == [r[0] for r in db.execute(
        "SELECT rowid FROM mt WHERE emb MATCH ? AND k = 3", (x[7].tobytes(),)).fetchall()]


# --------------------------------------------------------------------- #
# what the mesh refuses
# --------------------------------------------------------------------- #


def _bad_version(mesh, tmp_path, script):
    path = str(tmp_path / "v3.npz")
    save_sharded(script[0], path)
    with np.load(path) as z:
        arrays = {f: z[f] for f in z.files}
    meta = dict(json.loads(bytes(arrays["__meta__"]).decode()), version=3)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="unsupported sharded-snapshot version 3"):
        load_sharded(path, mesh)


def _shard_count(mesh, tmp_path, script):
    path = str(tmp_path / "s.npz")
    save_sharded(script[0], path)
    with pytest.raises(ValueError, match="snapshot has 8 shards, mesh has 4"):
        load_sharded(path, make_mesh(4, device="cpu"))


def _table_shard_count(mesh, tmp_path, script):
    t = VecTable("c", _cols(ColumnSpec, DistanceMetric.L2), mesh=mesh)
    t.insert({"emb": TX[0], "tenant": "a"})
    snapshot.save(t, str(tmp_path / "t.npz"), engine="npz")
    with pytest.raises(InvalidState, match="snapshot has 8 shards, mesh has 4"):
        snapshot.load(str(tmp_path / "t.npz"), mesh=make_mesh(4, device="cpu"))
    with pytest.raises(InvalidState, match="mesh-backed: pass load"):
        snapshot.load(str(tmp_path / "t.npz"), device="cpu")


def _shard_full(mesh, tmp_path, script):
    idx = ShardedHnsw(mesh, D, metric=DistanceMetric.L2, params=HnswParams(**PARAMS), cap_per_shard=128)
    with pytest.raises(ShardFullError, match="over capacity"):
        idx.add(_data(129, 13), partitions=["one"] * 129)
    idx.grow(256)  # grow() makes the room
    idx.add(_data(1, 14), partitions=["one"])


def _non_json_partition(mesh, tmp_path, script):
    idx = ShardedHnsw(mesh, 16, metric=DistanceMetric.L2, params=HnswParams(**PARAMS), cap_per_shard=64)
    idx.add(np.ones((8, 16), np.float32), partitions=[b"blob"] * 8, batch=8)
    with pytest.raises(ValueError, match="JSON-serializable"):
        save_sharded(idx, str(tmp_path / "bad.npz"))


def _two_vector_columns(mesh, tmp_path, script):
    with pytest.raises(InvalidParameter, match="exactly one vector column"):
        VecTable("two", [ColumnSpec.vector("a", 8), ColumnSpec.vector("b", 8)], mesh=mesh)


def _per_query_partitions(mesh, tmp_path, script):
    t = VecTable("p", _cols(ColumnSpec, DistanceMetric.L2), mesh=mesh)
    t.insert_many(_table_rows(0, 12))
    with pytest.raises(InvalidParameter, match="mesh-backed tables"):
        t.knn_many("emb", [TX[0], TX[1]], k=2, partition=["t0", "t1"])


RAISES = {
    "version 3": _bad_version,
    "shard count": _shard_count,
    "table shard count and no mesh": _table_shard_count,
    "shard full": _shard_full,
    "non-JSON partition": _non_json_partition,
    "two vector columns": _two_vector_columns,
    "per-query partitions": _per_query_partitions,
}


@pytest.mark.parametrize("case", list(RAISES))
def test_raises(mesh, tmp_path, script, case):
    RAISES[case](mesh, tmp_path, script)


def test_database_mesh_tables_are_mesh_backed(mesh):
    """Database(mesh=) passes the mesh to every vec0 table and keeps the
    mesh's device; the mesh's one-vector-column rule reaches the DDL."""
    db = Database(mesh=mesh)
    assert db.device == torch.device("cpu")
    with pytest.raises(InvalidParameter, match="exactly one vector column"):
        db.execute("CREATE VIRTUAL TABLE two USING vec0(a float[4], b float[4])")
