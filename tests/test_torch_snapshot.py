"""Snapshots, autosave and followers in the port
(tpuvec_torch/store/snapshot.py, follower.py) vs the JAX package's.

Two port tables (``device="cpu"``) are saved through each engine (npz and
the native tvstore):

* ``f32``: 300 x 32 cosine rows under shuffled rowids, a partition key, a
  metadata and an aux column, ``max_level=2``, 12 deletes and 3 updates,
  grown from 256 slots to 512;
* ``quant``: a BINARY-quantized f32 column (with its rerank shadow), an
  INT8-quantized f32 column and a ``VectorType.BIT`` column (Hamming),
  with a metadata column and 5 deletes.

Each file must load in the port equal field for field with identical
``knn_many`` on every route, and in the JAX package with equal host state,
scalar codes and graph arrays (packed words as uint32), the JAX ``knn``
on the f32 column giving the port's rowids; a file the JAX package writes
from that table must load in the port equal to the original. The JAX side
only loads, searches and saves: it runs no insert and no build.

Scalar values are interned again, in the file's order, when a table is
loaded, so the codes of a loaded table may be numbered otherwise than the
live table's: the live and loaded tables are held by the decoded value of
each slot, two loads of one file (port and JAX) by their codes.
"""

import ctypes
import ctypes.util
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from tpuvec.store import snapshot as jax_snapshot  # noqa: E402
from tpuvec_torch import interop, native  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.store import ColumnSpec, SnapshotFollower, VecTable, snapshot, writer_lock  # noqa: E402
from tpuvec_torch.types import IndexQuantization, InvalidState, VectorType  # noqa: E402
from tpuvec_torch.utils.data import synthetic_embeddings  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ENGINES = {"npz": ".npz", "native": ".tvs"}


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


N, D, NQ, K = 300, 32, 12, 5
PARAMS = HnswParams(m=8, max_m0=16, ef_construction=64, ef_search=32, max_level=2)
QN, QD = 200, 64
QPARAMS = HnswParams(m=8, max_m0=16, ef_construction=32, ef_search=32, max_level=2)


def _even(rowid, values):
    return rowid % 2 == 0


@pytest.fixture(scope="module")
def f32_table():
    """(table, queries, routes) of the f32 table."""
    data = synthetic_embeddings(N + 3 + NQ, D, intrinsic_dim=12, n_clusters=16, seed=6)
    rng = np.random.default_rng(1)
    rowids = (rng.permutation(4 * N)[:N] + 1).tolist()
    cols = [ColumnSpec.vector("e", D, params=PARAMS), ColumnSpec.partition_key("tenant"),
            ColumnSpec.metadata("tag"), ColumnSpec.aux("note")]
    t = VecTable("f", cols, initial_cap=256, device="cpu")
    t.insert_many([{"e": data[i], "tenant": int(rowids[i] % 7), "tag": int(rowids[i] % 2),
                    "note": f"n{rowids[i]}"} for i in range(N)], rowids=rowids)
    t.delete_many(rowids[::25])
    t.update_many(rowids[1:4], [{"e": data[N + j], "tag": 5} for j in range(3)])
    routes = {
        "hnsw": dict(column="e"),
        "hnsw ef=64": dict(column="e", ef=64),
        "exact": dict(column="e", exact=True),
        "partition": dict(column="e", partition=3),
        "per-query partitions": dict(column="e", partition=[j % 7 for j in range(NQ)]),
        "filter": dict(column="e", filters={"tag": 1}),
        "predicate": dict(column="e", predicate=_even),
    }
    assert t.cap == 512
    return t, data[N + 3 :], routes


@pytest.fixture(scope="module")
def quant_table():
    """(table, queries, routes) of the quantized table."""
    x = synthetic_embeddings(QN + NQ, QD, seed=8)
    bits = (np.random.default_rng(2).standard_normal((QN + NQ, QD)) > 0).astype(np.uint8)
    cols = [ColumnSpec.vector("b", QD, quantization=IndexQuantization.BINARY, params=QPARAMS),
            ColumnSpec.vector("i", QD, quantization=IndexQuantization.INT8, params=QPARAMS),
            ColumnSpec.vector("w", QD, vec_type=VectorType.BIT, params=QPARAMS),
            ColumnSpec.metadata("bucket")]
    t = VecTable("q", cols, initial_cap=256, device="cpu")
    t.insert_many([{"b": x[i], "i": x[i], "w": bits[i], "bucket": i % 4} for i in range(QN)])
    t.delete_many(range(1, QN + 1, 40))
    routes = {
        "binary, expansion": dict(column="b"),
        "binary, exact": dict(column="b", exact=True),
        "binary, filter": dict(column="b", filters={"bucket": 1}),
        "int8": dict(column="i"),
        "int8, exact": dict(column="i", exact=True),
        "int8, predicate": dict(column="i", predicate=_even),
        "bits": dict(column="w", queries=bits[QN:]),
        "bits, filter": dict(column="w", filters={"bucket": 2}, queries=bits[QN:]),
    }
    assert t.vector_cols["b"].shadow is not None
    return t, x[QN:], routes


@pytest.fixture(params=["f32", "quant"])
def table(request):
    return request.getfixturevalue(f"{request.param}_table")


def _knn(t, qs, route):
    kw = dict(route)
    column, queries = kw.pop("column"), kw.pop("queries", qs)
    return [[(r.rowid, r.distance) for r in res] for res in t.knn_many(column, queries, k=K, **kw)]


def _decoded(sc, cap):
    """Each slot's scalar value (None where NULL)."""
    return [sc.get(s) for s in range(cap)]


def assert_tables_equal(got: VecTable, want: VecTable):
    """Schema, host state, decoded scalars, raw originals, graph and shadow
    all equal; the loaded table starts clean."""
    assert (got.name, got.columns, got.index_type) == (want.name, want.columns, want.index_type)
    assert got._rowid_to_slot == want._rowid_to_slot
    assert got._slot_to_rowid == want._slot_to_rowid
    assert (got._max_rowid, got._next_slot, got._free_slots, len(got)) == (
        want._max_rowid, want._next_slot, want._free_slots, len(want))
    cap = want.cap
    assert got.cap == cap and got._live.shape[0] >= cap
    np.testing.assert_array_equal(got._live[:cap], want._live[:cap])
    for name, sc in want._scalars.items():
        assert got._scalars[name].codes.shape[0] >= cap
        assert _decoded(got._scalars[name], cap) == _decoded(sc, cap), name
    for cname, vc in want.vector_cols.items():
        gvc = got.vector_cols[cname]
        assert gvc.config == vc.config
        assert gvc.raw.dtype == vc.raw.dtype
        np.testing.assert_array_equal(gvc.raw, vc.raw)
        for f in snapshot._GRAPH_FIELDS:
            a, b = getattr(gvc.state, f), getattr(vc.state, f)
            assert a.dtype == b.dtype and a.device == got.device and torch.equal(a, b), (cname, f)
        assert (gvc.shadow is None) == (vc.shadow is None)
        if vc.shadow is not None:
            assert torch.equal(gvc.shadow, vc.shadow)
    assert got._version == 0 and got._dev_cache == {} and got._pending == []
    assert got.autosave_path is None and got.integrity_check() == []


def assert_same_knn(got: VecTable, want: VecTable, qs, routes):
    for name, route in routes.items():
        assert _knn(got, qs, route) == _knn(want, qs, route), name


@pytest.mark.parametrize("engine", list(ENGINES))
def test_port_roundtrip(tmp_path, table, engine):
    """Port save, port load: every field equal, knn_many identical on
    every route."""
    t, qs, routes = table
    path = str(tmp_path / f"s{ENGINES[engine]}")
    snapshot.save(t, path, engine=engine)
    assert open(path, "rb").read(4) == (b"TPVS" if engine == "native" else b"PK\x03\x04")
    loaded = snapshot.load(path, device="cpu")
    assert_tables_equal(loaded, t)
    assert_same_knn(loaded, t, qs, routes)


def _jax_host_state(ref):
    return (ref._rowid_to_slot, ref._slot_to_rowid, ref._max_rowid, ref._next_slot,
            ref._free_slots, len(ref))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_port_file_loads_in_jax(tmp_path, table, engine):
    """Port save, JAX load: host state, scalar codes (those of the port's
    own load of the file) and graph arrays equal; the JAX knn on the f32
    column returns the port's rowids, distances within 1e-5."""
    t, qs, routes = table
    path = str(tmp_path / f"s{ENGINES[engine]}")
    snapshot.save(t, path, engine=engine)
    ref = jax_snapshot.load(path)
    port = snapshot.load(path, device="cpu")
    assert _jax_host_state(ref) == _jax_host_state(port)
    np.testing.assert_array_equal(ref._live, port._live)
    for name, sc in port._scalars.items():
        np.testing.assert_array_equal(ref._scalars[name].codes, sc.codes, err_msg=name)
        assert ref._scalars[name].values == sc.values
    for cname, vc in t.vector_cols.items():
        rvc = ref.vector_cols[cname]
        assert rvc.config.cap == vc.config.cap and rvc.config.cap_u == vc.config.cap_u
        np.testing.assert_array_equal(rvc.raw, vc.raw)
        mine = interop.state_to_numpy(vc.state)
        for f in snapshot._GRAPH_FIELDS:
            theirs = np.asarray(getattr(rvc.state, f))
            assert theirs.dtype == mine[f].dtype and theirs.shape == mine[f].shape, (cname, f)
            np.testing.assert_array_equal(theirs, mine[f], err_msg=f"{cname}::{f}")
    if "e" in t.vector_cols:
        for name in ("hnsw", "exact", "filter"):
            kw = {k: v for k, v in routes[name].items() if k != "column"}
            want = t.knn_many("e", qs, k=K, **kw)
            got = ref.knn_many("e", qs, k=K, **kw)
            assert [[r.rowid for r in res] for res in got] == [[r.rowid for r in res] for res in want]
            np.testing.assert_allclose([[r.distance for r in res] for res in got],
                                       [[r.distance for r in res] for res in want], atol=1e-5)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_jax_file_loads_in_port(tmp_path, table, engine):
    """JAX load of a port file, JAX save of that table, port load: equal
    field for field to the original port table, with the codes of the
    port's own load of its file."""
    t, qs, routes = table
    suffix = ENGINES[engine]
    snapshot.save(t, str(tmp_path / f"port{suffix}"), engine=engine)
    ref = jax_snapshot.load(str(tmp_path / f"port{suffix}"))
    jax_snapshot.save(ref, str(tmp_path / f"jax{suffix}"), engine=engine)
    loaded = snapshot.load(str(tmp_path / f"jax{suffix}"), device="cpu")
    assert_tables_equal(loaded, t)
    first = snapshot.load(str(tmp_path / f"port{suffix}"), device="cpu")
    for name, sc in first._scalars.items():
        np.testing.assert_array_equal(loaded._scalars[name].codes, sc.codes)
        assert loaded._scalars[name].values == sc.values
    assert_same_knn(loaded, t, qs, routes)


def _arrays(t):
    out = {}
    for cname, vc in t.vector_cols.items():
        out[f"raw::{cname}"] = vc.raw
        state = interop.state_to_numpy(vc.state)
        for f in snapshot._GRAPH_FIELDS:
            out[f"graph::{cname}::{f}"] = state[f]
    return out


def _write_file(path, arrays, meta, engine):
    arrays = dict(arrays, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    if engine == "npz":
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return
    w = native.TvsWriter(path)
    for name, arr in arrays.items():
        w.add(name, arr)
    w.finish()


def _meta(tmp_path, t):
    """The meta record of ``t``'s snapshot."""
    snapshot.save(t, str(tmp_path / "m.npz"), engine="npz")
    with np.load(tmp_path / "m.npz") as z:
        return json.loads(bytes(z["__meta__"]).decode())


@pytest.mark.parametrize("engine", list(ENGINES))
def test_v1_file_loads(tmp_path, f32_table, engine):
    """A version 1 file with the upper arrays in their old [cap_u, LU, M]
    layout loads equal."""
    t, qs, routes = f32_table
    meta = dict(_meta(tmp_path, t), format_version=1)
    arrays = _arrays(t)
    lu, m = t.vector_cols["e"].config.lu, t.vector_cols["e"].config.m
    for f in ("upper_adj", "upper_dist"):
        a = arrays[f"graph::e::{f}"]
        arrays[f"graph::e::{f}"] = a.reshape(a.shape[0], lu, m)
    path = str(tmp_path / f"v1{ENGINES[engine]}")
    _write_file(path, arrays, meta, engine)
    loaded = snapshot.load(path, device="cpu")
    assert_tables_equal(loaded, t)
    assert_same_knn(loaded, t, qs, {"hnsw": routes["hnsw"]})


def test_unreadable_version_and_mesh_raise(tmp_path, f32_table):
    t, _, _ = f32_table
    meta = _meta(tmp_path, t)
    _write_file(str(tmp_path / "v3.npz"), _arrays(t), dict(meta, format_version=3), "npz")
    with pytest.raises(InvalidState, match="unsupported snapshot format 3"):
        snapshot.load(str(tmp_path / "v3.npz"), device="cpu")
    mesh = {"n_shards": 4, "counts": [0] * 4, "free": [[]] * 4, "rr": 0, "table_rr": 0}
    _write_file(str(tmp_path / "mesh.npz"), _arrays(t), dict(meta, mesh=mesh), "npz")
    with pytest.raises(NotImplementedError, match="sharding"):
        snapshot.load(str(tmp_path / "mesh.npz"), device="cpu")
    with pytest.raises(NotImplementedError, match="sharding"):
        snapshot.load(str(tmp_path / "m.npz"), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="sharding"):
        VecTable("x", [ColumnSpec.vector("e", 4)], mesh=object(), device="cpu")


@pytest.mark.parametrize("value", [np.int64(3), (1, 2)], ids=["numpy int", "tuple"])
def test_value_json_cannot_hold_raises(tmp_path, value):
    """A scalar JSON cannot encode, or would bring back as another value,
    raises InvalidState, and nothing is written."""
    t = VecTable("x", [ColumnSpec.vector("e", 4), ColumnSpec.metadata("tag")], device="cpu")
    t.insert({"e": [1.0, 0.0, 0.0, 0.0], "tag": value})
    for engine, suffix in ENGINES.items():
        with pytest.raises(InvalidState, match="JSON-serializable"):
            snapshot.save(t, str(tmp_path / f"s{suffix}"), engine=engine)
    assert list(tmp_path.iterdir()) == []


def test_engine_choice(tmp_path, f32_table, monkeypatch):
    """auto: tvstore unless the path ends in .npz; native raises without
    the library; an unknown engine raises."""
    t, _, _ = f32_table
    snapshot.save(t, str(tmp_path / "a.snap"))
    snapshot.save(t, str(tmp_path / "a.npz"))
    assert (tmp_path / "a.snap").read_bytes()[:4] == b"TPVS"
    assert (tmp_path / "a.npz").read_bytes()[:4] == b"PK\x03\x04"
    with pytest.raises(ValueError, match="unknown snapshot engine"):
        snapshot.save(t, str(tmp_path / "b.snap"), engine="zip")
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        snapshot.save(t, str(tmp_path / "b.snap"), engine="native")
    snapshot.save(t, str(tmp_path / "c.snap"))  # auto falls back to npz
    assert (tmp_path / "c.snap").read_bytes()[:4] == b"PK\x03\x04"
    assert not (tmp_path / "b.snap").exists()


def test_load_defaults_to_the_card(tmp_path, f32_table):
    """Without device= the table goes to the card: without one, load and
    SnapshotFollower raise."""
    t, _, _ = f32_table
    path = str(tmp_path / "s.tvs")
    snapshot.save(t, path)
    if torch.cuda.is_available():
        assert snapshot.load(path).vector_cols["e"].state.adj0.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snapshot.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnapshotFollower(path)


def _writer(path, every, rows=10):
    cols = [ColumnSpec.vector("e", D, params=PARAMS), ColumnSpec.metadata("tag")]
    return VecTable("w", cols, initial_cap=128, autosave_path=path, autosave_every=every,
                    device="cpu")


def _rows(n, seed):
    x = synthetic_embeddings(n, D, intrinsic_dim=12, n_clusters=8, seed=seed)
    return [{"e": v, "tag": i % 3} for i, v in enumerate(x)]


@pytest.mark.parametrize("every", [1, 4])
def test_autosave_every_n_flushes(tmp_path, every):
    """A snapshot starts on every ``every``-th flush and not before; after
    the last, the file loads equal to the table."""
    path = str(tmp_path / "auto.tvs")
    t = _writer(path, every)
    rows = _rows(80, seed=3)
    stamps = []
    for j in range(8):
        t.insert_many(rows[10 * j : 10 * (j + 1)])
        t.wait_autosave()
        stamps.append(os.stat(path).st_mtime_ns if os.path.exists(path) else None)
        assert (stamps[-1] is not None) == (j + 1 >= every), j
        if j and (j + 1) % every:
            assert stamps[-1] == stamps[-2], j  # no save between triggers
    assert_tables_equal(snapshot.load(path, device="cpu"), t)


def test_autosave_folds_a_trigger_in_flight(tmp_path, monkeypatch):
    """A trigger while a save is in flight starts no second save and keeps
    the count of flushes; the save's own flush starts no save either."""
    path = str(tmp_path / "auto.tvs")
    t = _writer(path, 1)
    real_save, started, release, calls = snapshot.save, threading.Event(), threading.Event(), []

    def slow_save(table, p, **kw):
        calls.append(threading.current_thread().name)
        started.set()
        assert release.wait(30)
        real_save(table, p, **kw)

    monkeypatch.setattr(snapshot, "save", slow_save)
    for row in _rows(20, seed=4):
        t.insert(row)  # 20 pending rows: the save's own flush takes them
    t._maybe_autosave()
    assert started.wait(30)
    thread = t._autosave_thread
    t._flushes_since_save = 3
    t._maybe_autosave()  # folded into the next save
    assert t._autosave_thread is thread and t._flushes_since_save == 3
    release.set()
    t.wait_autosave()
    assert not thread.is_alive() and calls == [thread.name]
    assert len(snapshot.load(path, device="cpu")) == 20


def test_follower_refreshes_on_a_new_generation(tmp_path):
    path = str(tmp_path / "snap.tvs")
    t = _writer(path, 1)
    rows = _rows(48, seed=5)
    t.insert_many(rows[:32])
    t.wait_autosave()
    f = SnapshotFollower(path, device="cpu")
    assert len(f) == 32 and f.row(1)["tag"] == 0
    assert f.refresh() is False  # no new generation, no reload
    t.insert_many(rows[32:])
    t.wait_autosave()
    assert f.refresh() is True and len(f) == 48
    q = rows[40]["e"]
    assert [r.rowid for r in f.knn("e", q, k=3)] == [r.rowid for r in t.knn("e", q, k=3)]
    assert f.table.device.type == "cpu"


def test_writer_lock_excludes_second_writer(tmp_path):
    path = str(tmp_path / "snap.tvs")
    with writer_lock(path):
        with pytest.raises(InvalidState, match="another writer"):
            with writer_lock(path):
                pass
    with writer_lock(path):  # released: can acquire again
        pass


def test_second_os_process_reads_snapshot(tmp_path, f32_table):
    """A process that imports only the port follows the snapshot on the
    CPU and answers as the writer does."""
    t, qs, _ = f32_table
    path = str(tmp_path / "s.tvs")
    snapshot.save(t, path)
    np.save(tmp_path / "q.npy", qs)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from tpuvec_torch.store import SnapshotFollower\n"
        f"f = SnapshotFollower({path!r}, device='cpu')\n"
        f"q = np.load({str(tmp_path / 'q.npy')!r})\n"
        f"res = f.table.knn_many('e', q, k={K})\n"
        "print(len(f))\n"
        "print([[r.rowid for r in rr] for rr in res])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuvec')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    n, ids, foreign = out.stdout.strip().splitlines()[-3:]
    assert int(n) == len(t)
    assert ids == str([[r.rowid for r in rr] for rr in t.knn_many("e", qs, k=K)])
    assert foreign == "[]"


def test_autosave_under_concurrent_writers(tmp_path):
    """Four threads insert and flush into one autosaving table, with a
    short switch interval, while a follower reloads whatever the writer
    publishes: every generation it loads is whole (integrity_check() ==
    [], each rowid's tag its own), and after the last save the file holds
    every row."""
    path = str(tmp_path / "snap.tvs")
    t = _writer(path, 1)
    rows = _rows(64, seed=6)
    errors = []

    def work(w):
        try:
            for j in range(w, len(rows), 4):
                t.insert(dict(rows[j], tag=j), rowid=j + 1)
                if j % 8 == w:
                    t.flush()
        except Exception as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        f, seen = None, 0
        while any(th.is_alive() for th in threads):
            time.sleep(0.01)
            if f is None and os.path.exists(path):
                f = SnapshotFollower(path, device="cpu")
            if f is not None and (f.refresh() or seen == 0):
                seen += 1
                assert f.table.integrity_check() == []
                assert all(f.row(rid)["tag"] == rid - 1 for rid in f.table._rowid_to_slot)
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    t.flush()
    t.wait_autosave()
    snapshot.save(t, path)
    loaded = snapshot.load(path, device="cpu")
    assert len(loaded) == len(rows) and seen >= 1
    assert_tables_equal(loaded, t)
