"""The vec0 SQL surface in the port (tpuvec_torch/sql/) vs the JAX
package's (tpuvec/sql/), on the CPU.

* Functions: every entry of ``functions._REGISTRY`` on f32, int8 and bit
  blobs, JSON text and bad input, against the JAX function: bytes, floats
  and strings equal, the same error class on bad input; ``register_all``
  on a stdlib ``sqlite3`` connection.
* DDL: ``parse_create_vtab`` on tests/test_sql.py's statements and more:
  the name, index type, options and every ``ColumnSpec`` field equal
  (enums by value); the same error class on bad DDL.
* Reads: a port Database built by SQL (a 300 x 32 cosine ``hnsw(...)``
  table with a metadata and an aux column after deletes and updates, a
  16-d L2 table of ``type=enn`` and a plain SQLite side table). Each vec0
  table is saved with the port's ``snapshot.save`` and loaded by the JAX
  package into a JAX Database that holds the same side table, so the JAX
  side runs no insert, no flush and no build: it loads, searches and
  mirrors. The SELECT shapes of tests/test_sql.py must give equal rows and
  descriptions in both: rowids identical, floats within 1e-5 relative
  (1e-6 absolute near 0, a few float32 ulps of 1 - cos);
  unsupported statements raise the same error class.
* Writes: the 12 cases of tests/test_txn.py on the port, and a write
  script (inserts, executemany, deletes by rowid and by WHERE, updates, a
  rolled-back transaction, vec_rebuild_hnsw) after which the table equals,
  field for field, a port VecTable driven by the equal sequence of calls
  (tests/test_torch_table.py holds that VecTable against the JAX one).
* Device and mesh: ``connect()`` defaults to the card, as VecTable does;
  a mesh raises ``NotImplementedError``.
"""

import ctypes
import ctypes.util
import dataclasses
import functools
import gc
import json
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import tpuvec.codec as jax_codec  # noqa: E402
import tpuvec.sql.engine as jax_engine  # noqa: E402
import tpuvec.types as jax_types  # noqa: E402
import tpuvec_torch.sql.engine as port_engine  # noqa: E402
import tpuvec_torch.types as port_types  # noqa: E402
from tpuvec.sql import connect as jax_connect  # noqa: E402
from tpuvec.sql import ddl as jax_ddl  # noqa: E402
from tpuvec.sql import functions as JF  # noqa: E402
from tpuvec.store import snapshot as jax_snapshot  # noqa: E402
from tpuvec_torch.codec import Vector  # noqa: E402
from tpuvec_torch.index.params import HnswParams  # noqa: E402
from tpuvec_torch.sql import Database, connect, register_all  # noqa: E402
from tpuvec_torch.sql import ddl  # noqa: E402
from tpuvec_torch.sql import functions as F  # noqa: E402
from tpuvec_torch.store import ColumnSpec, VecTable, snapshot  # noqa: E402
from tpuvec_torch.types import (  # noqa: E402
    DistanceMetric,
    IndexQuantization,
    IndexType,
    InvalidParameter,
    InvalidState,
    VectorType,
)
from tpuvec_torch.utils.data import synthetic_embeddings  # noqa: E402


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


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def _f32(vals):
    return np.asarray(vals, dtype="<f4").tobytes()


_rng = np.random.default_rng(11)
A, B = _f32(_rng.standard_normal(8)), _f32(_rng.standard_normal(8))
INT8 = np.arange(-3, 4, dtype=np.int8).tobytes()  # 7 bytes: int8 by size
BITS = bytes([0b10110010, 0b00001111, 0xFF])  # 3 bytes: int8 by size, bit when asked
# one-argument inputs: blobs of each type, JSON text, and bad input
UNARY = [
    A, INT8, BITS, _f32([0.0, 0.0, 0.0, 0.0]), _f32([3.0, 4.0]), "[1.5, -2.0, 3.25]", "[1, 0, 1, 1, 0, 0, 0, 0, 1]",
    "[300, -300, 3.9, -3.9]", "[]", "[1, \"a\"]", "not json", "{\"a\": 1}", b"", 5, None, 2.5,
]
# two-argument inputs: equal, mismatched and bad pairs
BINARY = [
    (A, B), (A, A), (A, _f32([1.0, 2.0])), (INT8, INT8), (BITS, BITS[::-1]), (BITS, b"\x00"),
    ("[1, 2, 3]", "[4, 5, 6]"), ("[0, 0]", "[1, 1]"), (_f32([0.0, 0.0]), _f32([1.0, 0.0])),
    ("[1, 0, 1, 1]", "[0, 0, 1, 1]"), (A, "oops"), (b"", A), (A, None), (7, 8),
]
SLICES = [(A, 0, 8), (A, 2, 5), (A, 5, 5), (A, -1, 3), (A, 3, 9), ("[1.0, 2.0]", 0, 1), (INT8, 0, 1)]


def _call(fn, args):
    """("ok", value) or ("raised", error class name)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — compared by class name
        return "raised", type(e).__name__


def _inputs(name, nargs):
    if nargs == 0:
        return [()]
    if name == "vec_slice":
        return SLICES
    if nargs == 2:
        return BINARY
    return [(v,) for v in UNARY]


def _this_runtime():
    """(backend, devices) as the port's vec_debug should report them here."""
    if not torch.cuda.is_available():
        return "cpu", ["cpu"]
    return "cuda", [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("name,nargs", [(n, a) for n, a, _ in F._REGISTRY], ids=[n for n, _, _ in F._REGISTRY])
def test_function_matches_jax(name, nargs):
    """Each registered function equals the JAX package's on every input:
    bytes, floats and strings equal; the same error class on bad input.
    vec_debug reports the runtime of its own package: equal in version and
    backend, and the port's names torch, never jax."""
    jax_fn = dict((n, f) for n, _, f in JF._REGISTRY)[name]
    assert [n for n, _, _ in F._REGISTRY] == [n for n, _, _ in JF._REGISTRY]
    assert nargs == dict((n, a) for n, a, _ in JF._REGISTRY)[name]
    assert getattr(F, name) is dict((n, f) for n, _, f in F._REGISTRY)[name]
    if name == "vec_debug":
        mine, theirs = json.loads(F.vec_debug()), json.loads(JF.vec_debug())
        assert mine["version"] == theirs["version"] == "0.1.0"
        assert (mine["backend"], mine["devices"]) == _this_runtime()
        assert mine["torch"] == torch.__version__ and "jax" not in mine
        return
    outcomes = set()
    for args in _inputs(name, nargs):
        got, want = _call(getattr(F, name), args), _call(jax_fn, args)
        assert got == want, (name, args)
        assert type(got[1]) is type(want[1]), (name, args)
        outcomes.add(got[0])
    if nargs:
        assert outcomes == {"ok", "raised"}, name  # the inputs reach both


def test_version_is_the_packages():
    import tpuvec_torch

    assert F.vec_version() == JF.vec_version() == f"tpuvec {tpuvec_torch.__version__}"
    for name in ("DistanceMetric", "IndexQuantization", "VectorType", "TpuVecError", "InvalidParameter",
                 "InvalidState", "DimensionMismatch", "InvalidVectorFormat", "InvalidVectorType",
                 "InvalidDistanceMetric"):
        assert name in tpuvec_torch.__all__ and getattr(tpuvec_torch, name).__module__ == "tpuvec_torch.types"


def test_register_all_on_stdlib_sqlite():
    """Every function registered on a plain sqlite3 connection gives the
    JAX package's results through SQL."""
    mine, theirs = sqlite3.connect(":memory:"), sqlite3.connect(":memory:")
    register_all(mine)
    JF.register_all(theirs)
    stmts = [
        ("SELECT vec_length(vec_f32('[1,2,3]')), vec_type(vec_int8('[1,-2]'))", ()),
        ("SELECT vec_distance_l2(vec_f32('[0,0]'), vec_f32('[3,4]')), vec_distance_l1(?, ?)", (A, B)),
        ("SELECT vec_distance_cosine(?, ?), vec_distance_hamming(vec_bit('[1,0,1,1]'), vec_bit('[0,0,1,1]'))",
         (A, B)),
        ("SELECT vec_to_json(vec_add(?, ?)), vec_sub(?, ?), vec_normalize(?)", (A, B, A, B, A)),
        ("SELECT vec_slice(?, 1, 4), vec_quantize_int8(?), vec_quantize_binary(?), vec_bit(?)",
         (A, A, A, "[1,0,1]")),
        ("SELECT vec_version()", ()),
    ]
    for sql, params in stmts:
        assert mine.execute(sql, params).fetchall() == theirs.execute(sql, params).fetchall(), sql
    names = {r[0] for r in mine.execute("SELECT name FROM pragma_function_list WHERE name LIKE 'vec_%'")}
    assert names == {n for n, _, _ in F._REGISTRY}
    assert json.loads(mine.execute("SELECT vec_debug()").fetchone()[0])["backend"] == _this_runtime()[0]
    with pytest.raises(sqlite3.OperationalError):
        mine.execute("SELECT vec_f32('oops')")


# ---------------------------------------------------------------------------
# DDL
# ---------------------------------------------------------------------------


DDL = [
    """CREATE VIRTUAL TABLE docs USING vec0(
        emb float[768] hnsw(M=64, ef_construction=200,
                            index_quantization=int8, distance=l2),
        user_id INTEGER PARTITION KEY,
        +payload TEXT,
        label TEXT,
        chunk_size=1024
    )""",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4])",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4], type=enn)",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4], capacity=50000)",
    "CREATE VIRTUAL TABLE c USING vec0(v float[4] hnsw(M=4), capacity=2000)",
    "CREATE VIRTUAL TABLE IF NOT EXISTS \"q\" USING vec0(a int8[16] hnsw(), b bit[64] hnsw(distance=hamming), tag);",
    "CREATE VIRTUAL TABLE x USING vec0(e float[32] hnsw(ef_search=48, index_quantization=binary, "
    "distance=cosine), t INTEGER PARTITION KEY, +note, type=hnsw)",
    "create virtual table lower using vec0(e binary[8] hnsw(distance=manhattan, M=6), f float32[3])",
    "CREATE TABLE t(x)",
    "CREATE VIRTUAL TABLE t USING fts5(x)",
    # bad DDL: the same error in both packages
    "CREATE VIRTUAL TABLE t USING vec0(v float[4] hnsw(M=4, bogus=1))",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4] hnsw(M))",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4], capacity=0)",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4], colour=red)",
    "CREATE VIRTUAL TABLE t USING vec0(v double[4])",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4] hnsw(distance=chebyshev))",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4] hnsw(index_quantization=int4))",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4] extra)",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4] hnsw(M=4)",
    "CREATE VIRTUAL TABLE t USING vec0(v float[4], type=ivf)",
]


def _spec_fields(spec):
    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if f.name == "params":
            v = None if v is None else dataclasses.asdict(v)
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


def _parsed(mod, sql):
    try:
        out = mod.parse_create_vtab(sql)
    except Exception as e:  # noqa: BLE001 — compared by class name
        return "raised", type(e).__name__
    if out is None:
        return "none", None
    name, cols, index_type, options = out
    return "ok", (name, [_spec_fields(c) for c in cols], index_type.value, options)


@pytest.mark.parametrize("sql", DDL, ids=range(len(DDL)))
def test_parse_create_vtab_matches_jax(sql):
    assert _parsed(ddl, sql) == _parsed(jax_ddl, sql)
    if _parsed(ddl, sql)[0] == "ok":
        _, cols, _, _ = ddl.parse_create_vtab(sql)
        assert all(c.params is None or isinstance(c.params, HnswParams) for c in cols)
        assert all(isinstance(c, ColumnSpec) for c in cols)


def test_split_args_matches_jax():
    for args in ("a float[4] hnsw(M=8, distance=l2), b TEXT, type=enn", "x, (y, z), ,w", ""):
        assert ddl.split_args(args) == jax_ddl.split_args(args)


# ---------------------------------------------------------------------------
# reads: the port's Database against a JAX Database on the port's tables
# ---------------------------------------------------------------------------


N, D, UN, UD = 300, 32, 120, 16
T_DDL = ("CREATE VIRTUAL TABLE t USING vec0(e float[32] hnsw(M=8, ef_construction=64, ef_search=32), "
         "label TEXT, +aux TEXT)")
U_DDL = "CREATE VIRTUAL TABLE u USING vec0(f float[16] hnsw(distance=l2), tag INTEGER, type=enn)"


@pytest.fixture(scope="module")
def data():
    x = synthetic_embeddings(N + 40, D, intrinsic_dim=12, n_clusters=16, seed=21)
    u = np.random.default_rng(22).standard_normal((UN + 4, UD)).astype(np.float32)
    rowids = (np.random.default_rng(23).permutation(4 * N)[:N] + 1).tolist()
    return dict(x=x, u=u, rowids=rowids, q=x[N + 8 :])


@pytest.fixture(scope="module")
def dbs(data, tmp_path_factory):
    """(port Database, JAX Database holding the port's tables)."""
    x, u, rowids = data["x"], data["u"], data["rowids"]
    db = connect(device="cpu")
    db.execute(T_DDL)
    db.execute(U_DDL)
    db.executemany("INSERT INTO t(rowid, e, label, aux) VALUES (?, ?, ?, ?)",
                   [[r, x[i].tobytes(), f"l{r % 10}", f"a{r}"] for i, r in enumerate(rowids)])
    db.execute(f"DELETE FROM t WHERE rowid IN ({', '.join(map(str, rowids[:6]))})")
    db.execute("DELETE FROM t WHERE rowid = ?", [rowids[6]])
    for j, r in enumerate(rowids[10:14]):
        db.execute("UPDATE t SET e = ?, label = ? WHERE rowid = ?", [x[N + j].tobytes(), "l99", r])
    db.executemany("INSERT INTO u(f, tag) VALUES (?, ?)", [[u[i].tobytes(), i % 5] for i in range(UN)])
    side = [(i, f"doc{i}") for i in range(1, 4 * N + 1)]
    ref = jax_connect()
    for d_ in (db, ref):
        d_.execute("CREATE TABLE meta (id INTEGER PRIMARY KEY, title TEXT)")
        d_.sqlite.executemany("INSERT INTO meta VALUES (?, ?)", side)
    tmp = tmp_path_factory.mktemp("sql")
    for name in ("t", "u"):
        path = str(tmp / f"{name}.npz")
        snapshot.save(db.table(name), path, engine="npz")
        ref.tables[name] = jax_snapshot.load(path)
    assert len(db.table("t")) == N - 7 and len(ref.tables["t"]) == N - 7
    assert not db.table("u").vector_cols["f"].has_hnsw
    return db, ref


def _json(v):
    return json.dumps([float(a) for a in v])


def _reads(data):
    """(SQL, params) of every read shape."""
    q, x, u, rowids = data["q"], data["x"], data["u"], data["rowids"]
    live = rowids[20]
    return {
        "match k": ("SELECT rowid, distance FROM t WHERE e MATCH ? AND k = 5", [q[0].tobytes()]),
        "match k ef": ("SELECT rowid, distance FROM t WHERE e MATCH ? AND k = 5 AND ef = 16", [q[1].tobytes()]),
        "match json, k bound": ("SELECT rowid, distance FROM t WHERE e MATCH ? AND k = ? ORDER BY distance",
                                [_json(q[2]), 5]),
        "match filter, textual binds": (
            "SELECT rowid, distance, label FROM t WHERE e MATCH ? AND label = ? AND k = ?",
            [q[3].tobytes(), "l3", 5]),
        "filter before match": ("SELECT rowid FROM t WHERE label = ? AND e MATCH ? AND k = ?",
                                ["l3", q[3].tobytes(), 5]),
        "projections": ("SELECT rowid, distance, vec_to_json(e), vec_length(e) AS n, label, aux FROM t "
                        "WHERE e MATCH ? AND k = 5 ORDER BY distance", [q[4].tobytes()]),
        "projection bind": ("SELECT rowid, vec_distance_cosine(e, vec_f32(?)) AS c FROM t WHERE e MATCH ? "
                            "AND k = 5 LIMIT 3", [_json(x[0]), q[5].tobytes()]),
        "rowid lookup": ("SELECT * FROM t WHERE rowid = ?", [live]),
        "rowid lookup, missing": ("SELECT rowid, label FROM t WHERE rowid = ?", [rowids[0]]),
        "scan order limit": ("SELECT rowid, label, aux FROM t ORDER BY rowid LIMIT 7", []),
        "scan limit bound": ("SELECT rowid FROM t LIMIT ?", [9]),
        "scan all": ("SELECT rowid, label FROM t", []),
        "group by": ("SELECT label, COUNT(*) FROM t GROUP BY label ORDER BY label", []),
        "count": ("SELECT count(*) FROM t", []),
        "arbitrary where": ("SELECT count(*), min(rowid) FROM t WHERE rowid > 600 AND vec_length(e) = 32", []),
        "order by metadata": ("SELECT rowid FROM t ORDER BY label DESC, rowid LIMIT 5", []),
        "knn join": ("SELECT t.rowid, t.distance, m.title FROM t JOIN meta m ON m.id = t.rowid "
                     "WHERE t.e MATCH ? AND k = 5 ORDER BY t.distance", [q[6].tobytes()]),
        "match vec_f32 alias": ("SELECT a.rowid, a.distance FROM t AS a JOIN meta m ON m.id = a.rowid "
                                "WHERE a.e MATCH vec_f32(?) AND k = 4", [_json(q[7])]),
        "subquery": ("SELECT vec_length(e), label FROM t WHERE rowid IN (SELECT id FROM meta WHERE title = ?)",
                     [f"doc{live}"]),
        "cte over match": ("WITH near AS (SELECT rowid AS r, distance FROM t WHERE e MATCH ? AND k = 5) "
                           "SELECT r, distance FROM near ORDER BY r", [q[8].tobytes()]),
        "cte": ("WITH big AS (SELECT rowid AS r FROM t WHERE label = 'l2') SELECT count(*) FROM big", []),
        "self join": ("SELECT a.rowid FROM t a JOIN t b ON a.rowid = b.rowid ORDER BY a.rowid LIMIT 4", []),
        "from subselect": ("SELECT rowid FROM (SELECT * FROM t) ORDER BY rowid LIMIT 4", []),
        "two vec0 join": ("SELECT t.rowid, u.tag FROM t JOIN u ON u.rowid = t.rowid WHERE u.tag < 2 "
                          "ORDER BY t.rowid", []),
        "mirror json text": ("SELECT e, aux FROM t WHERE rowid = ? AND 1 = 1", [live]),
        "enn match": ("SELECT rowid, distance FROM u WHERE f MATCH ? AND k = 6", [u[UN].tobytes()]),
        "enn match filter": ("SELECT rowid, distance, tag FROM u WHERE f MATCH ? AND tag = 2 AND k = 3",
                             [u[UN + 1].tobytes()]),
        "enn projection": ("SELECT rowid, vec_distance_l2(f, ?) FROM u WHERE rowid = 7", [u[UN + 2].tobytes()]),
        "plain sql": ("SELECT vec_version(), vec_length(vec_f32('[1,2,3]')), count(*) FROM meta", []),
    }


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and not isinstance(a, (str, bytes)):
                # 1e-5 relative; a cosine distance 1 - dot near 0 carries a
                # few float32 ulps of 1.0 (1.2e-7 each) absolute
                assert a == pytest.approx(b, rel=1e-5, abs=1e-6)
            else:
                assert type(a) is type(b) and a == b


READS = list(_reads(dict(q=np.zeros((16, D)), x=np.zeros((N, D)), u=np.zeros((UN + 4, UD)),
                         rowids=list(range(N)))))


@pytest.fixture
def no_jax_writes(monkeypatch):
    """The JAX table's write paths raise: its side only loads, searches
    and mirrors."""
    from tpuvec.store import table as jax_table

    def refuse(*args, **kwargs):
        raise AssertionError("the JAX package inserted or built")

    for name in ("insert_batch", "build_graph", "delete_ids"):
        monkeypatch.setattr(jax_table, name, refuse)


@pytest.mark.parametrize("name", READS)
def test_select_matches_jax(dbs, data, name, no_jax_writes):
    """The statement gives the JAX Database's rows and description."""
    db, ref = dbs
    sql, params = _reads(data)[name]
    got, want = db.execute(sql, list(params)), ref.execute(sql, list(params))
    assert got.description == want.description
    rows = got.fetchall()
    _same_rows(rows, want.fetchall())
    if name not in ("rowid lookup, missing",):
        assert rows, name


def test_match_filter_keeps_label(dbs, data):
    db, _ = dbs
    sql, params = _reads(data)["match filter, textual binds"]
    rows = db.execute(sql, params).fetchall()
    assert len(rows) == 5 and all(r[2] == "l3" for r in rows)


UNSUPPORTED = [
    "INSERT INTO t SELECT * FROM t",
    "REPLACE INTO t(rowid, label) VALUES (1, 'x')",
    "ALTER TABLE t ADD COLUMN z",
    "SELECT rowid FROM t WHERE e MATCH ? AND k = 2 UNION SELECT rowid FROM u WHERE f MATCH ? AND k = 2",
]


@pytest.mark.parametrize("sql", UNSUPPORTED, ids=range(len(UNSUPPORTED)))
def test_unsupported_statement_raises_like_jax(dbs, data, sql, no_jax_writes):
    db, ref = dbs
    params = [data["q"][0].tobytes(), data["u"][0].tobytes()][: sql.count("?")]
    errs = []
    for d_ in (db, ref):
        with pytest.raises(Exception) as info:
            d_.execute(sql, list(params))
        errs.append(type(info.value).__name__)
    assert errs[0] == errs[1]
    if sql.startswith(("INSERT", "REPLACE", "ALTER")):
        assert errs[0] == "InvalidParameter"


def test_rebuild_validation_raises_like_jax(dbs, no_jax_writes):
    """vec_rebuild_hnsw's bounds on M and ef_construction, checked before
    any build."""
    db, ref = dbs
    for args in ("'t', 'e', 1, 32", "'t', 'e', 8, 5000", "'t', 'nope'", "'t'", "'zz', 'e'"):
        errs = []
        for d_ in (db, ref):
            with pytest.raises(Exception) as info:
                d_.execute(f"SELECT vec_rebuild_hnsw({args})")
            errs.append(type(info.value).__name__)
        assert errs[0] == errs[1], args


# ---------------------------------------------------------------------------
# writes and transactions: tests/test_txn.py's cases, and the calls each
# engine makes of its tables
# ---------------------------------------------------------------------------


def _port_value(v):
    """A value a SQL engine hands its table, in the port's types."""
    if isinstance(v, jax_codec.Vector):
        return Vector(VectorType(v.vec_type.value), v.dimensions, v.data)
    if isinstance(v, dict):
        return {k: _port_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_port_value(x) for x in v)
    return v


def _neutral(v):
    """A call's argument or result in a form both packages' values compare in."""
    if isinstance(v, (Vector, jax_codec.Vector)):
        return ("vector", v.vec_type.value, v.dimensions, v.data)
    if isinstance(v, dict):
        return {k: _neutral(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_neutral(x) for x in v]
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    return v


def _port_spec(c):
    """A column declaration (the port's or the JAX package's) as the port's."""
    if isinstance(c, ColumnSpec):
        return c
    f = _spec_fields(c)
    return ColumnSpec(**dict(
        f, vec_type=None if f["vec_type"] is None else VectorType(f["vec_type"]),
        metric=DistanceMetric(f["metric"]), quantization=IndexQuantization(f["quantization"]),
        params=None if f["params"] is None else HnswParams(**f["params"])))


class _Recorded:
    """A port VecTable(device="cpu") standing in for a SQL engine's
    VecTable: the engine's calls of it (writes, flushes, rebuilds and KNN
    reads) are logged in the neutral form with what they returned, the
    values it hands in are taken in the port's types, and rows go back in
    the engine's own."""

    def __init__(self, log, vector_cls, name, columns, *, index_type, initial_cap, **_):
        self._log, self._vector = log, vector_cls
        log.append(("create", name, [_spec_fields(c) for c in columns], index_type.value, initial_cap))
        self._t = VecTable(name, [_port_spec(c) for c in columns], index_type=IndexType(index_type.value),
                           initial_cap=initial_cap, device="cpu")

    def __getattr__(self, name):
        return getattr(self._t, name)

    def __len__(self):
        return len(self._t)

    def _call(self, name, *args, **kw):
        out = getattr(self._t, name)(*_port_value(args), **_port_value(kw))
        result = [(r.rowid, r.distance) for r in out] if name == "knn" else out
        self._log.append((name, _neutral(args), _neutral(kw), result))
        return out

    def insert(self, values, rowid=None):
        return self._call("insert", values, rowid=rowid)

    def delete(self, rowid):
        return self._call("delete", rowid)

    def delete_many(self, rowids):
        return self._call("delete_many", rowids)

    def update(self, rowid, values):
        return self._call("update", rowid, values)

    def update_many(self, rowids, values):
        return self._call("update_many", rowids, values)

    def flush(self):
        return self._call("flush")

    def rebuild(self, column, params=None):
        return self._call("rebuild", column, params=params)

    def knn(self, column, query, **kw):
        return self._call("knn", column, query, **kw)

    def row(self, rowid):
        def engine(v):
            if isinstance(v, Vector) and self._vector is not Vector:
                return self._vector(jax_types.VectorType(v.vec_type.value), v.dimensions, v.data)
            return v

        return {k: engine(v) for k, v in self._t.row(rowid).items()}


class _Engine:
    """One SQL engine (``package`` "port" or "jax") whose tables are
    recorded port tables: its Database ``db``, its error classes ``E`` and
    the log of its tables' calls."""

    def __init__(self, monkeypatch, package):
        self.log = []
        if package == "jax":
            module, self.E, vector_cls = jax_engine, jax_types, jax_codec.Vector
        else:
            module, self.E, vector_cls = port_engine, port_types, Vector
        monkeypatch.setattr(module, "VecTable", functools.partial(_Recorded, self.log, vector_cls))
        self.db = jax_connect() if package == "jax" else connect(device="cpu")


def _same_table(got, want):
    """Two port tables equal field for field: host state, scalars, raw,
    config and every graph field."""
    got, want = getattr(got, "_t", got), getattr(want, "_t", want)
    assert got._rowid_to_slot == want._rowid_to_slot and got._slot_to_rowid == want._slot_to_rowid
    assert (got._max_rowid, got._next_slot, got._free_slots, got.cap, len(got._pending)) == (
        want._max_rowid, want._next_slot, want._free_slots, want.cap, len(want._pending))
    np.testing.assert_array_equal(got._live, want._live)
    for name, sc in want._scalars.items():
        assert [got._scalars[name].get(s) for s in range(want.cap)] == [sc.get(s) for s in range(want.cap)]
    for cname, wc in want.vector_cols.items():
        vc = got.vector_cols[cname]
        assert vc.config == wc.config and vc.params == wc.params
        np.testing.assert_array_equal(vc.raw, wc.raw)
        for f in snapshot._GRAPH_FIELDS:
            assert torch.equal(getattr(vc.state, f), getattr(wc.state, f)), (cname, f)


def _same_engines(port, ref):
    """The port's engine made the JAX engine's calls of its tables, in the
    same order with the same arguments and results, and its tables came
    out equal to the JAX engine's."""
    assert len(port.log) == len(ref.log), ([e[0] for e in port.log], [e[0] for e in ref.log])
    for j, (a, b) in enumerate(zip(port.log, ref.log)):
        assert a == b, (j, a[0], b[0])
    assert sorted(port.db.tables) == sorted(ref.db.tables)
    for name in ref.db.tables:
        _same_table(port.db.tables[name], ref.db.tables[name])


def mk(db, name="t", dim=8):
    db.execute(f"CREATE VIRTUAL TABLE {name} USING vec0(e float[{dim}] hnsw(M=4, ef_construction=16))")


def vec(i, dim=8):
    rng = np.random.RandomState(i)
    return rng.randn(dim).astype(np.float32).tobytes()


def count(db, name="t"):
    return db.execute(f"SELECT COUNT(*) FROM {name}").fetchone()[0]


def cpu():
    return connect(device="cpu")


# tests/test_txn.py's cases, each on a Database ``db`` whose errors are
# those of ``E`` (the port's types or the JAX package's)


def _insert_batch_commits(db, E):
    mk(db)
    db.execute("BEGIN")
    for i in range(1, 101):
        db.execute("INSERT INTO t(rowid, e) VALUES (?, ?)", [i, vec(i)])
    # the flush waits for COMMIT
    assert len(db.table("t")._pending) == 100
    db.execute("COMMIT")
    assert len(db.table("t")._pending) == 0
    assert count(db) == 100


def _txn_keyword_variants(db, E):
    mk(db)
    db.execute("BEGIN TRANSACTION")
    db.execute("INSERT INTO t(rowid, e) VALUES (1, ?)", [vec(1)])
    db.execute("END TRANSACTION;")
    assert count(db) == 1
    db.execute("BEGIN IMMEDIATE")
    db.execute("DELETE FROM t WHERE rowid = 1")
    db.execute("COMMIT;")
    assert count(db) == 0


def _read_your_writes_inside_txn(db, E):
    mk(db)
    db.execute("BEGIN")
    db.execute("INSERT INTO t(rowid, e) VALUES (7, ?)", [vec(7)])
    rows = db.execute("SELECT rowid, distance FROM t WHERE e MATCH ? AND k = 1", [vec(7)]).fetchall()
    assert rows[0][0] == 7
    db.execute("COMMIT")


def _insert_rolls_back(db, E):
    mk(db)
    db.execute("INSERT INTO t(rowid, e) VALUES (1, ?)", [vec(1)])
    db.execute("BEGIN")
    db.execute("INSERT INTO t(rowid, e) VALUES (2, ?)", [vec(2)])
    db.execute("INSERT INTO t(rowid, e) VALUES (3, ?)", [vec(3)])
    assert count(db) == 3
    db.execute("ROLLBACK")
    assert count(db) == 1
    assert [r[0] for r in db.execute("SELECT rowid FROM t")] == [1]
    # the graph no longer returns the rolled-back rows
    rows = db.execute("SELECT rowid FROM t WHERE e MATCH ? AND k = 3", [vec(2)]).fetchall()
    assert [r[0] for r in rows] == [1]


def _delete_rolls_back_with_original_vector(db, E):
    mk(db)
    for i in range(1, 6):
        db.execute("INSERT INTO t(rowid, e) VALUES (?, ?)", [i, vec(i)])
    db.execute("BEGIN")
    db.execute("DELETE FROM t WHERE rowid IN (2, 4)")
    assert count(db) == 3
    db.execute("ROLLBACK")
    assert count(db) == 5
    # the restored row is still nearest to its own vector
    rows = db.execute("SELECT rowid, distance FROM t WHERE e MATCH ? AND k = 1", [vec(4)]).fetchall()
    assert rows[0][0] == 4 and rows[0][1] < 1e-5


def _update_rolls_back_to_before_image(db, E):
    mk(db)
    db.execute("INSERT INTO t(rowid, e) VALUES (1, ?)", [vec(1)])
    db.execute("BEGIN")
    db.execute("UPDATE t SET e = ? WHERE rowid = 1", [vec(99)])
    db.execute("ROLLBACK")
    got = db.table("t").row(1)["e"].to_numpy()
    want = np.frombuffer(vec(1), dtype=np.float32)
    np.testing.assert_array_equal(got, want)


def _create_and_drop_roll_back(db, E):
    mk(db, "keep")
    db.execute("INSERT INTO keep(rowid, e) VALUES (1, ?)", [vec(1)])
    db.execute("BEGIN")
    mk(db, "fresh")
    db.execute("DROP TABLE keep")
    assert "fresh" in db.tables and "keep" not in db.tables
    db.execute("ROLLBACK")
    assert "fresh" not in db.tables
    assert count(db, "keep") == 1


def _metadata_filter_delete_rolls_back(db, E):
    db.execute("CREATE VIRTUAL TABLE t USING vec0(e float[8] hnsw(M=4, ef_construction=16), tag TEXT)")
    for i in range(1, 7):
        db.execute("INSERT INTO t(rowid, e, tag) VALUES (?, ?, ?)", [i, vec(i), "a" if i % 2 else "b"])
    db.execute("BEGIN")
    db.execute("DELETE FROM t WHERE tag = 'b'")  # composed WHERE
    assert count(db) == 3
    db.execute("ROLLBACK")
    assert count(db) == 6
    assert db.execute("SELECT COUNT(*) FROM t WHERE tag = 'b'").fetchone()[0] == 3


def _plain_sql_table_rolls_back_too(db, E):
    db.execute("CREATE TABLE meta (k TEXT, v TEXT)")
    db.execute("BEGIN")
    db.execute("INSERT INTO meta VALUES ('a', '1')")
    db.execute("ROLLBACK")
    assert db.execute("SELECT COUNT(*) FROM meta").fetchone()[0] == 0


def _nested_begin(db, E):
    db.execute("BEGIN")
    with pytest.raises(E.InvalidState):
        db.execute("BEGIN")
    db.execute("ROLLBACK")


def _commit_without_begin(db, E):
    with pytest.raises(E.InvalidState):
        db.execute("COMMIT")


def _rollback_without_begin(db, E):
    with pytest.raises(E.InvalidState):
        db.execute("ROLLBACK")


TXN_CASES = {f.__name__[1:]: f for f in (
    _insert_batch_commits, _txn_keyword_variants, _read_your_writes_inside_txn, _insert_rolls_back,
    _delete_rolls_back_with_original_vector, _update_rolls_back_to_before_image, _create_and_drop_roll_back,
    _metadata_filter_delete_rolls_back, _plain_sql_table_rolls_back_too, _nested_begin,
    _commit_without_begin, _rollback_without_begin)}


class TestCommit:
    def test_insert_batch_commits(self):
        _insert_batch_commits(cpu(), port_types)

    def test_txn_keyword_variants(self):
        _txn_keyword_variants(cpu(), port_types)

    def test_read_your_writes_inside_txn(self):
        _read_your_writes_inside_txn(cpu(), port_types)


class TestRollback:
    def test_insert_rolls_back(self):
        _insert_rolls_back(cpu(), port_types)

    def test_delete_rolls_back_with_original_vector(self):
        _delete_rolls_back_with_original_vector(cpu(), port_types)

    def test_update_rolls_back_to_before_image(self):
        _update_rolls_back_to_before_image(cpu(), port_types)

    def test_create_and_drop_roll_back(self):
        _create_and_drop_roll_back(cpu(), port_types)

    def test_metadata_filter_delete_rolls_back(self):
        _metadata_filter_delete_rolls_back(cpu(), port_types)

    def test_plain_sql_table_rolls_back_too(self):
        _plain_sql_table_rolls_back_too(cpu(), port_types)


class TestErrors:
    def test_nested_begin(self):
        _nested_begin(cpu(), port_types)

    def test_commit_without_begin(self):
        _commit_without_begin(cpu(), port_types)

    def test_rollback_without_begin(self):
        _rollback_without_begin(cpu(), port_types)


@pytest.mark.parametrize("case", TXN_CASES)
def test_txn_case_makes_the_jax_engines_calls(case, monkeypatch, no_jax_writes):
    """Each case through the port's engine and through the JAX engine,
    each over recorded port tables: both pass the case's assertions, the
    port's makes the calls of its tables that the JAX engine makes (no
    JAX insert, flush or build runs) and leaves equal tables."""
    port, ref = _Engine(monkeypatch, "port"), _Engine(monkeypatch, "jax")
    for eng in (port, ref):
        TXN_CASES[case](eng.db, eng.E)
    _same_engines(port, ref)


# ---------------------------------------------------------------------------
# a write script through both engines
# ---------------------------------------------------------------------------


W_DDL = ("CREATE VIRTUAL TABLE w USING vec0(e float[32] hnsw(M=6, ef_construction=32, ef_search=24, "
         "distance=l2), tag TEXT, +aux TEXT)")


def _run_sql(x, db):
    db.execute(W_DDL)
    db.execute("INSERT INTO w(rowid, e, tag, aux) VALUES (?, ?, ?, ?)", [5, x[0].tobytes(), "a", "x0"])
    db.execute("INSERT INTO w(e, tag, aux) VALUES (?, 'b', 'x1')", [x[1].tobytes()])
    db.executemany("INSERT INTO w(rowid, e, tag, aux) VALUES (?, ?, ?, ?)",
                   [[10 + i, x[i].tobytes(), "ab"[i % 2], f"x{i}"] for i in range(2, 70)])
    db.execute("DELETE FROM w WHERE rowid = ?", [13])
    db.execute("DELETE FROM w WHERE rowid IN (20, 21, 40)")
    db.execute("DELETE FROM w WHERE tag = 'b' AND rowid > 60")
    db.execute("UPDATE w SET e = ?, tag = 'c' WHERE rowid = 30", [x[70].tobytes()])
    db.execute("UPDATE w SET aux = ? WHERE rowid = 5", ["changed"])
    db.execute("UPDATE w SET tag = 'f' WHERE aux = 'x6' OR rowid = 18")
    db.execute("BEGIN")
    db.execute("INSERT INTO w(rowid, e, tag, aux) VALUES (?, ?, ?, ?)", [100, x[71].tobytes(), "d", "x71"])
    db.execute("DELETE FROM w WHERE rowid = 31")
    db.execute("UPDATE w SET e = ? WHERE rowid = 32", [x[72].tobytes()])
    db.execute("UPDATE w SET aux = vec_to_json(vec_f32(?)) WHERE tag = 'a' AND rowid < 20", ["[1, 2]"])
    db.execute("ROLLBACK")
    db.execute("BEGIN")
    db.executemany("INSERT INTO w(rowid, e, tag, aux) VALUES (?, ?, ?, ?)",
                   [[200 + i, x[i].tobytes(), "e", f"x{i}"] for i in range(73, 80)])
    db.execute("COMMIT")
    assert db.execute("SELECT vec_rebuild_hnsw('w', 'e', 8, 40)").fetchall() == [("ok",)]
    db.execute("DELETE FROM w WHERE rowid = 12")
    return db


def test_write_script_equals_vectable_calls(monkeypatch, no_jax_writes):
    """The write script through the port's engine and through the JAX
    engine, each over recorded port tables: the port's makes the JAX
    engine's calls of the table in the same order (inserts, deletes by
    rowid and by WHERE, updates, flushes, the rollback's undo log, the
    rebuild), with no JAX insert, flush or build, and the two tables are
    equal field for field after it."""
    x = synthetic_embeddings(80, 32, intrinsic_dim=12, n_clusters=8, seed=31)
    port, ref = _Engine(monkeypatch, "port"), _Engine(monkeypatch, "jax")
    for eng in (port, ref):
        _run_sql(x, eng.db)
    _same_engines(port, ref)
    kinds = {entry[0] for entry in ref.log}
    assert kinds == {"create", "insert", "delete", "delete_many", "update", "update_many", "flush", "rebuild"}
    got = port.db.table("w")
    assert got.integrity_check() == [] and len(got) == 62
    assert got.row(32)["e"].as_bytes() == x[32 - 10].tobytes() and 100 not in got._rowid_to_slot
    assert got.row(16)["tag"] == got.row(18)["tag"] == "f" and (got.row(14)["aux"], got.row(5)["aux"]) == ("x4", "changed")
    assert got.vector_cols["e"].params.m == 8


def test_executemany_defers_the_flush(monkeypatch):
    """executemany flushes once at the end of the batch (and the table's
    own threshold of 256 pending rows), not after each row."""
    db = cpu()
    mk(db)
    flushes = []
    real = VecTable.flush
    monkeypatch.setattr(VecTable, "flush", lambda self: (flushes.append(len(self._pending)), real(self))[1])
    db.executemany("INSERT INTO t(rowid, e) VALUES (?, ?)", [[i, vec(i)] for i in range(1, 41)])
    assert [f for f in flushes if f] == [40] and count(db) == 40
    flushes.clear()
    db.execute("INSERT INTO t(rowid, e) VALUES (?, ?)", [41, vec(41)])
    assert [f for f in flushes if f] == [1]


def test_create_if_not_exists_and_capacity():
    db = cpu()
    db.execute("CREATE VIRTUAL TABLE c USING vec0(v float[4] hnsw(M=4), capacity=2000)")
    assert db.table("c").cap >= 2000 and db.table("c").device.type == "cpu"
    db.execute("CREATE VIRTUAL TABLE IF NOT EXISTS c USING vec0(v float[4])")
    with pytest.raises(InvalidState):
        db.execute("CREATE VIRTUAL TABLE c USING vec0(v float[4])")
    with pytest.raises(InvalidParameter):
        db.execute("SELECT vec_rebuild_hnsw('c', 'v', 1, 32)")


# ---------------------------------------------------------------------------
# device and mesh
# ---------------------------------------------------------------------------


def test_connect_defaults_to_the_card():
    """connect() puts its tables on the card: without one it raises, as
    VecTable does; device="cpu" is the caller's choice."""
    if torch.cuda.is_available():
        assert connect().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            connect()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Database()
    assert Database(device="cpu").device.type == "cpu"


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        Database(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        connect(mesh=object(), device="cpu")
