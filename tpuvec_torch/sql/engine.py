"""Database facade: the vec0 SQL surface over the port's VecTable. The
port's own copy of ``tpuvec/sql/engine.py``, statement for statement.

The stdlib ``sqlite3`` module cannot host virtual tables, so the engine is
a hybrid, as in the JAX package:

* a real in-process SQLite connection carries all ordinary SQL, with every
  vec_* scalar function registered on it (tpuvec_torch.sql.functions);
* statements that touch a vec0 table (CREATE VIRTUAL TABLE ... USING vec0,
  INSERT/UPDATE/DELETE/SELECT on it) are parsed by a mini-planner and run
  against VecTable state on the device: KNN is ``WHERE col MATCH ? AND
  k = ?`` (with ``ef``, ``coarse_k``, ``expand`` and equality filters)
  ordered by the hidden ``distance`` column; everything else is a full
  scan or a rowid lookup;
* anything else (joins, subqueries, aggregates, GROUP BY, arbitrary WHERE
  predicates, expression projections) composes through a MIRROR fallback:
  the referenced vec0 tables are materialized into the SQLite connection
  (vectors as JSON text), a ``col MATCH ? AND k = ?`` clause runs on the
  device first and its (rowid, distance) rows become the mirror, and
  SQLite's own planner runs the statement;
* BEGIN / COMMIT / ROLLBACK keep an undo log over the vec0 writes and a
  real transaction on the SQLite connection; vec0 writes inside a
  transaction defer their flush to COMMIT, and ``executemany`` defers it
  to the end of the batch.

``vec_rebuild_hnsw(table, col[, M, ef_construction])`` rebuilds one
column's graph; ``Database.integrity_check`` checks a table. Every vec0
table of a Database lives on its ``device``. As in the JAX package, a
file-backed Database keeps only its plain SQLite tables across a reopen:
the vec0 tables live in memory.
"""

from __future__ import annotations

import re
import sqlite3
from typing import Any, Sequence

import torch

from tpuvec_torch.codec import Vector
from tpuvec_torch.device import resolve
from tpuvec_torch.sql import functions as F
from tpuvec_torch.sql.ddl import parse_create_vtab
from tpuvec_torch.store.table import VecTable
from tpuvec_torch.types import (
    InvalidParameter,
    InvalidState,
)

__all__ = ["Database", "connect", "Cursor"]


def connect(
    path: str = ":memory:", mesh=None, *, device: str | torch.device = "cuda"
) -> "Database":
    return Database(path, mesh=mesh, device=device)


class Cursor:
    """Minimal DB-API-ish cursor for planner results."""

    def __init__(self, rows: list[tuple], description: list[str]):
        self._rows = rows
        self.description = [(n, None, None, None, None, None, None) for n in description]

    def fetchall(self) -> list[tuple]:
        return list(self._rows)

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def __iter__(self):
        return iter(self._rows)


_INSERT_RE = re.compile(
    r"^\s*INSERT\s+INTO\s+(?P<name>[\w\"]+)\s*\((?P<cols>[^)]*)\)\s*"
    r"VALUES\s*(?P<values>\(.*\))\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_DELETE_RE = re.compile(
    r"^\s*DELETE\s+FROM\s+(?P<name>[\w\"]+)\s+WHERE\s+rowid\s*(?:=\s*(?P<rid>\?|\d+)|IN\s*\((?P<rids>[^)]*)\))\s*;?\s*$",
    re.IGNORECASE,
)
_UPDATE_RE = re.compile(
    r"^\s*UPDATE\s+(?P<name>[\w\"]+)\s+SET\s+(?P<sets>.+?)\s+WHERE\s+rowid\s*=\s*(?P<rid>\?|\d+)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_DROP_RE = re.compile(
    r"^\s*DROP\s+TABLE\s+(?:IF\s+EXISTS\s+)?(?P<name>[\w\"]+)\s*;?\s*$", re.IGNORECASE
)
_SELECT_RE = re.compile(
    r"^\s*SELECT\s+(?P<cols>.+?)\s+FROM\s+(?P<name>[\w\"]+)"
    r"(?:\s+WHERE\s+(?P<where>.+?))?"
    r"(?:\s+ORDER\s+BY\s+(?P<order>[\w\s,\"]+?))?"
    r"(?:\s+LIMIT\s+(?P<limit>\?|\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_MATCH_RE = re.compile(r"(?P<col>[\w\"]+)\s+MATCH\s+(?P<val>\?|'[^']*')", re.IGNORECASE)
_K_RE = re.compile(r"\bk\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE)
_EF_RE = re.compile(r"\bef\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE)
_COARSE_RE = re.compile(r"\bcoarse_k\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE)
_EXPAND_RE = re.compile(r"\bexpand\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE)
_EQ_RE = re.compile(r"(?P<col>[\w\"]+)\s*=\s*(?P<val>\?|'[^']*'|-?\d+(?:\.\d+)?)")
_REBUILD_RE = re.compile(
    r"^\s*SELECT\s+vec_rebuild_hnsw\s*\((?P<args>.*)\)\s*;?\s*$", re.IGNORECASE
)
_TXN_RE = re.compile(
    r"^\s*(?P<verb>BEGIN|COMMIT|END|ROLLBACK)"
    r"(?:\s+(?:DEFERRED|IMMEDIATE|EXCLUSIVE))?"
    r"(?:\s+TRANSACTION)?\s*;?\s*$",
    re.IGNORECASE,
)

# -- composability-fallback grammar (mirror path) ----------------------- #
_FB_MATCH_RE = re.compile(
    r"(?:(?P<qual>[\w\"]+)\s*\.\s*)?(?P<col>[\w\"]+)\s+MATCH\s+"
    r"(?P<val>\?|'[^']*'|[xX]'[0-9a-fA-F]*'|vec_\w+\s*\([^()]*\))",
    re.IGNORECASE,
)
_FB_KNOB_RES = {
    "k": re.compile(
        r"(?:\b\w+\s*\.\s*)?\bk\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE
    ),
    "ef": re.compile(
        r"(?:\b\w+\s*\.\s*)?\bef\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE
    ),
    "coarse_k": re.compile(
        r"(?:\b\w+\s*\.\s*)?\bcoarse_k\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE
    ),
    "expand": re.compile(
        r"(?:\b\w+\s*\.\s*)?\bexpand\s*=\s*(?P<val>\?|\d+)", re.IGNORECASE
    ),
}
_FB_DELETE_RE = re.compile(
    r"^\s*DELETE\s+FROM\s+(?P<name>[\w\"]+)"
    r"(?:\s+WHERE\s+(?P<where>.+?))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_FB_UPDATE_RE = re.compile(
    r"^\s*UPDATE\s+(?P<name>[\w\"]+)\s+SET\s+(?P<sets>.+?)"
    r"(?:\s+WHERE\s+(?P<where>.+?))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_SQL_KEYWORDS = frozenset(
    "WHERE JOIN ON GROUP ORDER LIMIT LEFT RIGHT INNER OUTER CROSS AS USING"
    " NATURAL SET HAVING UNION EXCEPT INTERSECT AND OR NOT MATCH".split()
)


class _Unsupported(Exception):
    """Internal: the mini-planner can't run this statement shape — route
    it to the SQLite-mirror composability fallback."""


def _qmark_positions(sql: str) -> list[int]:
    """Positions of bind-parameter '?' tokens outside string literals."""
    out, in_str = [], False
    for i, ch in enumerate(sql):
        if ch == "'":
            in_str = not in_str
        elif ch == "?" and not in_str:
            out.append(i)
    return out


class Database:
    """A connection-like object holding vec0 tables plus a real SQLite
    connection for everything else."""

    def __init__(
        self,
        path: str = ":memory:",
        mesh=None,
        *,
        device: str | torch.device = "cuda",
    ):
        """``device``: where every vec0 table created on this connection
        keeps its tensors (default ``"cuda"``; without a card this raises,
        as ``VecTable`` does; pass ``"cpu"`` to run on the CPU).
        ``mesh``: mesh-backed tables are not ported yet and raise
        ``NotImplementedError``."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh-backed databases are not ported yet (parallel/sharding.py; "
                "ROADMAP.md, queue 1, item 4)"
            )
        self.device = resolve(device)
        # autocommit (rusqlite's default): explicit BEGIN/COMMIT/ROLLBACK
        # are owned by this engine, not the stdlib module's implicit-txn
        # machinery
        self.sqlite = sqlite3.connect(path, isolation_level=None)
        F.register_all(self.sqlite)
        self.tables: dict[str, VecTable] = {}
        self.mesh = mesh
        self._autoflush = True  # executemany defers flush to batch end
        # open-transaction undo log (None = autocommit). Each entry is an
        # inverse op applied in reverse order on ROLLBACK — the engine's
        # analogue of the reference riding SQLite's journal for its
        # shadow tables (src/shadow.rs:192-257): vec0 writes inside
        # BEGIN..COMMIT are atomic w.r.t. ROLLBACK, and flushes defer to
        # COMMIT so a bulk txn batches like the reference's C benchmark
        # (tests/test_transaction_batching.rs:28-55).
        self._txn: list[tuple] | None = None
        # composability-fallback mirror cache: table name -> (version,
        # with_distance) of the temp-schema copy living in self.sqlite
        self._mirrors: dict[str, tuple | None] = {}

    # -------------------------------------------------------------- #

    def close(self) -> None:
        self.sqlite.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def table(self, name: str) -> VecTable:
        if name not in self.tables:
            raise InvalidState(f"no vec0 table named '{name}'")
        return self.tables[name]

    def integrity_check(self, name: str) -> list[str]:
        return self.table(name).integrity_check()

    # -------------------------------------------------------------- #

    def execute(self, sql: str, params: Sequence[Any] = ()) -> Cursor:
        params = list(params)

        m = _TXN_RE.match(sql)
        if m:
            verb = m.group("verb").upper()
            if verb == "BEGIN":
                return self._begin()
            if verb == "ROLLBACK":
                return self._rollback()
            return self._commit()  # COMMIT | END

        created = parse_create_vtab(sql)
        if created is not None:
            name, columns, index_type, options = created
            if name in self.tables:
                if re.search(r"IF\s+NOT\s+EXISTS", sql, re.IGNORECASE):
                    return Cursor([], [])
                raise InvalidState(f"table '{name}' already exists")
            self.tables[name] = VecTable(
                name,
                columns,
                index_type=index_type,
                initial_cap=options.get("capacity", 1024),
                device=self.device,
            )
            self._record("create", name)
            return Cursor([], [])

        m = _REBUILD_RE.match(sql)
        if m:
            return self._rebuild(m.group("args"), params)

        m = _DROP_RE.match(sql)
        if m and m.group("name").strip('"') in self.tables:
            name = m.group("name").strip('"')
            self._record("drop", name, self.tables[name])
            del self.tables[name]
            self._mirrors.pop(name, None)
            self.sqlite.execute(f'DROP TABLE IF EXISTS temp."{name}"')
            return Cursor([], [])

        m = _INSERT_RE.match(sql)
        if m and m.group("name").strip('"') in self.tables:
            return self._insert(m, params)

        m = _DELETE_RE.match(sql)
        if m and m.group("name").strip('"') in self.tables:
            return self._delete(m, params)

        m = _UPDATE_RE.match(sql)
        if m and m.group("name").strip('"') in self.tables:
            return self._update(m, params)

        m = _SELECT_RE.match(sql)
        if m and m.group("name").strip('"') in self.tables:
            try:
                return self._select(m, list(params))
            except _Unsupported:
                pass  # single-table, but a shape only SQLite can run

        # A statement that references a vec0 table but matched no planner
        # shape composes through the SQLite mirror: materialize the vec0
        # tables (and any MATCH KNN result) into the real connection and
        # let SQLite's planner run the statement — the same division of
        # labor as the reference's vtab (best_index handles MATCH+k,
        # SQLite handles everything else, src/vtab.rs:964-1028).
        referenced = [
            t
            for t in self.tables
            if re.search(rf"(?<!\w){re.escape(t)}(?!\w)", sql)
        ]
        if referenced:
            if re.match(r"^\s*(SELECT|WITH)\b", sql, re.IGNORECASE):
                return self._compose_select(sql, list(params), referenced)
            dm = _FB_DELETE_RE.match(sql)
            if dm and dm.group("name").strip('"') in self.tables:
                return self._compose_delete(dm, list(params))
            um = _FB_UPDATE_RE.match(sql)
            if um and um.group("name").strip('"') in self.tables:
                return self._compose_update(um, list(params))
            raise InvalidParameter(
                f"unsupported statement for vec0 table '{referenced[0]}': "
                "supported are CREATE VIRTUAL TABLE / INSERT ... VALUES / "
                "UPDATE / DELETE / SELECT (arbitrary read-only SQL incl. "
                "joins + MATCH KNN) / DROP / vec_rebuild_hnsw — got: "
                f"{sql.strip()[:200]}"
            )

        cur = self.sqlite.execute(sql, params)
        desc = [d[0] for d in cur.description] if cur.description else []
        return Cursor(cur.fetchall(), desc)

    def executemany(self, sql: str, seq_of_params) -> Cursor:
        """Execute the same statement for every parameter row (DB-API).

        vec0 inserts defer the device flush to the end of the batch, so a
        bulk load executes like insert_many (one batched device dispatch
        per shape) instead of one flush per row."""
        last = Cursor([], [])
        self._autoflush = False
        try:
            for p in seq_of_params:
                last = self.execute(sql, p)
        finally:
            self._autoflush = True
            for t in self.tables.values():
                t.flush()
        return last

    # ------------------------------------------------------------------ #
    # transactions (reference: SQLite's journal covers the vtab's shadow
    # tables for free — src/shadow.rs:192-257, tests/test_transaction_
    # batching.rs. Here: an undo log over VecTable mutations + a real
    # BEGIN on the mirror connection for plain-SQL side tables.)
    # ------------------------------------------------------------------ #

    def _begin(self) -> Cursor:
        if self._txn is not None:
            raise InvalidState(
                "cannot start a transaction within a transaction"
            )
        self._txn = []
        self.sqlite.execute("BEGIN")
        return Cursor([], [])

    def _commit(self) -> Cursor:
        if self._txn is None:
            raise InvalidState("cannot commit - no transaction is active")
        self._txn = None
        for t in self.tables.values():
            t.flush()
        self.sqlite.execute("COMMIT")
        return Cursor([], [])

    def _rollback(self) -> Cursor:
        if self._txn is None:
            raise InvalidState("cannot rollback - no transaction is active")
        log, self._txn = self._txn, None  # undo ops must not re-record
        for entry in reversed(log):
            kind = entry[0]
            if kind == "insert":
                _, table, rid = entry
                table.delete(rid)
            elif kind == "delete":
                _, table, rid, row = entry
                table.insert(row, rowid=rid)
            elif kind == "update":
                _, table, rid, row = entry
                table.update(rid, row)
            elif kind == "create":
                _, name = entry
                self.tables.pop(name, None)
                self._mirrors.pop(name, None)
                self.sqlite.execute(f'DROP TABLE IF EXISTS temp."{name}"')
            elif kind == "drop":
                _, name, table = entry
                self.tables[name] = table
        for t in self.tables.values():
            t.flush()
        # temp-schema mirrors roll back with the connection; drop the
        # cache keys so the next composed query re-materializes
        self._mirrors.clear()
        self.sqlite.execute("ROLLBACK")
        return Cursor([], [])

    def _record(self, *entry) -> None:
        """Append one inverse-op entry to the open transaction, if any."""
        if self._txn is not None:
            self._txn.append(entry)

    def _snap_rows(self, table: VecTable, rids, kind: str) -> None:
        """Record before-images so ROLLBACK can restore deleted/updated
        rows (originals live host-side, so this is cheap array reads)."""
        if self._txn is not None:
            for rid in rids:
                self._txn.append((kind, table, int(rid), table.row(rid)))

    # -------------------------------------------------------------- #

    @staticmethod
    def _take_param(token: str, params: list):
        if token == "?":
            if not params:
                raise InvalidParameter("not enough bind parameters")
            return params.pop(0)
        if token.startswith("'"):
            return token[1:-1]
        try:
            return int(token)
        except ValueError:
            return float(token)

    def _split_value_rows(self, values: str) -> list[str]:
        rows, depth, cur = [], 0, []
        for ch in values:
            if ch == "(":
                depth += 1
                if depth == 1:
                    cur = []
                    continue
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    rows.append("".join(cur))
                    continue
            if depth >= 1:
                cur.append(ch)
        return rows

    def _split_exprs(self, row: str) -> list[str]:
        out, depth, cur, in_str = [], 0, [], False
        for ch in row:
            if ch == "'":
                in_str = not in_str
            elif not in_str:
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                elif ch == "," and depth == 0:
                    out.append("".join(cur).strip())
                    cur = []
                    continue
            cur.append(ch)
        out.append("".join(cur).strip())
        return out

    def _eval_expr(self, expr: str, params: list):
        """Evaluate a VALUES expression: ?, literal, or vec_*(...) call."""
        expr = expr.strip()
        if expr == "?":
            return self._take_param("?", params)
        if expr.upper() == "NULL":
            return None
        call = re.match(r"^(vec_\w+)\s*\((.*)\)$", expr, re.DOTALL)
        if call:
            fn = getattr(F, call.group(1), None)
            if fn is None:
                raise InvalidParameter(f"unknown function {call.group(1)}")
            args = [self._eval_expr(a, params) for a in self._split_exprs(call.group(2))]
            return fn(*args)
        if expr.startswith("'"):
            return expr[1:-1]
        if expr.startswith("[") or expr.startswith("x'"):
            if expr.startswith("x'"):
                return bytes.fromhex(expr[2:-1])
            return expr  # JSON text vector
        try:
            return int(expr)
        except ValueError:
            return float(expr)

    def _insert(self, m, params: list) -> Cursor:
        table = self.table(m.group("name").strip('"'))
        cols = [c.strip().strip('"') for c in m.group("cols").split(",")]
        for row in self._split_value_rows(m.group("values")):
            exprs = self._split_exprs(row)
            if len(exprs) != len(cols):
                raise InvalidParameter("column/value count mismatch")
            values = {}
            rowid = None
            for c, e in zip(cols, exprs):
                v = self._eval_expr(e, params)
                if c.lower() == "rowid":
                    rowid = int(v)
                else:
                    values[c] = v
            rid = table.insert(values, rowid=rowid)
            self._record("insert", table, rid)
        if self._autoflush and self._txn is None:
            table.flush()
        return Cursor([], [])

    def _delete(self, m, params: list) -> Cursor:
        table = self.table(m.group("name").strip('"'))
        if m.group("rid") is not None:
            rid = int(self._take_param(m.group("rid"), params))
            self._snap_rows(table, [rid], "delete")
            table.delete(rid)
        else:
            rids = [
                int(self._take_param(t.strip(), params))
                for t in m.group("rids").split(",")
            ]
            self._snap_rows(table, rids, "delete")
            table.delete_many(rids)
        return Cursor([], [])

    def _update(self, m, params: list) -> Cursor:
        table = self.table(m.group("name").strip('"'))
        sets = {}
        for part in self._split_exprs(m.group("sets")):
            k, v = part.split("=", 1)
            sets[k.strip().strip('"')] = self._eval_expr(v.strip(), params)
        rid = int(self._take_param(m.group("rid"), params))
        self._snap_rows(table, [rid], "update")
        table.update(rid, sets)
        return Cursor([], [])

    def _select(self, m, params: list) -> Cursor:
        table = self.table(m.group("name").strip('"'))
        where = m.group("where") or ""
        cols_expr = m.group("cols").strip()
        limit = m.group("limit")
        order = (m.group("order") or "").strip()
        match = _MATCH_RE.search(where)
        # ORDER BY the planner can honor: `distance [ASC]` on a KNN result
        # and `rowid [ASC]` on a scan — both orders the results already
        # have. Anything else runs through the SQLite fallback.
        if order:
            o = re.sub(r"\s+ASC$", "", order, flags=re.IGNORECASE)
            o = o.strip('" ').lower()
            if o != ("distance" if match else "rowid"):
                raise _Unsupported(order)
        # parse projections FIRST so `?` tokens bind in textual order
        # (SELECT exprs come before WHERE in the statement)
        projections = self._parse_projections(table, cols_expr, params)

        if match:
            kq = _K_RE.search(where)
            efq = _EF_RE.search(where)
            ckq = _COARSE_RE.search(where)
            exq = _EXPAND_RE.search(where)
            eq_ms = [
                em
                for em in _EQ_RE.finditer(where)
                if em.group("col").strip('"').lower()
                not in ("k", "ef", "coarse_k", "expand")
                and em.group("col").strip('"') != match.group("col").strip('"')
            ]
            # every WHERE clause must be one the planner executes; leftovers
            # (range predicates, OR trees, function calls...) silently
            # dropping would return wrong results — route them to SQLite
            spans = [match.span()] + [
                q.span() for q in (kq, efq, ckq, exq) if q is not None
            ] + [em.span() for em in eq_ms]
            self._check_residue(where, spans)
            # Bind every token at its *textual* position: clause-type order
            # (MATCH, then k, then filters) misbinds e.g.
            # "WHERE e MATCH ? AND label = ? AND k = ?".
            slots = [(match.start("val"), "q", match.group("val"))]
            if kq:
                slots.append((kq.start("val"), "k", kq.group("val")))
            if efq:
                slots.append((efq.start("val"), "ef", efq.group("val")))
            if ckq:
                slots.append((ckq.start("val"), "ck", ckq.group("val")))
            if exq:
                slots.append((exq.start("val"), "ex", exq.group("val")))
            for j, em in enumerate(eq_ms):
                slots.append((em.start("val"), f"eq{j}", em.group("val")))
            bound = {
                key: self._take_param(tok, params)
                for _, key, tok in sorted(slots)
            }
            qval = bound["q"]
            k = int(bound["k"]) if kq else 10
            ef = int(bound["ef"]) if efq else None
            coarse_k = int(bound["ck"]) if ckq else None
            expand = bool(int(bound["ex"])) if exq else None
            # extra equality filters (partition / metadata)
            partition = None
            predicate_eqs = {}
            for j, em in enumerate(eq_ms):
                col = em.group("col").strip('"')
                val = bound[f"eq{j}"]
                if col == table.partition_col:
                    partition = val
                else:
                    predicate_eqs[col] = val
            col = match.group("col").strip('"')
            # equality filters go through the vectorized code-compare path
            results = table.knn(
                col,
                qval,
                k=k,
                ef=ef,
                partition=partition,
                filters=predicate_eqs or None,
                coarse_k=coarse_k,
                expand=expand,
            )
            if limit:
                n = int(self._take_param(limit, params))
                results = results[:n]
            return self._project(table, projections, [(r.rowid, r.distance) for r in results])

        # rowid lookup or full scan
        rid_m = re.search(r"rowid\s*=\s*(\?|\d+)", where, re.IGNORECASE)
        if rid_m:
            self._check_residue(where, [rid_m.span()])
            rid = int(self._take_param(rid_m.group(1), params))
            rows = [(rid, None)] if rid in table._rowid_to_slot else []
        else:
            if where.strip():  # any other predicate: SQLite fallback
                raise _Unsupported(where)
            table.flush()
            rows = [(rid, None) for rid in sorted(table._rowid_to_slot)]
            if limit:
                rows = rows[: int(self._take_param(limit, params))]
        return self._project(table, projections, rows)

    @staticmethod
    def _check_residue(where: str, spans: list[tuple[int, int]]) -> None:
        """After removing the recognized clauses, only AND connectives may
        remain — otherwise the statement has predicates the mini-planner
        would silently drop, so it must run through the SQLite mirror."""
        buf = list(where)
        for s, e in spans:
            for i in range(s, e):
                buf[i] = " "
        residue = re.sub(r"\bAND\b", " ", "".join(buf), flags=re.IGNORECASE)
        if residue.strip():
            raise _Unsupported(residue.strip())

    # -- projections: raw columns plus vec_*(...) expressions ---------- #
    # (the slice of SQL composability the reference gets from SQLite's
    # expression evaluator over vtab columns, src/vtab.rs:2341-2482)

    def _parse_projections(self, table: VecTable, cols_expr: str, params: list):
        """Parse a SELECT column list into [(label, node)] — consumes any
        `?` bind parameters the expressions contain (textual order)."""
        if cols_expr.strip() == "*":
            names = ["rowid"] + [c.name for c in table.columns]
            return [(n, ("col", n)) for n in names]
        out = []
        for raw in self._split_exprs(cols_expr):
            alias = None
            am = re.match(
                r"^(?P<e>.+?)\s+AS\s+(?P<alias>[\w\"]+)\s*$",
                raw,
                re.IGNORECASE | re.DOTALL,
            )
            if am:
                raw, alias = am.group("e").strip(), am.group("alias").strip('"')
            out.append((alias or raw, self._parse_expr_node(raw, params)))
        return out

    def _parse_expr_node(self, expr: str, params: list):
        """expr -> ("lit", v) | ("col", name) | ("call", fn, [nodes])."""
        expr = expr.strip()
        call = re.match(r"^(vec_\w+)\s*\((.*)\)$", expr, re.IGNORECASE | re.DOTALL)
        if call:
            fname = call.group(1).lower()
            fn = getattr(F, fname, None) if fname in F.__all__ else None
            if fn is None:
                raise InvalidParameter(f"unknown function {call.group(1)}")
            inner = call.group(2).strip()
            args = (
                [self._parse_expr_node(a, params) for a in self._split_exprs(inner)]
                if inner
                else []
            )
            return ("call", fn, args)
        if expr == "?":
            return ("lit", self._take_param("?", params))
        if expr.upper() == "NULL":
            return ("lit", None)
        if expr.startswith("x'"):
            return ("lit", bytes.fromhex(expr[2:-1]))
        if expr.startswith("'"):
            return ("lit", expr[1:-1])
        try:
            return ("lit", int(expr))
        except ValueError:
            pass
        try:
            return ("lit", float(expr))
        except ValueError:
            pass
        if not re.fullmatch(r"[\w\"]+", expr):
            # aggregates, arithmetic, CASE... — SQLite-mirror territory
            raise _Unsupported(expr)
        return ("col", expr.strip('"'))

    def _eval_node(self, node, rid, dist, stored, *, as_arg: bool = False):
        kind = node[0]
        if kind == "lit":
            return node[1]
        if kind == "col":
            n = node[1]
            ln = n.lower()
            if ln == "rowid":
                return rid
            if ln == "distance":
                return dist
            v = stored.get(n)
            if isinstance(v, Vector):
                # direct projection reads back as JSON text, like column()
                # (src/vtab.rs:2341-2482); as a vec_* argument it passes
                # the canonical blob the scalar functions accept
                return v.as_bytes() if as_arg else v.to_json()
            return v
        _, fn, args = node
        return fn(
            *[self._eval_node(a, rid, dist, stored, as_arg=True) for a in args]
        )

    def _project(self, table: VecTable, projections, rows) -> Cursor:
        out = []
        for rid, dist in rows:
            stored = table.row(rid)
            out.append(
                tuple(
                    self._eval_node(node, rid, dist, stored)
                    for _, node in projections
                )
            )
        return Cursor(out, [label for label, _ in projections])

    def _rebuild(self, args: str, params: list) -> Cursor:
        """SELECT vec_rebuild_hnsw('t', 'col'[, M, ef_construction])."""
        parts = [self._eval_expr(a, params) for a in self._split_exprs(args)]
        if len(parts) < 2:
            raise InvalidParameter("vec_rebuild_hnsw(table, column[, M, ef_c])")
        tname, cname = str(parts[0]), str(parts[1])
        table = self.table(tname)
        vc = table.vector_cols.get(cname)
        if vc is None:
            raise InvalidParameter(f"'{cname}' is not a vector column of '{tname}'")
        hp = vc.params
        if len(parts) >= 3 and parts[2] is not None:
            m_val = int(parts[2])
            # bounds from the reference (src/sql_functions.rs:456-465)
            if not (2 <= m_val <= 100):
                raise InvalidParameter("M must be in [2, 100]")
            hp = hp.with_(m=m_val, max_m0=2 * m_val)
        if len(parts) >= 4 and parts[3] is not None:
            efc = int(parts[3])
            if not (10 <= efc <= 2000):
                raise InvalidParameter("ef_construction must be in [10, 2000]")
            hp = hp.with_(ef_construction=efc)
        table.rebuild(cname, params=hp)
        return Cursor([("ok",)], ["vec_rebuild_hnsw"])

    # -- composability fallback: run arbitrary SQL via a SQLite mirror -- #
    # The reference composes with the WHOLE SQLite planner because vec0
    # is a virtual table inside SQLite (joins/subqueries/aggregates all
    # work, src/vtab.rs:964-1028, 2341-2482). The engine recovers the
    # same surface by materializing vec0 tables into the in-process
    # SQLite connection: KNN (`col MATCH ? AND k = ?`) still executes on
    # the device and its (rowid, distance) rows become the mirror, then
    # SQLite runs the statement unchanged (MATCH/k rewritten to 1=1).

    def _resolve_match_table(self, sql: str, fm, tnames: list[str]) -> str:
        """Which vec0 table does `[qual.]col MATCH` target?"""
        qual = (fm.group("qual") or "").strip('"')
        col = fm.group("col").strip('"')
        if qual in self.tables:
            return qual
        if qual:  # alias: find `<table> [AS] <alias>` in FROM/JOIN
            for t in tnames:
                if re.search(
                    rf"\b{re.escape(t)}\s+(?:AS\s+)?{re.escape(qual)}\b",
                    sql,
                    re.IGNORECASE,
                ):
                    return t
            raise InvalidParameter(f"cannot resolve alias '{qual}' in MATCH")
        owners = [t for t in tnames if col in self.tables[t].vector_cols]
        if len(owners) != 1:
            raise InvalidParameter(
                f"ambiguous MATCH column '{col}'; qualify it with the table"
            )
        return owners[0]

    def _split_fallback_binds(self, sql: str, params: list, spans):
        """Partition positional params between the planner-consumed spans
        and the rewritten statement (textual order).

        Returns (span_params: {span_idx: [values]}, pass_params)."""
        qpos = _qmark_positions(sql)
        span_params: dict[int, list] = {i: [] for i in range(len(spans))}
        pass_params: list = []
        if len(qpos) > len(params):
            raise InvalidParameter("not enough bind parameters")
        for qi, pos in enumerate(qpos):
            owner = next(
                (i for i, (s, e) in enumerate(spans) if s <= pos < e), None
            )
            if owner is None:
                pass_params.append(params[qi])
            else:
                span_params[owner].append(params[qi])
        return span_params, pass_params

    def _compose_select(self, sql: str, params: list, tnames: list[str]) -> Cursor:
        fms = [
            fm
            for fm in _FB_MATCH_RE.finditer(sql)
            if any(
                fm.group("col").strip('"') in self.tables[t].vector_cols
                for t in tnames
            )
        ]
        if len(fms) > 1:
            raise InvalidParameter(
                "at most one MATCH clause per statement (the reference's "
                "vtab has the same one-KNN-per-cursor limit)"
            )
        spans: list[tuple[int, int]] = []
        tokens: list[str] = []
        knn_table = None
        knobs: dict[str, str] = {}
        if fms:
            fm = fms[0]
            knn_table = self._resolve_match_table(sql, fm, tnames)
            spans.append(fm.span())
            tokens.append(fm.group("val"))
            for kname, kre in _FB_KNOB_RES.items():
                km = kre.search(sql)
                if km:
                    spans.append(km.span())
                    tokens.append(km.group("val"))
                    knobs[kname] = None  # filled after bind split
        span_params, pass_params = self._split_fallback_binds(
            sql, params, spans
        )
        # evaluate consumed tokens with their own param slices
        vals = [
            self._eval_expr(tok, span_params[i]) for i, tok in enumerate(tokens)
        ]
        for i, kname in enumerate(knobs):
            knobs[kname] = vals[1 + i]
        # rewrite the statement: planner-consumed clauses become no-ops
        out = sql
        for s, e in sorted(spans, reverse=True):
            out = out[:s] + "1=1" + out[e:]
        with_distance = re.search(r"\bdistance\b", sql, re.IGNORECASE) is not None
        for t in tnames:
            if t == knn_table:
                table = self.table(t)
                col = fms[0].group("col").strip('"')
                results = table.knn(
                    col,
                    vals[0],
                    k=int(knobs.get("k") or 10),
                    ef=int(knobs["ef"]) if knobs.get("ef") else None,
                    coarse_k=(
                        int(knobs["coarse_k"]) if knobs.get("coarse_k") else None
                    ),
                    expand=(
                        bool(int(knobs["expand"]))
                        if knobs.get("expand") is not None
                        else None
                    ),
                )
                self._materialize_mirror(
                    table,
                    rows=[(r.rowid, r.distance) for r in results],
                    with_distance=with_distance,
                )
            else:
                self._materialize_mirror(
                    self.table(t), with_distance=with_distance
                )
        cur = self.sqlite.execute(out, pass_params)
        desc = [d[0] for d in cur.description] if cur.description else []
        rows = cur.fetchall()
        if knn_table is not None:
            # KNN mirrors are per-query; drop so the next statement
            # re-materializes the full table
            self.sqlite.execute(f'DROP TABLE IF EXISTS temp."{knn_table}"')
            self._mirrors.pop(knn_table, None)
        return Cursor(rows, desc)

    def _materialize_mirror(
        self, table: VecTable, rows=None, with_distance: bool = False
    ) -> None:
        """Copy a vec0 table into the temp schema of self.sqlite.

        ``rows=None`` mirrors every live row (cached by table version);
        ``rows=[(rowid, distance)]`` mirrors a KNN result. Vector columns
        are stored as JSON text — exactly what the reference's column()
        returns for vector reads (src/vtab.rs:2341-2482) — so vec_*
        scalar functions registered on the connection accept them."""
        name = table.name
        if rows is None:
            table.flush()
            key = (table._version, with_distance)
            if self._mirrors.get(name) == key:
                return
            items = [(rid, None) for rid in sorted(table._rowid_to_slot)]
        else:
            key = None
            items = rows
        cols = ['"rowid" INTEGER PRIMARY KEY'] + [
            f'"{c.name}"' for c in table.columns
        ]
        if with_distance:
            cols.append('"distance" REAL')
        self.sqlite.execute(f'DROP TABLE IF EXISTS temp."{name}"')
        self.sqlite.execute(
            f'CREATE TEMP TABLE "{name}" ({", ".join(cols)})'
        )
        data = []
        for rid, dist in items:
            stored = table.row(rid)
            vals: list = [rid]
            for c in table.columns:
                v = stored.get(c.name)
                vals.append(v.to_json() if isinstance(v, Vector) else v)
            if with_distance:
                vals.append(dist)
            data.append(tuple(vals))
        self.sqlite.executemany(
            f'INSERT INTO "{name}" VALUES ({",".join("?" * len(cols))})', data
        )
        self._mirrors[name] = key

    def _compose_delete(self, m, params: list) -> Cursor:
        """DELETE with an arbitrary WHERE: resolve matching rowids through
        the mirror, then delete on-device."""
        table = self.table(m.group("name").strip('"'))
        where = m.group("where")
        if not where:
            rids = sorted(table._rowid_to_slot)
        else:
            self._materialize_mirror(table)
            rids = [
                r[0]
                for r in self.sqlite.execute(
                    f'SELECT rowid FROM temp."{table.name}" WHERE {where}',
                    params,
                )
            ]
        if rids:
            self._snap_rows(table, rids, "delete")
            table.delete_many(rids)
            self._mirrors.pop(table.name, None)
        return Cursor([], [])

    def _compose_update(self, m, params: list) -> Cursor:
        """UPDATE with an arbitrary WHERE: SET values must be literals /
        binds / vec_* calls (evaluated once), rowids resolve via the
        mirror, the writes run on-device."""
        table = self.table(m.group("name").strip('"'))
        sets = {}
        for part in self._split_exprs(m.group("sets")):
            kcol, v = part.split("=", 1)
            try:
                sets[kcol.strip().strip('"')] = self._eval_expr(
                    v.strip(), params
                )
            except (ValueError, AttributeError):
                raise InvalidParameter(
                    f"unsupported SET expression: {part.strip()[:80]}"
                ) from None
        where = m.group("where")
        if not where:
            rids = sorted(table._rowid_to_slot)
        else:
            self._materialize_mirror(table)
            rids = [
                r[0]
                for r in self.sqlite.execute(
                    f'SELECT rowid FROM temp."{table.name}" WHERE {where}',
                    params,
                )
            ]
        if rids:
            self._snap_rows(table, rids, "update")
            table.update_many(rids, [dict(sets)] * len(rids))
            self._mirrors.pop(table.name, None)
        return Cursor([], [])
