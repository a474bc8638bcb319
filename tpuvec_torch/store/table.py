"""VecTable: the vec0 virtual table as a device-resident store. The port of
``tpuvec/store/table.py``.

As in the JAX package:

* column classes: vector (with an optional HNSW index per column, its own
  distance metric and index quantization), metadata, auxiliary and
  partition key;
* rowids are explicit or auto-assigned (max + 1);
* the host keeps each vector in its original precision (``raw``); the
  index keeps its own normalized or quantized copy on the device;
* insert, update (delete + re-insert under the same rowid) and delete,
  with HNSW maintenance; k-NN per vector column, exact when the column has
  no HNSW index or the caller asks for it;
* partition and metadata filters are masks over slots: the exact masked
  scan, the per-query coded exact scan, or the in-beam filtered HNSW
  search, chosen by selectivity;
* a BINARY-quantized float32 column reranks its Hamming candidates
  exactly, on a device shadow of the originals when it fits
  ``SHADOW_BUDGET_BYTES``, else on the host;
* ``integrity_check`` and ``rebuild``.

Rows live at dense slots of device tensors, and a host dict maps rowids to
slots. Inserts buffer on the host and flush to the device in mini-batches
of at most 256 rows, no larger than the graph they join; every read path
flushes first.

Where the port differs: every tensor lives on ``device`` (default
``"cuda"``; without a card the constructor raises). Flush and query
batches go to the device at their own length, not padded to a fixed shape
(torch has nothing to recompile); each flush batch passes the JAX
package's padded width (16 or 256) as ``insert_batch(width=)``, so the
upper stage's cap is the JAX package's.

A mesh-backed table (``mesh=``, ``parallel/sharding.py``) holds its one
vector column as a ``ShardedHnsw``, as in the JAX package: table slots ARE
the sharded index's global ids (shard * cap + local slot), partition
values route rows to shards, a full shard doubles the table's capacity
(``_grow_mesh``, which remaps every host-side slot), and the host's live
mask and codes reshape to ``[S, cap]`` per-shard masks. The JAX design's
limits are kept: one vector column, no per-query partitions, no rerank
expansion. The shards live on the mesh's devices; ``device`` is not read.

Opt-in durability, as in the JAX package: with ``autosave_path`` every
``autosave_every`` flushes start an atomic snapshot (``store/snapshot.py``)
on a daemon thread that holds the table's lock; a trigger that arrives
while a save is in flight folds into the next one, so a crash loses at
most the rows since the last completed save.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from tpuvec_torch.codec import Vector, pack_bits, unpack_bits
from tpuvec_torch.device import resolve
from tpuvec_torch.index.bruteforce import bruteforce_knn_internal
from tpuvec_torch.index.build import build_graph, delete_ids, insert_batch
from tpuvec_torch.index.graph import GraphState, allocate, config_for, grow_state, prepare_vectors
from tpuvec_torch.index.params import HnswParams
from tpuvec_torch.index.search import search_graph
from tpuvec_torch.ops.distance import internal_to_output
from tpuvec_torch.ops.rerank import expand_rerank_topk, rerank_topk
from tpuvec_torch.parallel.sharding import (
    ShardedHnsw,
    ShardFullError,
    _sharded_exact,
    _sharded_search,
)
from tpuvec_torch.types import (
    DimensionMismatch,
    DistanceMetric,
    IndexQuantization,
    IndexType,
    InvalidParameter,
    InvalidState,
    InvalidVectorFormat,
    VectorType,
)
from tpuvec_torch.utils import timing
from tpuvec_torch.utils.prng import sample_levels_np

__all__ = ["VecTable", "ColumnSpec", "QueryResult", "SHADOW_BUDGET_BYTES"]

_FLUSH_THRESHOLD = 256
_INF = float("inf")

# Device memory budget of a BINARY column's f32 rerank shadow (the JAX
# package's default, TPUVEC_SHADOW_BUDGET_MB=6144). A column whose shadow
# would exceed it reranks on the host from the originals.
SHADOW_BUDGET_BYTES = 6144 << 20


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One column declaration."""

    name: str
    kind: str  # "vector" | "metadata" | "aux" | "partition"
    # vector-only fields
    vec_type: VectorType | None = None
    dimensions: int = 0
    metric: DistanceMetric = DistanceMetric.COSINE
    hnsw: bool = False
    params: HnswParams | None = None
    quantization: IndexQuantization = IndexQuantization.NONE

    @classmethod
    def vector(
        cls,
        name: str,
        dimensions: int,
        *,
        vec_type: VectorType = VectorType.FLOAT32,
        metric: DistanceMetric = DistanceMetric.COSINE,
        hnsw: bool = True,
        params: HnswParams | None = None,
        quantization: IndexQuantization = IndexQuantization.NONE,
    ) -> "ColumnSpec":
        return cls(
            name=name,
            kind="vector",
            vec_type=vec_type,
            dimensions=dimensions,
            metric=metric,
            hnsw=hnsw,
            params=params,
            quantization=quantization,
        )

    @classmethod
    def metadata(cls, name: str) -> "ColumnSpec":
        return cls(name=name, kind="metadata")

    @classmethod
    def aux(cls, name: str) -> "ColumnSpec":
        return cls(name=name, kind="aux")

    @classmethod
    def partition_key(cls, name: str) -> "ColumnSpec":
        return cls(name=name, kind="partition")


@dataclasses.dataclass
class QueryResult:
    rowid: int
    distance: float
    values: dict[str, Any]


class _ScalarColumn:
    """Columnar scalar storage on the host: values interned to int32 codes
    per slot, so an equality filter is one vectorized compare over the
    codes. Values must be hashable."""

    def __init__(self, cap: int):
        self.codes = np.full(cap, -1, dtype=np.int32)  # -1 = NULL/absent
        self.values: list[Any] = []
        self._code_of: dict[Any, int] = {}

    def set(self, slot: int, value) -> None:
        if value is None:
            self.codes[slot] = -1
            return
        try:
            code = self._code_of.get(value)
        except TypeError:
            raise InvalidParameter(
                f"scalar column values must be hashable, got {type(value).__name__}"
            ) from None
        if code is None:
            code = len(self.values)
            self.values.append(value)
            self._code_of[value] = code
        self.codes[slot] = code

    def get(self, slot: int):
        c = self.codes[slot]
        return None if c < 0 else self.values[c]

    def clear(self, slot: int) -> None:
        self.codes[slot] = -1

    def code_of(self, value) -> int:
        """The code a query for ``value`` compares: -1 for None (rows with
        no value), -2 for a value never stored or unhashable (no row)."""
        if value is None:
            return -1
        try:
            return self._code_of.get(value, -2)
        except TypeError:
            return -2

    def mask_eq(self, value) -> np.ndarray:
        """Vectorized equality mask over all slots."""
        return self.codes == self.code_of(value)

    def grow(self, new_cap: int) -> None:
        codes = np.full(new_cap, -1, dtype=np.int32)
        codes[: self.codes.shape[0]] = self.codes
        self.codes = codes


class _VectorColumn:
    """One vector column: host originals, the graph on the device and, for
    a BINARY float32 column within budget, the f32 rerank shadow on the
    device."""

    def __init__(self, spec: ColumnSpec, cap: int, index_type: IndexType, device: torch.device):
        self.spec = spec
        self.device = device
        self.params = spec.params or HnswParams()
        self.has_hnsw = spec.hnsw and index_type is IndexType.HNSW
        self.config = config_for(
            spec.dimensions,
            metric=spec.metric,
            vec_type=spec.vec_type or VectorType.FLOAT32,
            quantization=spec.quantization,
            params=self.params,
            cap=cap,
        )
        self.raw = np.zeros((self.config.cap, _raw_width(spec)), dtype=_raw_dtype(spec))
        self.state: GraphState = allocate(self.config, device=device)
        self.shadow: torch.Tensor | None = None
        if self._shadow_fits():
            self.shadow = torch.zeros(
                (self.config.cap, spec.dimensions), dtype=torch.float32, device=device
            )

    @property
    def slots_cap(self) -> int:
        return self.config.cap

    def _shadow_fits(self) -> bool:
        return (
            _is_binary_rerank(self)
            and self.config.cap * self.spec.dimensions * 4 <= SHADOW_BUDGET_BYTES
        )

    def refresh_shadow(self) -> None:
        """(Re)build the rerank shadow from the host originals, or drop it
        if the column no longer qualifies or fits the budget."""
        self.shadow = (
            torch.tensor(self.raw, dtype=torch.float32, device=self.device)
            if self._shadow_fits()
            else None
        )

    def update_shadow(self, slots: np.ndarray, raws: np.ndarray) -> None:
        """Write freshly inserted originals into the device shadow: one row
        write (every slot is below the capacity)."""
        if self.shadow is None:
            return
        self.shadow[torch.as_tensor(slots, device=self.device).long()] = torch.as_tensor(
            raws, dtype=torch.float32, device=self.device
        )

    def grow(self, new_cap: int) -> None:
        """Grow to ``new_cap`` slots: every array is padded, the graph carries
        over (adjacency holds slot ids, which a larger capacity leaves as
        they are). ``cap_u`` is max(new_cap // 8, 128), not rounded, as in
        the JAX package: the construction budget depends on the capacity,
        so growth at another flush or to another size builds another graph."""
        self.config = dataclasses.replace(
            self.config, cap=new_cap, cap_u=max(new_cap // 8, 128)
        )
        c = self.config
        raw = np.zeros((c.cap, self.raw.shape[1]), dtype=self.raw.dtype)
        raw[: self.raw.shape[0]] = self.raw
        self.raw = raw
        self.state = grow_state(self.state, c.cap, c.cap_u)
        if self.shadow is not None:
            self.shadow = None  # free the old copy before the new one
            self.refresh_shadow()


class _MeshVectorColumn:
    """A mesh-backed vector column: one ``ShardedHnsw`` (a sub-index per
    shard) behind the VecTable surface. Table slots ARE the sharded
    index's global ids (shard * cap + local slot), so the host-side live
    mask and code arrays reshape to ``[S, cap]`` per-shard masks. It keeps
    no rerank shadow: a BINARY column reranks on the host."""

    shadow = None

    def __init__(self, spec: ColumnSpec, total_cap: int, index_type: IndexType, mesh):
        self.spec = spec
        self.params = spec.params or HnswParams()
        self.has_hnsw = spec.hnsw and index_type is IndexType.HNSW
        self.mesh = mesh
        self.idx = ShardedHnsw(
            mesh,
            spec.dimensions,
            metric=spec.metric,
            params=self.params,
            cap_per_shard=max(-(-total_cap // mesh.devices.size), 128),
            quantization=spec.quantization,
            vec_type=spec.vec_type or VectorType.FLOAT32,
        )
        self.raw = np.zeros((self.slots_cap, _raw_width(spec)), dtype=_raw_dtype(spec))

    @property
    def config(self):
        return self.idx.config

    @property
    def slots_cap(self) -> int:
        return self.idx.n_shards * self.config.cap

    def grow(self, new_total_cap: int) -> None:
        """Grow per-shard capacity in place (the sub-graphs carry over). The
        caller (VecTable._grow_mesh) remaps global slot ids:
        (s, sl) -> s * new_cap + sl."""
        old_cap = self.config.cap
        self.idx.grow(-(-new_total_cap // self.idx.n_shards))
        new_cap = self.config.cap
        if new_cap == old_cap:
            return
        s_n, w = self.idx.n_shards, self.raw.shape[1]
        raw = np.zeros((s_n * new_cap, w), dtype=self.raw.dtype)
        raw.reshape(s_n, new_cap, w)[:, :old_cap] = self.raw.reshape(s_n, old_cap, w)
        self.raw = raw

    def alloc_slot(self, part_value, rr: int) -> int:
        """A global slot: the partition's shard, else shard ``rr % S``."""
        if part_value is not None:
            shard = self.idx.shard_of_partition(part_value)
        else:
            shard = rr % self.idx.n_shards
        local = self.idx._alloc_slot(shard)
        if part_value is not None:
            self.idx._part_codes[shard, local] = self.idx._intern_partition(part_value)
        return shard * self.config.cap + local

    def insert_prepared(self, slots: np.ndarray, prepared: torch.Tensor, batch: int, start: int = 1):
        cap = self.config.cap
        per_shard: list[list[int]] = [[] for _ in range(self.idx.n_shards)]
        local = np.empty(len(slots), dtype=np.int64)
        for row, g in enumerate(slots):
            s, sl = divmod(int(g), cap)
            per_shard[s].append(row)
            local[row] = sl
        self.idx._insert_rows(per_shard, local, prepared, batch, start=start)

    def delete_slots(self, slots) -> None:
        self.idx.delete(np.asarray(slots, dtype=np.int64))

    def _per_shard(self, mask: np.ndarray) -> list[torch.Tensor]:
        """A host mask over the table's slots as one bool tensor per shard."""
        rows = mask.reshape(self.idx.n_shards, self.config.cap)
        return [torch.as_tensor(r, device=dev) for r, dev in zip(rows, self.mesh.devices)]

    def exact(self, qp, k, valid: np.ndarray):
        return _sharded_exact(self.config, self.idx.states, qp, self._per_shard(valid), k=k)

    def hnsw(self, qp, k, ef, mask: np.ndarray | None):
        masks = None if mask is None else self._per_shard(mask)
        return _sharded_search(self.config, self.idx.states, qp, k=k, ef=ef, masks=masks)


def _raw_dtype(spec: ColumnSpec):
    vt = spec.vec_type
    if vt is VectorType.FLOAT32:
        return np.float32
    if vt is VectorType.INT8:
        return np.int8
    return np.uint8  # BIT: packed bytes


def _raw_width(spec: ColumnSpec) -> int:
    if spec.vec_type is VectorType.BIT:
        return (spec.dimensions + 7) // 8
    return spec.dimensions


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _output(config, d: torch.Tensor) -> torch.Tensor:
    """Internal distances in the user metric; missing slots stay +inf."""
    out = internal_to_output(config.metric, d, normalized=config.normalized)
    return torch.where(torch.isfinite(d), out, _INF)


def _is_binary_rerank(vc: _VectorColumn) -> bool:
    return (
        vc.spec.quantization is IndexQuantization.BINARY
        and vc.spec.vec_type is VectorType.FLOAT32
    )


class VecTable:
    """A typed vector table with per-column HNSW indexes on one device.

    >>> t = VecTable("docs", [ColumnSpec.vector("emb", 128, metric=DistanceMetric.L2)],
    ...              device="cpu")
    >>> t.insert({"emb": [0.0] * 128})
    1
    >>> t.knn("emb", [0.0] * 128, k=1)[0].rowid
    1
    """

    def __init__(
        self,
        name: str,
        columns: Sequence[ColumnSpec],
        *,
        index_type: IndexType = IndexType.HNSW,
        initial_cap: int = 1024,
        mesh=None,
        autosave_path: str | None = None,
        autosave_every: int = 16,
        device: str | torch.device = "cuda",
    ):
        if not any(c.kind == "vector" for c in columns):
            raise InvalidParameter("vec0 table requires at least one vector column")
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise InvalidParameter("duplicate column name")
        self.name = name
        self.columns = list(columns)
        self.index_type = index_type
        self.mesh = mesh
        if mesh is not None:
            vcols = [c for c in columns if c.kind == "vector"]
            if len(vcols) != 1:
                raise InvalidParameter("mesh-backed tables support exactly one vector column")
            self.device = mesh.devices[0]
            self.vector_cols = {
                vcols[0].name: _MeshVectorColumn(vcols[0], initial_cap, index_type, mesh)
            }
        else:
            self.device = resolve(device)
            self.vector_cols = {
                c.name: _VectorColumn(c, initial_cap, index_type, self.device)
                for c in columns
                if c.kind == "vector"
            }
        self._rr = 0  # round-robin shard pointer (mesh mode)
        self.scalar_cols = [c for c in columns if c.kind != "vector"]
        self.partition_col = next(
            (c.name for c in columns if c.kind == "partition"), None
        )
        # host-side row storage
        self._rowid_to_slot: dict[int, int] = {}
        self._slot_to_rowid: dict[int, int] = {}
        self._scalars: dict[str, _ScalarColumn] = {
            c.name: _ScalarColumn(self.cap) for c in self.scalar_cols
        }
        self._live = np.zeros(self.cap, dtype=bool)  # slot occupancy
        self._version = 0  # bumped on every mutation
        self._next_slot = 0
        self._free_slots: list[int] = []
        self._max_rowid = 0
        self._pending: list[tuple[int, int, dict[str, Vector]]] = []
        self._lock = threading.RLock()
        # write-behind atomic snapshot every N flushes: a kill -9 loses at
        # most the rows since the last completed autosave
        self.autosave_path = autosave_path
        self.autosave_every = max(1, int(autosave_every))
        self._flushes_since_save = 0
        self._autosave_thread: threading.Thread | None = None
        # device copies of the live mask and the partition codes, keyed by
        # (_version, cap): repeated filtered queries reuse one upload
        self._dev_cache: dict[Any, tuple[tuple[int, int], torch.Tensor]] = {}

    # ------------------------------------------------------------------ #
    # helpers
    # ------------------------------------------------------------------ #

    @property
    def cap(self) -> int:
        return next(iter(self.vector_cols.values())).slots_cap

    def __len__(self) -> int:
        with self._lock:
            return len(self._rowid_to_slot)  # pending rows are mapped already

    def next_rowid(self) -> int:
        """Auto rowid = max + 1."""
        return self._max_rowid + 1

    def _decode_vector(self, col: ColumnSpec, value) -> Vector:
        if isinstance(value, Vector):
            v = value
        elif isinstance(value, (list, tuple, np.ndarray)):
            arr = np.asarray(value)
            if col.vec_type is VectorType.FLOAT32:
                v = Vector.from_f32(arr)
            elif col.vec_type is VectorType.INT8:
                v = Vector.from_i8(arr)
            else:
                v = Vector.from_bits(arr)
        else:
            v = Vector.from_sql_value(value, col.vec_type)
        if v.dimensions != col.dimensions:
            raise DimensionMismatch(col.dimensions, v.dimensions)
        if v.vec_type is not col.vec_type:
            raise InvalidVectorFormat(
                f"column '{col.name}' expects {col.vec_type.value}, got {v.vec_type.value}"
            )
        return v

    def _alloc_slot(self, part_value=None) -> int:
        if self.mesh is not None:
            vc = next(iter(self.vector_cols.values()))
            try:
                slot = vc.alloc_slot(part_value, self._rr)
            except ShardFullError:
                self._grow_mesh()
                slot = vc.alloc_slot(part_value, self._rr)
            if part_value is None:
                self._rr += 1
            return slot
        if self._free_slots:
            return self._free_slots.pop()
        s = self._next_slot
        self._next_slot += 1
        return s

    def _grow_mesh(self) -> None:
        """Double a mesh-backed table's capacity in place. The per-shard
        sub-graphs carry over (adjacency holds local slots); global slot ids
        change meaning (shard * cap + slot), so every host-side slot
        reference is remapped here."""
        vc = next(iter(self.vector_cols.values()))
        s_n = vc.idx.n_shards
        old_cap = vc.config.cap
        vc.grow(self.cap * 2)
        new_cap = vc.config.cap
        if new_cap == old_cap:
            raise InvalidState("mesh capacity growth failed to enlarge")

        def remap(g: int) -> int:
            s, sl = divmod(int(g), old_cap)
            return s * new_cap + sl

        self._rowid_to_slot = {r: remap(g) for r, g in self._rowid_to_slot.items()}
        self._slot_to_rowid = {v: k for k, v in self._rowid_to_slot.items()}
        self._free_slots = [remap(g) for g in self._free_slots]
        self._pending = [(rid, remap(slot), vecs) for rid, slot, vecs in self._pending]
        live = np.zeros(s_n * new_cap, dtype=bool)
        live.reshape(s_n, new_cap)[:, :old_cap] = self._live[: s_n * old_cap].reshape(s_n, old_cap)
        self._live = live
        for sc in self._scalars.values():
            codes = np.full(s_n * new_cap, -1, dtype=np.int32)
            codes.reshape(s_n, new_cap)[:, :old_cap] = sc.codes[: s_n * old_cap].reshape(s_n, old_cap)
            sc.codes = codes

    def _grow_host(self, needed: int) -> None:
        """Grow host-side slot arrays (live mask, scalar columns)."""
        size = self._live.shape[0]
        if needed <= size:
            return
        while size < needed:
            size *= 2
        live = np.zeros(size, dtype=bool)
        live[: self._live.shape[0]] = self._live
        self._live = live
        for sc in self._scalars.values():
            sc.grow(size)

    def _ensure_capacity(self) -> None:
        """Double the capacity until it exceeds every slot handed out: a
        table that has used exactly its capacity grows too."""
        needed = self._next_slot
        cap = self.cap
        if needed < cap:
            return
        new_cap = cap
        while new_cap <= needed:
            new_cap *= 2
        for vc in self.vector_cols.values():
            vc.grow(new_cap)
        self._grow_host(new_cap)

    # ------------------------------------------------------------------ #
    # write path
    # ------------------------------------------------------------------ #

    def insert(self, values: Mapping[str, Any], rowid: int | None = None) -> int:
        """Insert one row; returns its rowid."""
        with self._lock:
            if rowid is None:
                rowid = self.next_rowid()
            rowid = int(rowid)
            if rowid in self._rowid_to_slot or any(
                p[0] == rowid for p in self._pending
            ):
                raise InvalidState(f"rowid {rowid} already exists")

            vecs: dict[str, Vector] = {}
            for cname, vc in self.vector_cols.items():
                if cname not in values or values[cname] is None:
                    raise InvalidParameter(f"missing vector for column '{cname}'")
                vecs[cname] = self._decode_vector(vc.spec, values[cname])

            part = values.get(self.partition_col) if self.partition_col is not None else None
            slot = self._alloc_slot(part)
            if slot >= self._live.shape[0]:
                self._grow_host(slot + 1)
            for c in self.scalar_cols:
                if c.name in values:
                    self._scalars[c.name].set(slot, values[c.name])
            self._live[slot] = True
            self._version += 1
            self._pending.append((rowid, slot, vecs))
            self._rowid_to_slot[rowid] = slot
            self._slot_to_rowid[slot] = rowid
            self._max_rowid = max(self._max_rowid, rowid)
            if len(self._pending) >= _FLUSH_THRESHOLD:
                self.flush()
            return rowid

    def insert_many(
        self, rows: Iterable[Mapping[str, Any]], rowids: Sequence[int] | None = None
    ) -> list[int]:
        out = []
        for i, row in enumerate(rows):
            rid = None if rowids is None else rowids[i]
            out.append(self.insert(row, rowid=rid))
        self.flush()
        return out

    def flush(self) -> None:
        """Push buffered inserts into the device indexes.

        Inserts go in mini-batches no larger than the graph they land in
        (doubling schedule: batch members do not see each other, so an
        unbounded batch into a small graph would leave nodes isolated), at
        most 256 rows each. Each batch's upper stage is capped as for the
        JAX package's padded width, 16 or 256."""
        with self._lock, timing.timer("table.flush"):
            if not self._pending:
                return
            pend = self._pending
            self._pending = []
            self._ensure_capacity()
            slots = np.array([p[1] for p in pend], dtype=np.int32)
            slots_t = torch.as_tensor(slots, device=self.device)
            graph_size = len(self._rowid_to_slot) - len(pend)
            for cname, vc in self.vector_cols.items():
                vals = np.stack([p[2][cname].to_numpy() for p in pend])
                vc.raw[slots] = pack_bits(vals) if vc.spec.vec_type is VectorType.BIT else vals
                prepared = self._prepare_rows(vc, vals)
                if isinstance(vc, _MeshVectorColumn):
                    # one shared schedule over the shards, every round at the
                    # padded width, seeded with the per-shard graph size
                    vc.insert_prepared(slots, prepared, batch=_FLUSH_THRESHOLD,
                                       start=max(1, graph_size // vc.idx.n_shards))
                    continue
                vc.update_shadow(slots, vals)
                c = vc.config
                levels = torch.as_tensor(
                    sample_levels_np(slots, c.rng_seed, c.level_factor, c.lu), device=self.device
                )
                pos, size = 0, graph_size
                while pos < len(pend):
                    take = min(max(size, 1), _FLUSH_THRESHOLD, len(pend) - pos)
                    sl = slice(pos, pos + take)
                    vc.state = insert_batch(
                        c, vc.state, slots_t[sl], prepared[sl], levels[sl],
                        width=16 if take <= 16 else _FLUSH_THRESHOLD,
                    )
                    pos += take
                    size += take
            if self.autosave_path is not None:
                self._flushes_since_save += 1
                if self._flushes_since_save >= self.autosave_every:
                    self._maybe_autosave()

    def _maybe_autosave(self) -> None:
        """Write-behind snapshot: a daemon thread takes the table lock and
        writes the atomic snapshot (tmp + rename, so a crash mid-save keeps
        the previous one). If a save is already in flight this trigger
        folds into the next: the loss bound stays ~N flushes + one save.
        The save's own flush runs on that thread while it is alive, so it
        starts no second save."""
        t = self._autosave_thread
        if t is not None and t.is_alive():
            return
        self._flushes_since_save = 0

        def run():
            from tpuvec_torch.store import snapshot

            with self._lock:
                snapshot.save(self, self.autosave_path)

        t = threading.Thread(target=run, daemon=True, name=f"tpuvec-autosave-{self.name}")
        self._autosave_thread = t
        t.start()

    def wait_autosave(self) -> None:
        """Block until any in-flight autosave completes (tests/shutdown)."""
        t = self._autosave_thread
        if t is not None:
            t.join()

    def _prepare_rows(self, vc: _VectorColumn, vals: np.ndarray) -> torch.Tensor:
        """User values [n, dim] (0/1 bits for a BIT column) -> the index's
        prepared rows on the device. Bits are packed into little-endian
        32-bit words."""
        c = vc.config
        if vc.spec.vec_type is VectorType.BIT:
            words_w = -(-c.dim // 32)
            bits = np.zeros((len(vals), words_w * 32), dtype=np.uint8)
            bits[:, : c.dim] = vals
            return prepare_vectors(c, pack_bits(bits).view("<u4"), device=self.device)
        dtype = np.float32 if vc.spec.vec_type is VectorType.FLOAT32 else np.int8
        return prepare_vectors(c, np.asarray(vals, dtype=dtype), device=self.device)

    def delete(self, rowid: int) -> None:
        self.delete_many([rowid])

    def delete_many(self, rowids: Sequence[int]) -> None:
        with self._lock:
            self.flush()
            slots = []
            for rid in rowids:
                rid = int(rid)
                if rid not in self._rowid_to_slot:
                    raise InvalidState(f"rowid {rid} not found")
                s = self._rowid_to_slot.pop(rid)
                del self._slot_to_rowid[s]
                for col in self._scalars.values():
                    col.clear(s)
                self._live[s] = False
                self._version += 1
                slots.append(s)
                if self.mesh is None:
                    self._free_slots.append(s)
            if not slots:
                return
            if self.mesh is not None:  # the shards keep their own free lists
                for vc in self.vector_cols.values():
                    vc.delete_slots(slots)
                return
            ids = torch.as_tensor(np.array(slots, dtype=np.int32), device=self.device)
            for vc in self.vector_cols.values():
                vc.state = delete_ids(vc.config, vc.state, ids)

    def update(self, rowid: int, values: Mapping[str, Any]) -> None:
        """Update vector and/or scalar columns of an existing rowid
        (delete + re-insert)."""
        self.update_many([rowid], [values])

    def update_many(
        self, rowids: Sequence[int], values_list: Sequence[Mapping[str, Any]]
    ) -> None:
        """Bulk update: one batched delete, then batched re-inserts."""
        if len(rowids) != len(values_list):
            raise InvalidParameter("rowids/values length mismatch")
        if not rowids:
            return
        with self._lock:
            self.flush()
            rids = [int(r) for r in rowids]
            merged = []
            for rid, values in zip(rids, values_list):
                if rid not in self._rowid_to_slot:
                    raise InvalidState(f"rowid {rid} not found")
                old = self.row(rid)
                merged.append({**old, **dict(values)})
            self.delete_many(rids)
            self.insert_many(merged, rowids=rids)

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #

    def row(self, rowid: int) -> dict[str, Any]:
        """One row's stored values (the original vectors)."""
        with self._lock:
            self.flush()
            rowid = int(rowid)
            if rowid not in self._rowid_to_slot:
                raise InvalidState(f"rowid {rowid} not found")
            slot = self._rowid_to_slot[rowid]
            out: dict[str, Any] = {}
            for cname, vc in self.vector_cols.items():
                raw = vc.raw[slot]
                if vc.spec.vec_type is VectorType.BIT:
                    out[cname] = Vector.from_blob(
                        raw.tobytes(), VectorType.BIT, vc.spec.dimensions
                    )
                elif vc.spec.vec_type is VectorType.INT8:
                    out[cname] = Vector.from_i8(raw[: vc.spec.dimensions])
                else:
                    out[cname] = Vector.from_f32(raw[: vc.spec.dimensions])
            for c in self.scalar_cols:
                out[c.name] = self._scalars[c.name].get(slot)
            return out

    def _filter_mask(
        self, partition=None, predicate=None, filters=None
    ) -> np.ndarray | None:
        """Validity mask over slots from partition / metadata filters.

        Partition and equality ``filters`` are vectorized compares over the
        interned codes; a ``predicate`` callable runs per live row.
        """
        if partition is None and predicate is None and not filters:
            return None
        cap = self.cap
        mask = self._live[:cap].copy()
        if partition is not None:
            if self.partition_col is None:
                raise InvalidParameter("table has no partition key column")
            mask &= self._scalars[self.partition_col].mask_eq(partition)[:cap]
        if filters:
            for col, val in filters.items():
                if col not in self._scalars:
                    raise InvalidParameter(f"'{col}' is not a scalar column")
                mask &= self._scalars[col].mask_eq(val)[:cap]
        if predicate is not None:
            for slot in np.nonzero(mask)[0]:
                rid = self._slot_to_rowid[int(slot)]
                vals = {
                    c.name: self._scalars[c.name].get(int(slot))
                    for c in self.scalar_cols
                }
                if not predicate(rid, vals):
                    mask[slot] = False
        return mask

    def knn(
        self,
        column: str,
        query,
        *,
        k: int,
        ef: int | None = None,
        partition=None,
        predicate=None,
        filters: Mapping[str, Any] | None = None,
        exact: bool | None = None,
        coarse_k: int | None = None,
        expand: bool | None = None,
    ) -> list[QueryResult]:
        """k nearest neighbors on a vector column.

        ``exact=True`` forces the exact scan; the default follows the
        column's index type. ``partition`` / ``filters`` (equality) /
        ``predicate`` (any callable of (rowid, scalars)) filter results.
        """
        return self.knn_many(
            column,
            [query],
            k=k,
            ef=ef,
            partition=partition,
            predicate=predicate,
            filters=filters,
            exact=exact,
            coarse_k=coarse_k,
            expand=expand,
        )[0]

    def knn_many(
        self,
        column: str,
        queries: Sequence,
        *,
        k: int,
        ef: int | None = None,
        partition=None,
        predicate=None,
        filters: Mapping[str, Any] | None = None,
        exact: bool | None = None,
        coarse_k: int | None = None,
        expand: bool | None = None,
    ) -> list[list[QueryResult]]:
        """Batched k-NN: B queries in one device pass.

        ``partition`` may also be a sequence of length ``len(queries)``, one
        partition value per query: all B single-tenant lookups then run as
        one coded exact scan (the multi-tenant serving shape).

        Routes, in order: per-query partitions -> the coded exact scan; one
        partition matching at most 50 k live rows (or ``exact``) -> the
        coded exact scan; a BINARY float32 column -> Hamming search plus the
        exact rerank; ``exact`` or no HNSW -> the exact (masked) scan; a
        filter -> the exact masked scan at most 50 k rows, else the in-beam
        filtered HNSW search, falling back to the exact scan when a query
        comes back short; else the HNSW search.
        """
        with self._lock, timing.timer("table.knn"):
            self.flush()
            if column not in self.vector_cols:
                raise InvalidParameter(f"'{column}' is not a vector column")
            vc = self.vector_cols[column]
            if k <= 0:
                raise InvalidParameter("k must be positive")
            nq = len(queries)
            if nq == 0:
                return []
            qvs = [self._decode_vector(vc.spec, q) for q in queries]
            qp = self._prepare_rows(vc, np.stack([qv.to_numpy() for qv in qvs]))

            if (
                partition is not None
                and isinstance(partition, (list, tuple, np.ndarray))
                and len(partition) == nq
            ):
                if self.partition_col is None:
                    raise InvalidParameter("table has no partition key column")
                if self.mesh is not None:
                    raise InvalidParameter(
                        "per-query partitions are not supported on "
                        "mesh-backed tables; loop over knn(partition=...)"
                    )
                if _is_binary_rerank(vc):
                    raise InvalidParameter(
                        "per-query partitions are not supported on "
                        "binary+rerank columns; loop over knn(partition=...)"
                    )
                mask = self._filter_mask(None, predicate, filters)
                d, i = self._exact_coded(vc, qp, k, partition, mask)
                return self._collect_results(d, i, k)

            if (
                partition is not None
                and predicate is None
                and not filters
                and self.mesh is None
                and not _is_binary_rerank(vc)
            ):
                # scalar-partition fast path: a selective tenant goes
                # through the coded exact scan with version-cached device
                # arrays; per call only the queries and B codes move
                if self.partition_col is None:
                    raise InvalidParameter("table has no partition key column")
                sc = self._scalars[self.partition_col]
                pm = sc.mask_eq(partition)[: self.cap]
                n_match = int(np.count_nonzero(pm & self._live[: self.cap]))
                want_exact = exact if exact is not None else not vc.has_hnsw
                if want_exact or n_match <= 50 * k:
                    d, i = self._exact_coded(vc, qp, k, [partition] * nq, None)
                    return self._collect_results(d, i, k)

            mask = self._filter_mask(partition, predicate, filters)
            use_exact = exact if exact is not None else not vc.has_hnsw

            if _is_binary_rerank(vc):
                d, i = self._binary_rerank(vc, qvs, qp, k, mask, use_exact, coarse_k, expand)
            elif use_exact or mask is not None and not vc.has_hnsw:
                d, i = self._exact(vc, qp, k, mask)
            elif mask is not None:
                # in-beam filtered search; very selective filters go
                # straight to the exact masked scan (the beam would meet
                # too few matches to fill k)
                n_match = int(mask.sum())
                if n_match <= 50 * k:
                    d, i = self._exact(vc, qp, k, mask)
                else:
                    d, i = self._hnsw(vc, qp, k, ef, mask)
                    if int((i >= 0).sum(dim=1).min()) < min(k, n_match):
                        d, i = self._exact(vc, qp, k, mask)
            else:
                d, i = self._hnsw(vc, qp, k, ef)

            return self._collect_results(d, i, k)

    def _collect_results(self, d, i, k: int) -> list[list[QueryResult]]:
        dn, inn = _host(d), _host(i)
        results: list[list[QueryResult]] = []
        for b in range(dn.shape[0]):
            out = []
            for dist, slot in zip(dn[b], inn[b]):
                if slot < 0 or not np.isfinite(dist):
                    continue
                rid = self._slot_to_rowid.get(int(slot))
                if rid is None:
                    continue
                out.append(QueryResult(rid, float(dist), {}))
                if len(out) >= k:
                    break
            results.append(out)
        return results

    def _dev_cached(self, key, make) -> torch.Tensor:
        """Version-keyed device copy of a host array (one upload per
        mutation epoch instead of one per query)."""
        tag = (self._version, self.cap)
        ent = self._dev_cache.get(key)
        if ent is None or ent[0] != tag:
            arr = make()
            self._dev_cache[key] = (tag, arr)
            return arr
        return ent[1]

    def _valid(self, mask: np.ndarray | None) -> torch.Tensor:
        """The live slots (and ``mask``) as a device bool tensor."""
        if mask is None:
            return self._dev_cached(
                "live", lambda: torch.tensor(self._live[: self.cap], device=self.device)
            )
        return torch.tensor(self._live[: self.cap] & mask, device=self.device)

    def _exact(self, vc: _VectorColumn, qp, k, mask):
        c = vc.config
        if isinstance(vc, _MeshVectorColumn):
            valid = self._live[: self.cap]
            d, i = vc.exact(qp, k, valid if mask is None else valid & mask)
            return _output(c, d), i
        d, i = bruteforce_knn_internal(
            qp, vc.state.vectors, self._valid(mask),
            metric=c.graph_metric, k=k, normalized=c.normalized,
        )
        return _output(c, d), i

    def _exact_coded(self, vc: _VectorColumn, qp, k, partitions, mask):
        """Per-query partition-filtered exact scan, one device pass: each
        query's tenant is interned to its code on the host, and the scan
        compares it against the slot codes."""
        c = vc.config
        sc = self._scalars[self.partition_col]
        qcodes = np.array([sc.code_of(v) for v in partitions], dtype=np.int32)
        d, i = bruteforce_knn_internal(
            qp, vc.state.vectors, self._valid(mask),
            metric=c.graph_metric, k=k, normalized=c.normalized,
            slot_codes=self._dev_cached(
                ("codes", self.partition_col),
                lambda: torch.tensor(sc.codes[: self.cap], device=self.device),
            ),
            q_codes=torch.as_tensor(qcodes, device=self.device),
        )
        return _output(c, d), i

    def _hnsw(self, vc: _VectorColumn, qp, k, ef, mask=None):
        c = vc.config
        if isinstance(vc, _MeshVectorColumn):
            d, i = vc.hnsw(qp, k, ef, mask)
            return _output(c, d), i
        fm = None if mask is None else torch.as_tensor(mask, device=self.device)
        d, i = search_graph(c, vc.state, qp, k=k, ef=ef, filter_mask=fm)
        return _output(c, d), i

    def _binary_rerank(
        self, vc: _VectorColumn, qvs, qp, k, mask, use_exact, coarse_k=None, expand=None,
    ):
        """Hamming coarse search + exact rerank in the user metric, batched.

        The index holds mean-threshold sign bits; a Hamming search
        over-fetches ``coarse_k`` candidates (default max(10 k, 96)) and the
        f32 originals rerank them. ``expand`` adds the candidates' level-0
        neighbours to the rerank pool (``expand_rerank_topk``): the default
        when the graph was searched and the device shadow exists. Without a
        shadow (over ``SHADOW_BUDGET_BYTES``, or a mesh-backed column) the
        rerank runs on the host, with no expansion.
        """
        coarse_k = int(coarse_k) if coarse_k else max(10 * k, 96)
        graph_used = not (
            use_exact
            or not vc.has_hnsw
            or (mask is not None and int(mask.sum()) <= 8 * coarse_k)
        )
        if graph_used:
            d, i = self._hnsw(vc, qp, coarse_k, None, mask)
        else:
            d, i = self._exact(vc, qp, coarse_k, mask)
        if vc.shadow is not None:
            ok = i >= 0
            if mask is not None:
                mdev = torch.as_tensor(mask, device=self.device)
                ok &= mdev[i.clamp(0, mask.size - 1).long()]
            qf = torch.as_tensor(
                np.stack([qv.as_f32().astype(np.float32) for qv in qvs]), device=self.device
            )
            if graph_used if expand is None else bool(expand):
                fm = self._live[: vc.config.cap]
                if mask is not None:
                    fm = fm & mask
                return expand_rerank_topk(
                    vc.shadow, vc.state.adj0, i, ok, qf, metric=vc.spec.metric, k=k,
                    filter_mask=torch.tensor(fm, device=self.device),
                )
            return rerank_topk(vc.shadow, i, ok, qf, metric=vc.spec.metric, k=k)
        slots = _host(i)  # [nq, C]
        ok = slots >= 0
        if mask is not None:
            ok &= mask[np.clip(slots, 0, mask.size - 1)]
        safe = np.clip(slots, 0, vc.raw.shape[0] - 1)
        # exact rerank on the stored originals (nq x C rows)
        corpus = vc.raw[safe].astype(np.float32)  # [nq, C, D]
        qf = np.stack([qv.as_f32().astype(np.float32) for qv in qvs])  # [nq, D]
        metric = vc.spec.metric
        if metric is DistanceMetric.L2:
            dd = np.sqrt(((corpus - qf[:, None, :]) ** 2).sum(-1))
        elif metric is DistanceMetric.L1:
            dd = np.abs(corpus - qf[:, None, :]).sum(-1)
        else:  # cosine
            cn = np.linalg.norm(corpus, axis=-1)
            qn = np.linalg.norm(qf, axis=-1)[:, None]
            denom = np.maximum(cn * qn, 1e-30)
            dd = 1.0 - np.einsum("bcd,bd->bc", corpus, qf) / denom
        dd = np.where(ok, dd, np.inf)
        order = np.argsort(dd, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(dd, order, 1).astype(np.float32)
        out_i = np.take_along_axis(slots, order, 1).astype(np.int32)
        out_i = np.where(np.isfinite(out_d), out_i, -1)
        return out_d, out_i

    # ------------------------------------------------------------------ #
    # maintenance
    # ------------------------------------------------------------------ #

    def integrity_check(self) -> list[str]:
        """Validate index invariants. Returns a list of problems (empty =
        OK)."""
        with self._lock:
            self.flush()
            problems = []
            n_live = len(self._rowid_to_slot)
            for cname, vc in self.vector_cols.items():
                if isinstance(vc, _MeshVectorColumn):
                    problems += _mesh_problems(cname, vc, n_live)
                    continue
                st = vc.state
                count = int(st.count)
                if count != n_live:
                    problems.append(
                        f"{cname}: node count {count} != live rows {n_live}"
                    )
                ep = int(st.entry_point)
                if n_live > 0:
                    if ep < 0:
                        problems.append(f"{cname}: missing entry point")
                    elif int(st.levels[ep]) < 0:
                        problems.append(f"{cname}: entry point {ep} is not live")
                elif ep >= 0:
                    problems.append(f"{cname}: entry point set on empty index")
            return problems

    def rebuild(self, column: str, params: HnswParams | None = None) -> None:
        """Rebuild one column's HNSW index from the stored originals, every
        live row at its slot."""
        with self._lock:
            self.flush()
            vc = self.vector_cols[column]
            if params is not None:
                params.validate()
                vc.params = params
            slots = np.array(sorted(self._slot_to_rowid), dtype=np.int32)
            if isinstance(vc, _MeshVectorColumn):
                self._rebuild_mesh(vc, slots)
                return
            if params is not None:
                vc.config = config_for(
                    vc.spec.dimensions,
                    metric=vc.spec.metric,
                    vec_type=vc.spec.vec_type,
                    quantization=vc.spec.quantization,
                    params=params,
                    cap=vc.config.cap,
                )
            if slots.size == 0:
                vc.state = allocate(vc.config, device=self.device)
                return
            raws = vc.raw[slots]
            if vc.spec.vec_type is VectorType.BIT:
                raws = unpack_bits(raws, vc.spec.dimensions)
            prepared = self._prepare_rows(vc, raws)
            vc.state = build_graph(vc.config, prepared, ids=slots, device=self.device)

    def _rebuild_mesh(self, vc: _MeshVectorColumn, slots: np.ndarray) -> None:
        """A fresh sharded index with the same allocation state, then every
        live row re-inserted at its slot."""
        old = vc.idx
        vc.idx = ShardedHnsw(
            vc.mesh,
            vc.spec.dimensions,
            metric=vc.spec.metric,
            params=vc.params,
            cap_per_shard=old.config.cap,
            quantization=vc.spec.quantization,
            vec_type=vc.spec.vec_type or VectorType.FLOAT32,
        )
        for attr in ("_counts", "_free", "_part_codes", "_part_list", "_part_code_of", "_rr"):
            setattr(vc.idx, attr, getattr(old, attr))
        del old
        if slots.size == 0:
            return
        raws = vc.raw[slots]
        if vc.spec.vec_type is VectorType.BIT:
            raws = unpack_bits(raws, vc.spec.dimensions)
        vc.insert_prepared(slots, self._prepare_rows(vc, raws), batch=_FLUSH_THRESHOLD)


def _mesh_problems(cname: str, vc: _MeshVectorColumn, n_live: int) -> list[str]:
    """A mesh column's invariants: node counts sum to the live rows, and
    each shard's entry point is live exactly when the shard has nodes."""
    problems = []
    counts = [int(st.count) for st in vc.idx.states]
    if sum(counts) != n_live:
        problems.append(f"{cname}: node count {sum(counts)} != live rows {n_live}")
    for s, st in enumerate(vc.idx.states):
        ep = int(st.entry_point)
        if counts[s] > 0:
            if ep < 0:
                problems.append(f"{cname}: shard {s} missing entry point")
            elif int(st.levels[ep]) < 0:
                problems.append(f"{cname}: shard {s} entry point {ep} is not live")
        elif ep >= 0:
            problems.append(f"{cname}: shard {s} entry point set on empty index")
    return problems
