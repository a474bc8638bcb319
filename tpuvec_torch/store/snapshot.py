"""Snapshot / restore: host-side persistence of a VecTable. The port of
``tpuvec/store/snapshot.py`` for one device.

The table's authoritative state lives on the device, so persistence is an
explicit snapshot: the graph tensors are copied to the host and written,
with the host originals and a JSON record of the schema and the row
mapping, as one file of named arrays; restore moves the arrays back to
the device. The format is the JAX package's, array for array, so a
snapshot written by either package loads in the other:

* ``raw::<col>``: the host originals of each vector column;
* ``graph::<col>::<field>``: each GraphState field; packed bit words are
  ``uint32`` in the file (the port's int32 words cross as views, never as
  value casts: ``interop.state_to_numpy`` / ``state_from_numpy``);
* ``__meta__``: the UTF-8 JSON record as a uint8 array; a mesh-backed
  table's adds a ``"mesh"`` key (shard count, per-shard high-water counts
  and free lists, both round-robin pointers), and its graph fields are
  stacked ``[S, ...]``.

Two engines write it: the native tvstore (``tpuvec_torch/native.py``:
mmap + CRC) and ``np.savez_compressed``. Both write a temporary file and
rename it, so a reader never sees a torn snapshot.

Where the port differs: ``load`` takes ``device=`` (default ``"cuda"``;
a mesh-backed table loads onto its mesh's devices instead); a scalar value
that JSON would not bring back as itself (a tuple) raises ``InvalidState``
at save, where the JAX package writes a file it cannot load.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from tpuvec_torch import interop, native
from tpuvec_torch.device import resolve
from tpuvec_torch.index.params import HnswParams
from tpuvec_torch.store.table import ColumnSpec, VecTable, _MeshVectorColumn
from tpuvec_torch.types import (
    DistanceMetric,
    IndexQuantization,
    IndexType,
    InvalidState,
    VectorType,
)

__all__ = ["save", "load", "FORMAT_VERSION"]

# v1: original layout (upper_adj/upper_dist were [cap_u, LU, M] 3D early on,
#     later flattened to [cap_u, LU*M] without a bump — load() reshapes).
# v2: upper arrays are always 2D [cap_u, LU*M].
FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)

_GRAPH_FIELDS = [
    "vectors",
    "adj0",
    "adj0_dist",
    "levels",
    "upper_slot",
    "upper_nodes",
    "upper_adj",
    "upper_dist",
    "entry_point",
    "entry_level",
    "count",
    "upper_count",
]

def _spec_to_json(spec: ColumnSpec) -> dict:
    d = {
        "name": spec.name,
        "kind": spec.kind,
        "dimensions": spec.dimensions,
        "metric": spec.metric.value,
        "hnsw": spec.hnsw,
        "quantization": spec.quantization.value,
    }
    if spec.vec_type is not None:
        d["vec_type"] = spec.vec_type.value
    if spec.params is not None:
        d["params"] = dataclasses.asdict(spec.params)
    return d


def _spec_from_json(d: dict) -> ColumnSpec:
    return ColumnSpec(
        name=d["name"],
        kind=d["kind"],
        vec_type=VectorType.parse(d["vec_type"]) if "vec_type" in d else None,
        dimensions=d.get("dimensions", 0),
        metric=DistanceMetric.parse(d.get("metric", "cosine")),
        hnsw=d.get("hnsw", False),
        params=HnswParams(**d["params"]) if "params" in d else None,
        quantization=IndexQuantization.parse(d.get("quantization", "none")),
    )


def _scalar_data(table: VecTable) -> dict:
    """Each scalar column's non-NULL values by rowid (as a string), in
    the order of the rowid map: a load interns them again in that order."""
    out = {}
    for cname, sc in table._scalars.items():
        vals = {}
        for rid, slot in table._rowid_to_slot.items():
            v = sc.get(slot)
            if v is None:
                continue
            if not isinstance(v, (str, int, float)):
                raise InvalidState(
                    "snapshot requires JSON-serializable scalar column values "
                    f"(int/float/str/bool/None): column '{cname}' holds "
                    f"{type(v).__name__} {v!r}"
                )
            vals[str(rid)] = v
        out[cname] = vals
    return out


def save(table: VecTable, path: str, *, engine: str = "auto") -> None:
    """Write a snapshot atomically (tmp file + rename).

    engine: "auto" uses the native tvstore (mmap + CRC, csrc/) when the
    library is available and the path does not end in .npz; "npz" forces
    ``np.savez_compressed``; "native" requires tvstore and raises
    RuntimeError when it cannot be built.

    The graph's device-to-host copies follow ``torch.cuda.synchronize``
    of the table's device, so they see every launch made before the call,
    from any thread (autosave runs here on its own thread).
    """
    if engine not in ("auto", "native", "npz"):
        raise ValueError(f"unknown snapshot engine {engine!r}")
    table.flush()
    if engine == "auto":
        engine = "native" if native.available() and not path.endswith(".npz") else "npz"
    meta = {
        "format_version": FORMAT_VERSION,
        "name": table.name,
        "index_type": table.index_type.value,
        "columns": [_spec_to_json(c) for c in table.columns],
        "rowid_to_slot": {str(k): v for k, v in table._rowid_to_slot.items()},
        "max_rowid": table._max_rowid,
        "next_slot": table._next_slot,
        "free_slots": table._free_slots,
        "scalar_data": _scalar_data(table),
    }
    devices = [table.device]
    if table.mesh is not None:
        vc = next(iter(table.vector_cols.values()))
        meta["mesh"] = {
            "n_shards": vc.idx.n_shards,
            "counts": vc.idx._counts.tolist(),
            "free": [list(f) for f in vc.idx._free],
            "rr": vc.idx._rr,
            "table_rr": table._rr,
        }
        devices = list(table.mesh.devices)
    meta_json = json.dumps(meta)
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    arrays: dict[str, np.ndarray] = {}
    for cname, vc in table.vector_cols.items():
        arrays[f"raw::{cname}"] = vc.raw
        if isinstance(vc, _MeshVectorColumn):
            state = interop.states_to_numpy(vc.idx.states)
        else:
            state = interop.state_to_numpy(vc.state)
        for f in _GRAPH_FIELDS:
            arrays[f"graph::{cname}::{f}"] = state[f]
    arrays["__meta__"] = np.frombuffer(meta_json.encode("utf-8"), dtype=np.uint8)

    if engine == "native":
        w = native.TvsWriter(path)
        try:
            for name, arr in arrays.items():
                w.add(name, arr)
            w.finish()
        except BaseException:
            w.abort()
            raise
        return

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _open_archive(path: str) -> dict[str, np.ndarray]:
    """Every array of the file, sniffing tvstore vs npz."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"TPVS":
        r = native.TvsReader(path)
        try:
            return r.read_all()
        finally:
            r.close()
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load(path: str, mesh=None, *, device: str | torch.device = "cuda") -> VecTable:
    """Restore a VecTable from a snapshot file (tvstore or npz) onto
    ``device``. The table starts with no pending rows, a fresh mutation
    version and no device caches; scalar values are interned again in the
    order the file lists them.

    A mesh-backed snapshot needs a ``mesh`` with the same shard count and
    loads onto its devices; a ``mesh`` given for a single-device snapshot
    is not used."""
    z = _open_archive(path)
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    if meta.get("format_version") not in _READABLE_VERSIONS:
        raise InvalidState(f"unsupported snapshot format {meta.get('format_version')}")
    mesh_meta = meta.get("mesh")
    if mesh_meta is not None:
        if mesh is None:
            raise InvalidState(
                "snapshot is mesh-backed: pass load(path, mesh=...) with "
                f"{mesh_meta['n_shards']} devices"
            )
        if mesh.devices.size != mesh_meta["n_shards"]:
            raise InvalidState(
                f"snapshot has {mesh_meta['n_shards']} shards, mesh has {mesh.devices.size}"
            )
        dev = mesh.devices[0]
    else:
        mesh = None
        dev = resolve(device)
    # v1 snapshots written before the upper-array flattening carry
    # [cap_u, LU, M] arrays; the runtime layout is [cap_u, LU*M]. Mesh
    # snapshots stack a leading shard axis, so the expected rank is one
    # higher there
    expect_ndim = 2 if mesh is None else 3
    for key in list(z):
        if key.endswith("::upper_adj") or key.endswith("::upper_dist"):
            if z[key].ndim == expect_ndim + 1:
                z[key] = z[key].reshape(*z[key].shape[: expect_ndim - 1], -1)
    columns = [_spec_from_json(c) for c in meta["columns"]]
    table = VecTable(
        meta["name"],
        columns,
        index_type=IndexType.parse(meta["index_type"]),
        initial_cap=128 if mesh is None else 1,
        mesh=mesh,
        device=dev,
    )
    table._rowid_to_slot = {int(k): v for k, v in meta["rowid_to_slot"].items()}
    table._slot_to_rowid = {v: k for k, v in table._rowid_to_slot.items()}
    table._max_rowid = meta["max_rowid"]
    table._next_slot = meta["next_slot"]
    table._free_slots = list(meta["free_slots"])
    table._grow_host(max(max(table._slot_to_rowid, default=0) + 1, table._next_slot, 1))
    table._live[list(table._slot_to_rowid)] = True
    for cname, vals in meta["scalar_data"].items():
        sc = table._scalars[cname]
        for rid_s, v in vals.items():
            sc.set(table._rowid_to_slot[int(rid_s)], v)
    for cname, vc in table.vector_cols.items():
        raw = z.pop(f"raw::{cname}")
        if isinstance(vc, _MeshVectorColumn):
            _load_mesh_column(table, vc, cname, raw, z, mesh_meta)
            continue
        cap = raw.shape[0]
        if cap != vc.config.cap:
            vc.config = dataclasses.replace(
                vc.config, cap=cap, cap_u=z[f"graph::{cname}::upper_nodes"].shape[0]
            )
        vc.raw = raw  # both readers return fresh, writable arrays
        vc.state = interop.state_from_numpy(
            {f: z.pop(f"graph::{cname}::{f}") for f in _GRAPH_FIELDS}, device=dev
        )
        vc.refresh_shadow()  # the device rerank copy follows the originals
    # host slot arrays (_live, scalar columns) must cover the FULL slot
    # capacity, not just the high-water slot: exact-scan paths reshape
    # the live mask against cap, and clamped gathers against a short
    # mask silently mis-filter
    table._grow_host(table.cap)
    return table


def _load_mesh_column(table: VecTable, vc: _MeshVectorColumn, cname: str, raw, z, mesh_meta) -> None:
    """The sharded index of a mesh-backed column from the file: the stacked
    graph fields, the allocation state of the ``"mesh"`` meta key, and the
    partition codes rebuilt from the table's partition column (the one
    source of truth), interned in rowid-map order."""
    idx = vc.idx
    cap = int(z[f"graph::{cname}::vectors"].shape[1])
    if cap != idx.config.cap:
        idx.config = dataclasses.replace(
            idx.config, cap=cap, cap_u=int(z[f"graph::{cname}::upper_nodes"].shape[1])
        )
    vc.raw = raw
    idx.states = interop.states_from_numpy(
        {f: z.pop(f"graph::{cname}::{f}") for f in _GRAPH_FIELDS}, idx.mesh.devices
    )
    idx._counts = np.asarray(mesh_meta["counts"], dtype=np.int64)
    idx._free = [list(f) for f in mesh_meta["free"]]
    idx._rr = mesh_meta["rr"]
    table._rr = mesh_meta["table_rr"]
    idx._part_codes = np.full((idx.n_shards, cap), -1, dtype=np.int32)
    if table.partition_col is not None:
        sc = table._scalars[table.partition_col]
        for slot in table._rowid_to_slot.values():
            v = sc.get(slot)
            if v is not None:
                s, sl = divmod(slot, cap)
                idx._part_codes[s, sl] = idx._intern_partition(v)
