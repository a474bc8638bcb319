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
* ``__meta__``: the UTF-8 JSON record as a uint8 array.

Two engines write it: the native tvstore (``tpuvec_torch/native.py``:
mmap + CRC) and ``np.savez_compressed``. Both write a temporary file and
rename it, so a reader never sees a torn snapshot.

Where the port differs: ``load`` takes ``device=`` (default ``"cuda"``);
mesh-backed snapshots are not ported yet and raise
``NotImplementedError``; a scalar value that JSON would not bring back as
itself (a tuple) raises ``InvalidState`` at save, where the JAX package
writes a file it cannot load.
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
from tpuvec_torch.store.table import ColumnSpec, VecTable
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

_NOT_PORTED = (
    "mesh-backed snapshots are not ported yet (parallel/sharding.py; "
    "ROADMAP.md, queue 1, item 4)"
)


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
    meta_json = json.dumps(meta)
    if table.device.type == "cuda":
        torch.cuda.synchronize(table.device)
    arrays: dict[str, np.ndarray] = {}
    for cname, vc in table.vector_cols.items():
        arrays[f"raw::{cname}"] = vc.raw
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
    order the file lists them."""
    if mesh is not None:
        raise NotImplementedError(_NOT_PORTED)
    dev = resolve(device)
    z = _open_archive(path)
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    if meta.get("format_version") not in _READABLE_VERSIONS:
        raise InvalidState(f"unsupported snapshot format {meta.get('format_version')}")
    if meta.get("mesh") is not None:
        raise NotImplementedError(_NOT_PORTED)
    # v1 snapshots written before the upper-array flattening carry
    # [cap_u, LU, M] arrays; the runtime layout is [cap_u, LU*M]
    for key in list(z):
        if key.endswith("::upper_adj") or key.endswith("::upper_dist"):
            if z[key].ndim == 3:
                z[key] = z[key].reshape(z[key].shape[0], -1)
    columns = [_spec_from_json(c) for c in meta["columns"]]
    table = VecTable(
        meta["name"],
        columns,
        index_type=IndexType.parse(meta["index_type"]),
        initial_cap=128,
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
