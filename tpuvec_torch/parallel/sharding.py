"""Corpus sharding over a mesh of logical shards. The port of
``tpuvec/parallel/sharding.py``.

As in the JAX package:

* every shard holds an independent HNSW sub-index over its slice of the
  corpus;
* inserts route to shards (partition-key affinity, ``crc32(repr(value))
  % S``, so one tenant's rows co-locate and a filtered query touches one
  shard; otherwise round robin) and run on one shared schedule of
  ``insert_batch`` rounds;
* a query runs on every shard and the per-shard top-k lists merge into one;
* local slot ids map to global ids as ``shard * cap + slot``.

Where the port differs: the port runs in one process, and a mesh is a list
of S logical shards, each on a torch device (``make_mesh``): on one card
all S shards live on ``cuda:0``, in the tests on the CPU. Global ids,
routing and files depend only on S. The shards are a list of S
``GraphState``s, stacked ``[S, ...]`` only in the file. The shard_map
all-gather is a concatenation to ``[B, S*k]`` and one stable sort. A round
gives ``insert_batch`` only a shard's own rows, at the JAX package's padded
width ``batch``; a shard with no rows in a round runs nothing (an all-pad
batch leaves a graph as it is). Deletes pass a shard's ids unpadded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zlib

import numpy as np
import torch

from tpuvec_torch import interop
from tpuvec_torch.device import resolve
from tpuvec_torch.index.bruteforce import bruteforce_knn_internal
from tpuvec_torch.index.build import delete_ids, insert_batch, plan_batch_sizes
from tpuvec_torch.index.graph import (
    GraphState,
    HnswConfig,
    _ceil_to,
    allocate,
    config_for,
    grow_state,
    prepare_vectors,
)
from tpuvec_torch.index.params import HnswParams
from tpuvec_torch.index.search import search_graph
from tpuvec_torch.ops.distance import internal_to_output
from tpuvec_torch.types import DistanceMetric, IndexQuantization, VectorType
from tpuvec_torch.utils.prng import sample_levels_np

__all__ = [
    "Mesh",
    "ShardedHnsw",
    "ShardFullError",
    "make_mesh",
    "save_sharded",
    "load_sharded",
]

_INF = float("inf")


class ShardFullError(RuntimeError):
    """A shard's slot capacity is exhausted; grow() or raise cap_per_shard."""


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """S logical shards: ``devices`` is an object array of S torch devices
    (``devices.size`` is the shard count), ``axis_names`` the one axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]


def make_mesh(
    n_devices: int | None = None, axis: str = "shard", *, device: str | torch.device = "cuda"
) -> Mesh:
    """A mesh of ``n_devices`` shards (default: one per visible device of
    ``device``'s type), shard ``s`` on the ``s % count``-th of them. Raises
    without a card unless the caller passes ``device="cpu"``."""
    kind = resolve(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    n = count if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    devs = np.empty(n, dtype=object)
    for s in range(n):
        devs[s] = torch.device(kind, s % count) if kind == "cuda" else torch.device(kind)
    return Mesh(devs, (axis,))


def _global_ids(i: torch.Tensor, shard: int, cap: int) -> torch.Tensor:
    return torch.where(i >= 0, shard * cap + i, -1)


def _merge_shards(dists: list[torch.Tensor], ids: list[torch.Tensor], k: int):
    """Per-shard (dists [B, k], global ids [B, k]) -> the k smallest over
    all shards [B, k], ascending, on the first shard's device; ties keep
    the lower shard first."""
    dev = dists[0].device
    d_all = torch.cat([d.to(dev) for d in dists], dim=1)
    i_all = torch.cat([i.to(dev) for i in ids], dim=1)
    order = torch.sort(d_all, dim=1, stable=True).indices[:, :k]
    return torch.gather(d_all, 1, order), torch.gather(i_all, 1, order)


def _sharded_search(
    config: HnswConfig,
    states: list[GraphState],
    q: torch.Tensor,
    *,
    k: int,
    ef: int | None,
    n_expand: int = 1,
    masks: list[torch.Tensor] | None = None,
):
    """All-shard search + top-k merge in internal distance. q [B, Dp]
    prepared; ``masks`` one [cap] bool filter per shard, optional."""
    dists, ids = [], []
    for s, state in enumerate(states):
        d, i = search_graph(
            config, state, q.to(state.vectors.device), k=k, ef=ef, n_expand=n_expand,
            filter_mask=None if masks is None else masks[s],
        )
        dists.append(d)
        ids.append(_global_ids(i, s, config.cap))
    return _merge_shards(dists, ids, k)


def _sharded_exact(
    config: HnswConfig,
    states: list[GraphState],
    q: torch.Tensor,
    valid: list[torch.Tensor],
    *,
    k: int,
):
    """Exact sharded scan: each shard's brute force over its valid slots,
    then the global top-k merge, in internal distance."""
    dists, ids = [], []
    for s, state in enumerate(states):
        d, i = bruteforce_knn_internal(
            q.to(state.vectors.device), state.vectors, valid[s],
            metric=config.graph_metric, k=k, normalized=config.normalized,
        )
        dists.append(d)
        ids.append(_global_ids(i, s, config.cap))
    return _merge_shards(dists, ids, k)


def _sharded_delete(
    config: HnswConfig, states: list[GraphState], ids: list[list[int]]
) -> list[GraphState]:
    """``delete_ids`` of each shard's local slot ids on its own sub-graph
    (inbound-edge scrub + entry reselection)."""
    return [
        delete_ids(config, state, torch.tensor(sl, dtype=torch.int32, device=state.vectors.device))
        for state, sl in zip(states, ids)
    ]


class ShardedHnsw:
    """A partitioned HNSW index across a mesh of shards.

    >>> mesh = make_mesh(8, device="cpu")
    >>> idx = ShardedHnsw(mesh, dim=64, metric=DistanceMetric.L2)
    >>> idx.add(vectors, partitions=tenant_ids)
    >>> dists, global_ids = idx.search(queries, k=10)
    """

    def __init__(
        self,
        mesh: Mesh,
        dim: int,
        *,
        metric: DistanceMetric,
        params: HnswParams | None = None,
        cap_per_shard: int = 4096,
        quantization: IndexQuantization | None = None,
        vec_type: VectorType | None = None,
    ):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.devices.size
        self.config = config_for(
            dim,
            metric=metric,
            vec_type=vec_type or VectorType.FLOAT32,
            quantization=quantization or IndexQuantization.NONE,
            params=params,
            cap=cap_per_shard,
        )
        self.states = [allocate(self.config, device=dev) for dev in mesh.devices]
        self._counts = np.zeros(self.n_shards, dtype=np.int64)  # high-water
        self._free: list[list[int]] = [[] for _ in range(self.n_shards)]
        self._rr = 0  # round-robin pointer
        # partition value per (shard, slot), interned to int32 codes: several
        # tenants can hash to one shard, and a query filters exactly within it
        self._part_codes = np.full((self.n_shards, self.config.cap), -1, dtype=np.int32)
        self._part_list: list = []
        self._part_code_of: dict = {}

    # ---------------------------------------------------------------- #

    def __len__(self) -> int:
        return int(self._counts.sum()) - sum(len(f) for f in self._free)

    def shard_of_partition(self, partition) -> int:
        # stable across processes (Python's hash() is salted per run)
        return zlib.crc32(repr(partition).encode()) % self.n_shards

    def _intern_partition(self, value) -> int:
        code = self._part_code_of.get(value)
        if code is None:
            code = len(self._part_list)
            self._part_list.append(value)
            self._part_code_of[value] = code
        return code

    def _assign(self, n: int, partitions) -> np.ndarray:
        if partitions is not None:
            return np.array([self.shard_of_partition(p) for p in partitions], dtype=np.int64)
        out = (np.arange(n) + self._rr) % self.n_shards
        self._rr = int((self._rr + n) % self.n_shards)
        return out

    def _alloc_slot(self, s: int) -> int:
        if self._free[s]:
            return self._free[s].pop()
        slot = int(self._counts[s])
        if slot >= self.config.cap:
            raise ShardFullError(
                f"shard {s} over capacity ({self.config.cap}); "
                "raise cap_per_shard or call grow()"
            )
        self._counts[s] += 1
        return slot

    def grow(self, new_cap_per_shard: int) -> None:
        """Grow per-shard capacity in place: every shard's arrays are padded
        along the slot axis, and the sub-graphs carry over (adjacency holds
        LOCAL slot ids). Global ids change meaning (shard * cap + slot):
        callers holding old global ids remap them as
        ``(g // old_cap) * new_cap + g % old_cap`` (VecTable does)."""
        old = self.config
        new_cap = max(_ceil_to(new_cap_per_shard, 128), 128)
        if new_cap <= old.cap:
            return
        self.config = dataclasses.replace(
            old, cap=new_cap, cap_u=max(_ceil_to(new_cap // 8, 128), 128)
        )
        c = self.config
        self.states = [grow_state(st, c.cap, c.cap_u) for st in self.states]
        codes = np.full((self.n_shards, c.cap), -1, dtype=np.int32)
        codes[:, : old.cap] = self._part_codes
        self._part_codes = codes

    def add(self, vectors, *, partitions=None, batch: int = 256) -> np.ndarray:
        """Insert vectors; returns global ids [n]. Vectors are raw (they are
        prepared here); ``partitions`` optionally routes rows to shards."""
        n = vectors.shape[0]
        shard_ix = self._assign(n, partitions)
        prepared = prepare_vectors(self.config, vectors, device=self.mesh.devices[0])
        slots = np.empty(n, dtype=np.int64)
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for row, s in enumerate(shard_ix):
            slots[row] = self._alloc_slot(int(s))
            per_shard[s].append(row)
            if partitions is not None:
                self._part_codes[s, slots[row]] = self._intern_partition(partitions[row])
        self._insert_rows(per_shard, slots, prepared, batch)
        return shard_ix * self.config.cap + slots

    def _insert_rows(self, per_shard, slots, prepared: torch.Tensor, batch: int, start: int = 1) -> None:
        """Interleave per-shard rows into insert rounds on one schedule for
        every shard: ``plan_batch_sizes`` over the largest shard's rows, each
        shard taking up to the round's size from its own. Levels come from
        the LOCAL slot ids, and each ``insert_batch`` gets the padded width
        ``batch``, as the JAX package pads every shard's round to it.
        ``start`` seeds the doubling schedule with the current per-shard
        graph size, so warm incremental flushes skip the tiny rounds."""
        c = self.config
        slots = np.asarray(slots)
        max_rows = max((len(rows) for rows in per_shard), default=0)
        pos = [0] * self.n_shards
        for take in plan_batch_sizes(max_rows, batch, start=start):
            for s in range(self.n_shards):
                rows = per_shard[s][pos[s] : pos[s] + take]
                pos[s] += len(rows)
                if not rows:
                    continue
                dev = self.mesh.devices[s]
                ids = slots[rows].astype(np.int32)
                levels = sample_levels_np(ids, c.rng_seed, c.level_factor, c.lu)
                self.states[s] = insert_batch(
                    c,
                    self.states[s],
                    torch.as_tensor(ids, device=dev),
                    prepared[torch.as_tensor(rows, device=prepared.device)].to(dev),
                    torch.as_tensor(levels, device=dev),
                    width=batch,
                )

    def delete(self, global_ids) -> None:
        """Delete by global id (edge scrub + per-shard entry reselection, as
        VecTable.delete_many). Slots are recycled."""
        gids = np.asarray(global_ids, dtype=np.int64).ravel()
        if gids.size == 0:
            return
        cap = self.config.cap
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for g in gids:
            s, sl = divmod(int(g), cap)
            if sl in self._free[s] or sl >= self._counts[s]:
                raise KeyError(f"global id {s * cap + sl} not live")
            per_shard[s].append(sl)
        for s, sl_list in enumerate(per_shard):
            self._free[s].extend(sl_list)
            self._part_codes[s, sl_list] = -1
        self.states = _sharded_delete(self.config, self.states, per_shard)

    def update(self, global_ids, vectors, *, partitions=None, batch: int = 256) -> None:
        """Replace vectors in place (delete + re-insert at the same slots):
        global ids stay stable. Without ``partitions`` each slot keeps its
        partition."""
        gids = np.asarray(global_ids, dtype=np.int64).ravel()
        cap = self.config.cap
        shard, slot = gids // cap, gids % cap
        # delete() clears the codes; keep the old ones for the re-insert
        old_codes = [int(self._part_codes[int(s), int(sl)]) for s, sl in zip(shard, slot)]
        self.delete(gids)
        prepared = prepare_vectors(self.config, vectors, device=self.mesh.devices[0])
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for row, (s, sl) in enumerate(zip(shard, slot)):
            s, sl = int(s), int(sl)
            self._free[s].remove(sl)
            per_shard[s].append(row)
            if partitions is not None:
                self._part_codes[s, sl] = self._intern_partition(partitions[row])
            else:
                self._part_codes[s, sl] = old_codes[row]
        self._insert_rows(per_shard, slot, prepared, batch)

    def search(
        self,
        queries,
        *,
        k: int,
        ef: int | None = None,
        n_expand: int = 1,
        partition=None,
    ):
        """KNN across all shards, or on one shard when ``partition`` is given.

        Returns (dists [B, k] in the user metric, global ids [B, k]), on the
        first shard's device (the partition's shard's with ``partition``).
        A partition runs the in-beam filtered search on its shard when it
        has more than 50 k members, else (or when a query comes back short
        of min(k, members)) the exact masked scan; an unknown partition
        matches nothing."""
        c = self.config
        qp = prepare_vectors(c, queries, device=self.mesh.devices[0])
        if partition is not None:
            s = self.shard_of_partition(partition)
            state = self.states[s]
            dev = self.mesh.devices[s]
            qs = qp.to(dev)
            code = self._part_code_of.get(partition, -2)
            member_np = self._part_codes[s] == code
            n_member = int(member_np.sum())
            member = torch.as_tensor(member_np, device=dev)
            d = i = None
            if n_member > 50 * k:
                d, i = search_graph(
                    c, state, qs, k=k, ef=ef, n_expand=n_expand, filter_mask=member
                )
                if int((i >= 0).sum(dim=1).min()) < min(k, n_member):
                    d = i = None
            if d is None:
                d, i = bruteforce_knn_internal(
                    qs, state.vectors, member,
                    metric=c.graph_metric, k=k, normalized=c.normalized,
                )
            gi = _global_ids(i, s, c.cap)
        else:
            d, gi = _sharded_search(c, self.states, qp, k=k, ef=ef, n_expand=n_expand)
        out = internal_to_output(c.metric, d, normalized=c.normalized)
        return torch.where(torch.isfinite(d), out, _INF), gi


# ---------------------------------------------------------------------- #
# persistence: the JAX package's sharded file, array for array
# ---------------------------------------------------------------------- #

_SHARD_GRAPH_FIELDS = [
    "vectors", "adj0", "adj0_dist", "levels", "upper_slot", "upper_nodes",
    "upper_adj", "upper_dist", "entry_point", "entry_level", "count",
    "upper_count",
]


def save_sharded(idx: ShardedHnsw, path: str) -> None:
    """Snapshot a ShardedHnsw to one .npz (version 2: every graph field
    stacked [S, ...], the partition codes, the JSON meta), atomically."""
    meta = {
        "version": 2,
        "n_shards": idx.n_shards,
        "axis": idx.axis,
        "counts": idx._counts.tolist(),
        "free": [list(f) for f in idx._free],
        "rr": idx._rr,
        "config": interop.config_to_dict(idx.config),
        # interned partition values as JSON; the codes ride as an array
        "part_values": idx._part_list,
    }
    try:
        meta_json = json.dumps(meta)
    except TypeError as e:
        raise ValueError(
            "save_sharded requires JSON-serializable partition values "
            f"(int/float/str/bool/None): {e}"
        ) from None
    arrays = interop.states_to_numpy(idx.states)
    arrays["__part_codes__"] = idx._part_codes
    arrays["__meta__"] = np.frombuffer(meta_json.encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_sharded(path: str, mesh: Mesh) -> ShardedHnsw:
    """Restore a ShardedHnsw onto a mesh with the same shard count."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != 2:
            raise ValueError(f"unsupported sharded-snapshot version {meta.get('version')}")
        cfgd = dict(meta["config"])
        if mesh.devices.size != meta["n_shards"]:
            raise ValueError(
                f"snapshot has {meta['n_shards']} shards, mesh has {mesh.devices.size}"
            )
        idx = ShardedHnsw(
            mesh,
            cfgd["dim"],
            metric=DistanceMetric.parse(cfgd["metric"]),
            params=HnswParams(
                m=cfgd["m"], max_m0=cfgd["max_m0"],
                ef_construction=cfgd["ef_construction"],
                ef_search=cfgd["ef_search"],
                rng_seed=cfgd["rng_seed"],
                simple_prune=cfgd["simple_prune"],
            ),
            cap_per_shard=cfgd["cap"],
            quantization=IndexQuantization.parse(cfgd["quantization"]),
            vec_type=VectorType.parse(cfgd["vec_type"]),
        )
        idx.states = interop.states_from_numpy(
            {f: z[f] for f in _SHARD_GRAPH_FIELDS}, mesh.devices
        )
        idx._counts = np.asarray(meta["counts"], dtype=np.int64)
        idx._free = [list(f) for f in meta["free"]]
        idx._rr = meta["rr"]
        idx._part_codes = np.asarray(z["__part_codes__"], dtype=np.int32)
        idx._part_list = list(meta["part_values"])
        idx._part_code_of = {v: c for c, v in enumerate(idx._part_list)}
    return idx
