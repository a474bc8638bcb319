"""Carry a graph and its config across packages as numpy.

``state_to_numpy`` / ``state_from_numpy`` move a GraphState field by field
(the JAX package's GraphState has the same field names, dtypes and
shapes, except that the port holds packed bit words as int32 where the
JAX package holds uint32: they cross as ``np.uint32`` views of the same
bits, never as value casts); ``states_to_numpy`` / ``states_from_numpy``
move the S shards of a mesh as fields stacked ``[S, ...]``, the JAX
package's stacked layout; ``config_to_dict`` / ``config_from_dict`` move an
HnswConfig with its enums by ``.value``. Nothing here imports JAX: a caller that holds
the JAX package wraps the dicts into its types itself.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np
import torch

from tpuvec_torch.device import resolve
from tpuvec_torch.index.graph import GraphState, HnswConfig, as_store_tensor
from tpuvec_torch.types import DistanceMetric, IndexQuantization, VectorType

__all__ = [
    "state_to_numpy", "state_from_numpy", "states_to_numpy", "states_from_numpy",
    "config_to_dict", "config_from_dict",
]

_ENUMS = {"metric": DistanceMetric, "vec_type": VectorType, "quantization": IndexQuantization}


def state_to_numpy(state: GraphState) -> dict[str, np.ndarray]:
    out = {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(GraphState)
    }
    if out["vectors"].dtype == np.int32:  # int32 rows are always packed words
        out["vectors"] = out["vectors"].view(np.uint32)
    return out


def state_from_numpy(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> GraphState:
    dev = resolve(device)
    return GraphState(
        **{
            f.name: as_store_tensor(np.array(arrays[f.name], copy=True), device=dev)
            for f in dataclasses.fields(GraphState)
        }
    )


def states_to_numpy(states: Sequence[GraphState]) -> dict[str, np.ndarray]:
    """Per-shard states -> each field stacked ``[S, ...]`` (scalars ``[S]``)."""
    per = [state_to_numpy(s) for s in states]
    return {f: np.stack([p[f] for p in per]) for f in per[0]}


def states_from_numpy(
    arrays: dict[str, np.ndarray], devices: Sequence[str | torch.device]
) -> list[GraphState]:
    """Fields stacked ``[S, ...]`` -> S states, shard ``s`` on ``devices[s]``."""
    return [
        state_from_numpy({f: a[s] for f, a in arrays.items()}, device=dev)
        for s, dev in enumerate(devices)
    ]


def config_to_dict(config: HnswConfig) -> dict:
    return {
        k: (v.value if isinstance(v, enum.Enum) else v)
        for k, v in dataclasses.asdict(config).items()
    }


def config_from_dict(d: dict) -> HnswConfig:
    return HnswConfig(**{k: (_ENUMS[k](v) if k in _ENUMS else v) for k, v in d.items()})
