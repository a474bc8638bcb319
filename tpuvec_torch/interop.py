"""Carry a graph and its config across packages as numpy.

``state_to_numpy`` / ``state_from_numpy`` move a GraphState field by field
(the JAX package's GraphState has the same field names, dtypes and
shapes); ``config_to_dict`` / ``config_from_dict`` move an HnswConfig with
its enums by ``.value``. Nothing here imports JAX: a caller that holds
the JAX package wraps the dicts into its types itself.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from tpuvec_torch.device import resolve
from tpuvec_torch.index.graph import GraphState, HnswConfig
from tpuvec_torch.types import DistanceMetric, IndexQuantization, VectorType

__all__ = ["state_to_numpy", "state_from_numpy", "config_to_dict", "config_from_dict"]

_ENUMS = {"metric": DistanceMetric, "vec_type": VectorType, "quantization": IndexQuantization}


def state_to_numpy(state: GraphState) -> dict[str, np.ndarray]:
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(GraphState)
    }


def state_from_numpy(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cuda"
) -> GraphState:
    dev = resolve(device)
    return GraphState(
        **{
            f.name: torch.from_numpy(np.array(arrays[f.name], copy=True)).to(dev)
            for f in dataclasses.fields(GraphState)
        }
    )


def config_to_dict(config: HnswConfig) -> dict:
    return {
        k: (v.value if isinstance(v, enum.Enum) else v)
        for k, v in dataclasses.asdict(config).items()
    }


def config_from_dict(d: dict) -> HnswConfig:
    return HnswConfig(**{k: (_ENUMS[k](v) if k in _ENUMS else v) for k, v in d.items()})
