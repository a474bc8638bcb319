"""Deterministic HNSW level sampling (host, numpy).

Levels are a pure function of (rng_seed, node id): a splitmix32-style
integer hash of the id, mapped to u in (0, 1], then
level = floor(-ln(u) * level_factor), capped at max_level. The integer
hash is bit-identical to the JAX package's; the float log can differ at
ulp-boundary ids, where a level differs by one (any level assignment
gives a valid graph). Levels are computed here on the host because
torch's uint32 arithmetic is too thin to carry the hash.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_levels_np"]

_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35


def _mix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_MIX1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_MIX2)
    h ^= h >> np.uint32(16)
    return h


def sample_levels_np(ids: np.ndarray, seed: int, level_factor: float, max_level: int) -> np.ndarray:
    """Levels for node ids."""
    with np.errstate(over="ignore"):
        h = (np.asarray(ids, dtype=np.uint32) + np.uint32(1)) * np.uint32(_GOLDEN)
        h = _mix32_np(h ^ np.uint32(seed & 0xFFFFFFFF))
    # uniform in (0, 1]: use top 24 bits, never zero
    u = ((h >> np.uint32(8)).astype(np.float32) + np.float32(1.0)) / np.float32(1 << 24)
    lv = np.floor(-np.log(u) * np.float32(level_factor)).astype(np.int32)
    return np.minimum(lv, np.int32(max_level))
