"""HNSW parameters: the port's own copy of ``tpuvec/index/params.py``."""

from __future__ import annotations

import math
from dataclasses import dataclass

from tpuvec_torch.types import InvalidParameter


@dataclass(frozen=True)
class HnswParams:
    """HNSW index parameters (defaults M=32, max_M0=64, ef_c=400, ef_s=200).

    ``level_factor`` is 1/ln(M) (exponential level decay).
    ``simple_prune``: True = closest-M neighbor selection; False = RNG
    diversity heuristic for forward-edge selection (the default).
    ``build_max_iters``: iteration budget of the construction candidate
    beam; None derives it from ef_construction and the capacity.
    """

    m: int = 32
    max_m0: int = 64
    ef_construction: int = 400
    ef_search: int = 200
    max_level: int = 16
    simple_prune: bool = False
    rng_seed: int = 0x5EED
    build_max_iters: int | None = None

    @property
    def level_factor(self) -> float:
        return 1.0 / math.log(self.m)

    def validate(self) -> None:
        if not (2 <= self.m <= 256):
            raise InvalidParameter(f"M must be in [2, 256], got {self.m}")
        if not (10 <= self.ef_construction <= 4096):
            raise InvalidParameter(
                f"ef_construction must be in [10, 4096], got {self.ef_construction}"
            )
        if self.max_m0 < self.m:
            raise InvalidParameter("max_m0 must be >= M")
