"""Core enums and error types: the port's own copy of ``tpuvec/types.py``.

The values are the same strings as the JAX package's, so a config carried
across by ``tpuvec_torch.interop`` maps enum to enum by ``.value``. The
parsing and blob-size helpers arrive with the slices that use them (SQL,
codecs).
"""

from __future__ import annotations

import enum


class TpuVecError(Exception):
    """Base error for tpuvec_torch."""


class InvalidParameter(TpuVecError):
    pass


class VectorType(enum.Enum):
    """Vector element type."""

    FLOAT32 = "float32"
    INT8 = "int8"
    BIT = "bit"


class DistanceMetric(enum.Enum):
    """Distance metric.

    L2     = sqrt(sum((a-b)^2))
    L1     = sum(|a-b|)
    COSINE = 1 - (a.b)/(|a||b|)
    HAMMING= count of differing bits
    """

    L2 = "l2"
    L1 = "l1"
    COSINE = "cosine"
    HAMMING = "hamming"


class IndexQuantization(enum.Enum):
    """How vectors are stored inside the HNSW index: NONE keeps the
    original precision, INT8 is fixed-scale symmetric int8, BINARY is
    mean-threshold sign bits searched by Hamming distance."""

    NONE = "none"
    INT8 = "int8"
    BINARY = "binary"
