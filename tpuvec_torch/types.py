"""Core enums and error types: the port's own copy of ``tpuvec/types.py``.

The values are the same strings as the JAX package's, so a config carried
across by ``tpuvec_torch.interop`` maps enum to enum by ``.value``; the
``parse`` methods take the same spellings and raise the same error types.
"""

from __future__ import annotations

import enum


class VectorType(enum.Enum):
    """Vector element type."""

    FLOAT32 = "float32"
    INT8 = "int8"
    BIT = "bit"

    @classmethod
    def parse(cls, s: str) -> "VectorType":
        m = {
            "float32": cls.FLOAT32,
            "float": cls.FLOAT32,
            "int8": cls.INT8,
            "bit": cls.BIT,
            "binary": cls.BIT,
        }
        key = s.strip().lower()
        if key not in m:
            raise InvalidVectorType(f"Invalid vector type: '{s}'")
        return m[key]

    @property
    def bytes_per_element(self) -> float:
        if self is VectorType.FLOAT32:
            return 4
        if self is VectorType.INT8:
            return 1
        return 0.125  # BIT: 8 elements per byte

    def blob_nbytes(self, dimensions: int) -> int:
        """Size in bytes of a canonical blob for `dimensions` elements."""
        if self is VectorType.FLOAT32:
            return 4 * dimensions
        if self is VectorType.INT8:
            return dimensions
        return (dimensions + 7) // 8


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

    @classmethod
    def parse(cls, s: str) -> "DistanceMetric":
        m = {
            "l2": cls.L2,
            "euclidean": cls.L2,
            "l1": cls.L1,
            "manhattan": cls.L1,
            "cosine": cls.COSINE,
            "hamming": cls.HAMMING,
        }
        key = s.strip().lower()
        if key not in m:
            raise InvalidDistanceMetric(f"Invalid distance metric: '{s}'")
        return m[key]


class IndexQuantization(enum.Enum):
    """How vectors are stored inside the HNSW index: NONE keeps the
    original precision, INT8 is fixed-scale symmetric int8, BINARY is
    mean-threshold sign bits searched by Hamming distance."""

    NONE = "none"
    INT8 = "int8"
    BINARY = "binary"

    @classmethod
    def parse(cls, s: str) -> "IndexQuantization":
        key = s.strip().lower()
        m = {"none": cls.NONE, "int8": cls.INT8, "binary": cls.BINARY}
        if key not in m:
            raise InvalidParameter(
                f"Invalid index_quantization value: '{s}'. Use 'none', 'int8' or 'binary'"
            )
        return m[key]


class IndexType(enum.Enum):
    """Table-level index type: HNSW, or ENN (the exact brute-force scan)."""

    HNSW = "hnsw"
    ENN = "enn"

    @classmethod
    def parse(cls, s: str) -> "IndexType":
        key = s.strip().lower()
        m = {"hnsw": cls.HNSW, "enn": cls.ENN}
        if key not in m:
            raise InvalidParameter(f"Invalid index type: '{s}'. Use 'hnsw' or 'enn'")
        return m[key]


# --------------------------------------------------------------------------
# Errors
# --------------------------------------------------------------------------


class TpuVecError(Exception):
    """Base error for tpuvec_torch."""


class InvalidVectorFormat(TpuVecError):
    pass


class DimensionMismatch(TpuVecError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"Dimension mismatch: expected {expected}, got {actual}")
        self.expected = expected
        self.actual = actual


class InvalidVectorType(TpuVecError):
    pass


class InvalidDistanceMetric(TpuVecError):
    pass


class HnswError(TpuVecError):
    pass


class NotImplementedTpuVec(TpuVecError):
    pass


class InvalidParameter(TpuVecError):
    pass


class InvalidState(TpuVecError):
    pass


class JsonParse(TpuVecError):
    pass
