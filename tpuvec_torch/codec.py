"""Host-side vector value handling: JSON <-> canonical little-endian blobs.
The port's own copy of ``tpuvec/codec.py``, with the same blob and JSON
conventions and the same errors:

* float32 blobs are raw little-endian f32, 4 bytes/element;
* int8 blobs are raw signed bytes, 1 byte/element;
* bit blobs pack 8 elements per byte, LSB-first (bit i of a byte is
  element ``8*byte_index + i``);
* JSON vectors are plain arrays (``[1.0, 2.0, ...]``).

Everything here is numpy (host); device math lives in tpuvec_torch.ops.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from tpuvec_torch.types import (
    DimensionMismatch,
    InvalidVectorFormat,
    InvalidVectorType,
    JsonParse,
    VectorType,
)

__all__ = ["Vector", "pack_bits", "unpack_bits"]


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 array (last axis = dimensions) into uint8 bytes, LSB-first."""
    bits = np.asarray(bits)
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def unpack_bits(data: np.ndarray, dimensions: int) -> np.ndarray:
    """Unpack LSB-first uint8 bytes back to a 0/1 uint8 array."""
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data, axis=-1, count=dimensions, bitorder="little")


@dataclass(frozen=True)
class Vector:
    """An owned vector value: canonical blob bytes + type + dimensions."""

    vec_type: VectorType
    dimensions: int
    data: bytes

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_f32(cls, values) -> "Vector":
        arr = np.asarray(values, dtype="<f4").ravel()
        return cls(VectorType.FLOAT32, arr.size, arr.tobytes())

    @classmethod
    def from_i8(cls, values) -> "Vector":
        arr = np.asarray(values, dtype=np.int8).ravel()
        return cls(VectorType.INT8, arr.size, arr.tobytes())

    @classmethod
    def from_bits(cls, bits) -> "Vector":
        bits = np.asarray(bits).ravel()
        return cls(VectorType.BIT, bits.size, pack_bits(bits).tobytes())

    @classmethod
    def from_json(cls, text: str, vec_type: VectorType) -> "Vector":
        """Parse a JSON array of numbers; BIT takes 0/1 (any nonzero is 1)."""
        try:
            values = json.loads(text)
        except json.JSONDecodeError as e:
            raise JsonParse(f"Invalid JSON vector: {e}") from e
        if not isinstance(values, list) or not all(
            isinstance(v, (int, float)) for v in values
        ):
            raise InvalidVectorFormat("JSON vector must be an array of numbers")
        if len(values) == 0:
            raise InvalidVectorFormat("JSON vector must not be empty")
        if vec_type is VectorType.FLOAT32:
            return cls.from_f32(values)
        if vec_type is VectorType.INT8:
            # saturating truncation, as Rust's float -> int `as i8`:
            # 300 -> 127, -300 -> -128, 3.9 -> 3, NaN -> 0
            arr = np.asarray(values, dtype=np.float64)
            arr = np.where(np.isnan(arr), 0.0, np.trunc(arr))
            arr = np.clip(arr, -128, 127).astype(np.int8)
            return cls.from_i8(arr)
        return cls.from_bits([1 if v else 0 for v in values])

    @classmethod
    def from_blob(cls, blob: bytes, vec_type: VectorType, dimensions: int | None = None) -> "Vector":
        """Wrap raw blob bytes; infer dimensions from size if not given."""
        blob = bytes(blob)
        if len(blob) == 0:
            raise InvalidVectorFormat(f"{vec_type.value} blob must not be empty")
        if vec_type is VectorType.FLOAT32:
            if len(blob) % 4 != 0:
                raise InvalidVectorFormat(
                    f"Float32 blob must be a non-zero multiple of 4 bytes, got {len(blob)} bytes"
                )
            inferred = len(blob) // 4
        elif vec_type is VectorType.INT8:
            inferred = len(blob)
        else:
            inferred = len(blob) * 8
        if dimensions is None:
            dimensions = inferred
        else:
            # Allow explicit dims smaller than capacity only for BIT padding.
            expected = vec_type.blob_nbytes(dimensions)
            if len(blob) != expected:
                raise InvalidVectorFormat(
                    f"Blob size {len(blob)} does not match {dimensions} x {vec_type.value} "
                    f"(expected {expected} bytes)"
                )
        return cls(vec_type, dimensions, blob)

    @classmethod
    def from_sql_value(cls, value, vec_type: VectorType) -> "Vector":
        """Decode a SQL value that is either JSON text or a raw blob."""
        if isinstance(value, str):
            return cls.from_json(value, vec_type)
        if isinstance(value, (bytes, bytearray, memoryview)):
            return cls.from_blob(bytes(value), vec_type)
        raise InvalidVectorFormat("Vector must be TEXT (JSON) or BLOB")

    @classmethod
    def sniff_from_blob(cls, blob: bytes, hint_dimensions: int | None = None) -> "Vector":
        """Guess the type of a raw blob: f32 when its size is a multiple of
        4 bytes, else int8."""
        blob = bytes(blob)
        if len(blob) == 0:
            raise InvalidVectorFormat("blob must not be empty")
        if len(blob) % 4 == 0:
            return cls.from_blob(blob, VectorType.FLOAT32)
        return cls.from_blob(blob, VectorType.INT8)

    # -- accessors ----------------------------------------------------------

    def as_f32(self) -> np.ndarray:
        if self.vec_type is not VectorType.FLOAT32:
            raise InvalidVectorType("as_f32 called on non-Float32 vector")
        return np.frombuffer(self.data, dtype="<f4")

    def as_i8(self) -> np.ndarray:
        if self.vec_type is not VectorType.INT8:
            raise InvalidVectorType("as_i8 called on non-Int8 vector")
        return np.frombuffer(self.data, dtype=np.int8)

    def as_bits(self) -> np.ndarray:
        if self.vec_type is not VectorType.BIT:
            raise InvalidVectorType("as_bits called on non-Bit vector")
        return unpack_bits(np.frombuffer(self.data, dtype=np.uint8), self.dimensions)

    def as_bytes(self) -> bytes:
        return self.data

    def to_numpy(self) -> np.ndarray:
        if self.vec_type is VectorType.FLOAT32:
            return self.as_f32()
        if self.vec_type is VectorType.INT8:
            return self.as_i8()
        return self.as_bits()

    # -- ops ----------------------------------------------------------------

    def _check_match(self, other: "Vector", op: str) -> None:
        if self.dimensions != other.dimensions:
            raise DimensionMismatch(self.dimensions, other.dimensions)
        if self.vec_type is not other.vec_type:
            raise InvalidVectorType(f"Vector types must match for {op}")

    def add(self, other: "Vector") -> "Vector":
        self._check_match(other, "addition")
        if self.vec_type is VectorType.FLOAT32:
            return Vector.from_f32(self.as_f32() + other.as_f32())
        if self.vec_type is VectorType.INT8:
            # Saturating add, matching i8 arithmetic expectations.
            s = self.as_i8().astype(np.int16) + other.as_i8().astype(np.int16)
            return Vector.from_i8(np.clip(s, -128, 127).astype(np.int8))
        raise InvalidVectorType("Cannot add bit vectors")

    def sub(self, other: "Vector") -> "Vector":
        self._check_match(other, "subtraction")
        if self.vec_type is VectorType.FLOAT32:
            return Vector.from_f32(self.as_f32() - other.as_f32())
        if self.vec_type is VectorType.INT8:
            s = self.as_i8().astype(np.int16) - other.as_i8().astype(np.int16)
            return Vector.from_i8(np.clip(s, -128, 127).astype(np.int8))
        raise InvalidVectorType("Cannot subtract bit vectors")

    def normalize(self) -> "Vector":
        if self.vec_type is not VectorType.FLOAT32:
            raise InvalidVectorType("Can only normalize Float32 vectors")
        v = self.as_f32().astype(np.float32)
        norm = float(np.linalg.norm(v))
        if norm == 0.0:
            return Vector.from_f32(v)
        return Vector.from_f32(v / norm)

    def slice(self, start: int, end: int) -> "Vector":
        """Slice elements [start, end)."""
        if not (0 <= start < end <= self.dimensions):
            raise InvalidVectorFormat(
                f"Invalid slice [{start}, {end}) for {self.dimensions} dimensions"
            )
        if self.vec_type is VectorType.FLOAT32:
            return Vector.from_f32(self.as_f32()[start:end])
        if self.vec_type is VectorType.INT8:
            return Vector.from_i8(self.as_i8()[start:end])
        return Vector.from_bits(self.as_bits()[start:end])

    def to_json(self) -> str:
        """JSON text form. Float32 keeps round-trippable repr; int8/bit are ints."""
        if self.vec_type is VectorType.FLOAT32:
            return json.dumps([float(np.float32(v)) for v in self.as_f32()])
        if self.vec_type is VectorType.INT8:
            return json.dumps([int(v) for v in self.as_i8()])
        return json.dumps([int(v) for v in self.as_bits()])
