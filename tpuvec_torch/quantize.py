"""Quantizers: the port's own copy of ``tpuvec/quantize.py``.

Three quantizers (reference src/vector.rs:509-608):

* ``quantize_int8``            — per-vector asymmetric: [min,max] -> [-128,127].
                                 Not distance-comparable across vectors.
* ``quantize_int8_for_index``  — fixed-scale symmetric: clamp [-1,1] -> [-127,127].
                                 Used for int8 HNSW index storage.
* ``quantize_binary``          — mean threshold -> sign bits (>= mean is 1).

Each has a numpy (host, exact reference semantics incl. rounding) and a
torch (device, batched) form. Device forms operate on 2D [N, D] tensors.

Packed bit words are uint32 in the JAX package. The port holds them as
``torch.int32`` with the same bits (torch's uint32 lacks the indexing and
shift kernels the index needs); ``tpuvec_torch.interop`` views them back
as ``np.uint32`` on the way out.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "quantize_int8_np",
    "quantize_int8_for_index_np",
    "quantize_binary_np",
    "quantize_int8_for_index",
    "quantize_binary_words",
    "pack_bits_to_words",
    "dequantize_int8_index",
]

INT8_INDEX_SCALE = 127.0  # [-1, 1] * 127 (reference src/vector.rs:554-575)


# --------------------------------------------------------------------------
# Host (numpy) — exact reference semantics
# --------------------------------------------------------------------------


def quantize_int8_np(v: np.ndarray) -> np.ndarray:
    """Per-vector asymmetric quantization (src/vector.rs:514-545).

    Maps [min, max] -> [-128, 127] with round-half-away-from-zero like
    Rust's f32::round. All-equal vectors quantize to zeros.
    """
    v = np.asarray(v, dtype=np.float32)
    mn, mx = float(v.min()), float(v.max())
    if mn == mx:
        return np.zeros(v.shape, dtype=np.int8)
    normalized = (v - mn) / (mx - mn)
    scaled = normalized * 255.0 - 128.0
    # Rust f32::round = half away from zero; np.round is half-to-even.
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return np.clip(rounded, -128, 127).astype(np.int8)


def quantize_int8_for_index_np(v: np.ndarray) -> np.ndarray:
    """Fixed-scale symmetric quantization (src/vector.rs:554-575)."""
    v = np.asarray(v, dtype=np.float32)
    clamped = np.clip(v, -1.0, 1.0) * INT8_INDEX_SCALE
    rounded = np.sign(clamped) * np.floor(np.abs(clamped) + 0.5)
    return rounded.astype(np.int8)


def quantize_binary_np(v: np.ndarray) -> np.ndarray:
    """Mean-threshold binarization -> 0/1 uint8 array (src/vector.rs:579-608)."""
    v = np.asarray(v, dtype=np.float32)
    mean = v.mean(axis=-1, keepdims=True)
    return (v >= mean).astype(np.uint8)


# --------------------------------------------------------------------------
# Device (torch) — batched forms for index construction / query prep
# --------------------------------------------------------------------------


def quantize_int8_for_index(v: torch.Tensor) -> torch.Tensor:
    """Batched fixed-scale symmetric int8 quantization on device.

    torch.round is half-to-even, as jnp.round is; the reference rounds
    half-away. Host-side exact semantics live in quantize_int8_for_index_np.
    """
    clamped = torch.clamp(v.to(torch.float32), -1.0, 1.0) * INT8_INDEX_SCALE
    return torch.round(clamped).to(torch.int8)


def dequantize_int8_index(q: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_int8_for_index (up to rounding)."""
    return q.to(torch.float32) / INT8_INDEX_SCALE


def pack_bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 tensor [..., D] into words [..., D/32] (int32 holding the
    uint32 bits), LSB-first: word w bit b is element 32*w + b."""
    d = bits.shape[-1]
    if d % 32:
        raise ValueError("bit dimension must be padded to a multiple of 32")
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], d // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(-1)  # in [0, 2^32): fold the top half onto int32
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def quantize_binary_words(v: torch.Tensor) -> torch.Tensor:
    """Batched mean-threshold binarization -> packed words on device."""
    mean = torch.mean(v, dim=-1, keepdim=True)
    return pack_bits_to_words(v >= mean)
