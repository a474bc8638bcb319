"""Device choice for the port's entry points.

Entry points take ``device="cuda"`` by default and never fall back to the
CPU on their own: with no card they raise, and they run on the CPU only
when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises if it is CUDA and no card
    is present.

    On CUDA, float32 matrix products and convolutions run in full float32
    (TF32 off): the JAX package computes its distances at
    ``Precision.HIGHEST``, and TF32's ~1e-3 relative error would reorder
    near-ties in the graph.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
