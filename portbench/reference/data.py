"""Seeded embeddings on a low-dimensional manifold, made on the device.

Real embedding sets lie near low-dimensional manifolds with cluster
structure; isotropic gaussians at 768 dimensions do not (all distances
concentrate and recall says nothing). A row is

    x = basis @ (center[c] + spread * g) + noise * h,   then L2-normalised,

with c drawn from Dirichlet(alpha) cluster sizes and g, h standard
normal. The manifold (basis, centers, sizes) comes from the
configuration's ``structure_seed`` on the host (a few hundred KB); the
rows come from a run's seed on the device, in a few large calls, so that
set-up stays short. It is the arithmetic of the program's numpy
generator (``tpuvec_torch/utils/data.py``), rewritten in torch.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["subseed", "Manifold"]

# rows made by one generator call: bounds the temporaries to ~1 GB at 1024 dims
_CHUNK = 1 << 18


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of a run: a hash of the run's seed and
    the stream's tags, so streams never overlap and any whole number works
    as a seed."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Manifold:
    """The manifold of one configuration (its ``data`` block) on ``device``."""

    def __init__(self, dim: int, data: dict, device: torch.device):
        rng = np.random.default_rng(data["structure_seed"])
        k = data["intrinsic_dim"]
        basis = rng.standard_normal((k, dim), dtype=np.float32)
        basis /= np.linalg.norm(basis, axis=1, keepdims=True)
        centers = rng.standard_normal((data["clusters"], k), dtype=np.float32)
        sizes = rng.dirichlet(np.full(data["clusters"], data["dirichlet_alpha"]))
        self.dim = dim
        self.device = torch.device(device)
        self.spread = float(data["spread"])
        self.noise = float(data["noise"])
        self.normalize = bool(data["normalize"])
        self.basis = torch.from_numpy(basis).to(self.device)
        self.centers = torch.from_numpy(centers).to(self.device)
        self.sizes = torch.from_numpy(sizes.astype(np.float64)).to(self.device)

    def rows(self, n: int, seed: int) -> torch.Tensor:
        """n rows [n, dim] float32 on the device; the same seed gives the
        same rows. Each chunk of rows has its own generator."""
        out = torch.empty((n, self.dim), dtype=torch.float32, device=self.device)
        for i, start in enumerate(range(0, n, _CHUNK)):
            stop = min(n, start + _CHUNK)
            g = torch.Generator(device=self.device)
            g.manual_seed(subseed(seed, "rows", i))
            m = stop - start
            assign = torch.multinomial(self.sizes, m, replacement=True, generator=g)
            z = self.centers[assign] + self.spread * torch.randn(
                (m, self.centers.shape[1]), generator=g, device=self.device)
            x = z @ self.basis
            x += self.noise * torch.randn((m, self.dim), generator=g, device=self.device)
            if self.normalize:
                x /= torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-9)
            out[start:stop] = x
        return out
