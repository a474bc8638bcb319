"""Deterministic synthetic embedding generator (numpy).

Real embedding sets concentrate on low-dimensional manifolds with cluster
structure; isotropic gaussians at 768-D do not (all pairwise distances
concentrate, making ANN recall meaningless as a quality signal). This
generator gives deterministic data with that geometry: a mixture of
clusters on a low-dimensional subspace plus small ambient noise,
L2-normalized like sentence-transformer output. It draws the same numbers
as the JAX package's generator for the same arguments.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_embeddings"]


def synthetic_embeddings(
    n: int,
    d: int,
    *,
    intrinsic_dim: int = 48,
    n_clusters: int = 256,
    noise: float = 0.05,
    seed: int = 0,
    normalize: bool = True,
    structure_seed: int | None = None,
) -> np.ndarray:
    """n embeddings of dimension d on an intrinsic_dim manifold.

    x = basis @ (center_c + within-cluster offset) + ambient noise,
    then L2-normalized. Deterministic in (n, d, params, seed).

    ``structure_seed`` (default: seed) seeds the manifold itself (basis,
    centers, cluster sizes) separately from the row draws, so that one
    corpus generated in independently seeded chunks shares one manifold.
    """
    rng_s = np.random.default_rng(
        seed if structure_seed is None else structure_seed
    )
    rng = np.random.default_rng(seed)
    basis = rng_s.standard_normal((intrinsic_dim, d), dtype=np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    centers = rng_s.standard_normal((n_clusters, intrinsic_dim), dtype=np.float32)
    sizes = rng_s.dirichlet(np.full(n_clusters, 1.5))
    assign = rng.choice(n_clusters, size=n, p=sizes)
    z = centers[assign] + 0.35 * rng.standard_normal(
        (n, intrinsic_dim), dtype=np.float32
    )
    x = z @ basis
    x += noise * rng.standard_normal((n, d), dtype=np.float32)
    if normalize:
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    return x.astype(np.float32)
