"""tpuvec_torch: the tpuvec HNSW vector index in PyTorch, with its
level-0 beam update as a hand-written CUDA kernel for Hopper.

The JAX package ``tpuvec`` is the reference; this package keeps its module
and public names and imports nothing of it.
"""
