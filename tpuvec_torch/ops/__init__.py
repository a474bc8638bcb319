"""Distances and the level-0 beam update (plain torch + CUDA kernel)."""
