"""Index engines: exact brute-force (ENN) and HNSW over device tensors."""

from tpuvec_torch.index.bruteforce import bruteforce_knn
from tpuvec_torch.index.params import HnswParams

__all__ = ["bruteforce_knn", "HnswParams"]
