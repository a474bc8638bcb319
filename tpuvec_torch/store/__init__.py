"""Columnar vector store: VecTable + snapshot persistence + followers."""

from tpuvec_torch.store.follower import SnapshotFollower, writer_lock
from tpuvec_torch.store.table import ColumnSpec, VecTable

__all__ = ["VecTable", "ColumnSpec", "SnapshotFollower", "writer_lock"]
