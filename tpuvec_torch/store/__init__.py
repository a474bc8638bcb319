"""Columnar vector store: VecTable over the device indexes."""

from tpuvec_torch.store.table import ColumnSpec, VecTable

__all__ = ["VecTable", "ColumnSpec"]
