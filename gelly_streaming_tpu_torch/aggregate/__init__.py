"""The summary-aggregation engine of the PyTorch port, and its checkpoint
surface (``checkpoint``; ``autockpt.AutoCheckpoint`` for periodic
barriers)."""

from .summary import SummaryAggregation, SummaryBulkAggregation, SummaryTreeReduce
from . import checkpoint

__all__ = ["SummaryAggregation", "SummaryBulkAggregation", "SummaryTreeReduce", "checkpoint"]
