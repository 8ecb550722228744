"""The summary-aggregation engine of the PyTorch port."""

from .summary import SummaryAggregation, SummaryBulkAggregation, SummaryTreeReduce

__all__ = ["SummaryAggregation", "SummaryBulkAggregation", "SummaryTreeReduce"]
