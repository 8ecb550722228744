"""Summaries of the PyTorch port: dense labels, the forest carry and the
group-fold contract."""
