"""Observability of the PyTorch port: host-side pipeline spans."""
