"""Kernels of the PyTorch port, each beside its plain PyTorch version."""
