"""The benchmark of ``gelly_streaming_tpu_torch`` on NVIDIA cards.

``run.py`` runs one cell (``workloads/<cell>.json``) once and prints one
JSON line. Every configuration (``configs/``), cell (``workloads/``), job
kind (``jobs/``) and per-layer metric (``metrics/``) is a file of its own,
found by its name; ``reference/`` holds the plain references that decide
``correct``. Nothing here imports JAX or the JAX package.
"""
