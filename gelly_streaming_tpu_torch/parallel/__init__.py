"""Multi-host support of the port, its host half (the counterpart of
``gelly_streaming_tpu/parallel/``).

:mod:`multihost` holds the file-exchange ingest contract
(``FileExchangeTransport``, ``dict_exchange_encode`` over a store-backed
transport), which is host numpy. The mesh (``parallel/mesh.py``), the
collectives (``parallel/comm.py``) and the multi-controller runtime come
with ROADMAP Queue 1, slice 6 (multiple devices).
"""

from . import multihost

__all__ = ["multihost"]
