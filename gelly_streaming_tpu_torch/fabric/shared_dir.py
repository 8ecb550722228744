"""Shared-directory transport (the port's copy of
``gelly_streaming_tpu/fabric/shared_dir.py``).

The three moves on a shared filesystem: write a temp name, commit with an
atomic rename, poll for peers' files. Tag <-> ``<root>/<tag>``, bytes
verbatim, so the layout on disk is the JAX package's byte for byte: a
JAX-package process and a port process can share one directory, and the
recovery tests inspect and corrupt the files directly. Every caller goes
through the :class:`~gelly_streaming_tpu_torch.fabric.base.Transport`
interface instead of touching the directory itself.

The one-winner ``put(overwrite=False)`` is the part that needs care: an
exists-check + rename has a two-writer race, and ``open(path, "xb")``
exposes a torn file under the final name if the writer dies mid-write.
``os.link`` of a FULLY-WRITTEN temp file gives both properties at once
— the link either lands (this writer won, and the visible bytes are
complete by construction) or raises ``FileExistsError`` (a peer won
first); there is no state in between.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from .base import TagStat, Transport


class SharedDirTransport(Transport):
    """Tag store over one shared directory; see the module docstring.
    ``process_id``/``num_processes`` scope the inherited group
    primitives — a pure store user (snapshot mirror, lease) leaves the
    defaults."""

    backend = "shared_dir"
    persistent = True

    def __init__(self, root: str, process_id: int = 0,
                 num_processes: int = 1, *, timeout_s: float = 60.0,
                 poll_s: float = 0.002):
        self.root = root
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)

    def _path(self, tag: str) -> str:
        return os.path.join(self.root, tag)

    def describe(self, tag: str) -> str:
        return self._path(tag)

    def _tmp(self, path: str) -> str:
        # unique per writer THREAD, not just per process: in-process
        # cluster harnesses run one rank per thread, and an election
        # has every rank writing a temp for the SAME tag concurrently
        return f"{path}.tmp{os.getpid()}.{threading.get_ident()}"

    def put(self, tag: str, payload: bytes, *,
            overwrite: bool = False) -> bool:
        # created on first WRITE, not in the constructor: read-side
        # coercions (a lease probe on a directory that may not exist
        # yet) must stay side-effect free
        os.makedirs(self.root, exist_ok=True)
        path = self._path(tag)
        if not overwrite and os.path.exists(path):
            return False
        tmp = self._tmp(path)
        with open(tmp, "wb") as f:
            f.write(payload)
        if overwrite:
            os.replace(tmp, path)
            return True
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass

    def _get_once(self, tag: str) -> Optional[bytes]:
        try:
            with open(self._path(tag), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def stat(self, tag: str) -> Optional[TagStat]:
        try:
            st = os.stat(self._path(tag))
        except FileNotFoundError:
            return None
        return TagStat(size=int(st.st_size), version=int(st.st_mtime_ns))

    def list(self, prefix: str = "") -> List[str]:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return sorted(
            n for n in names
            if n.startswith(prefix) and ".tmp" not in n
            and not os.path.isdir(os.path.join(self.root, n))
        )

    def delete(self, tag: str) -> bool:
        try:
            os.unlink(self._path(tag))
            return True
        except FileNotFoundError:
            return False
