"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel lives in ``csrc/<name>.cu`` behind a plain ``extern "C"``
launcher; headers it includes are ``csrc/*.cuh``. :func:`load_library`
compiles it at first use into a shared library under ``_build/`` beside
the package (listed in ``.gitignore``), named by a hash of the source,
every header and the flags, so an edited source or header builds anew and
an unchanged one is loaded as it is. No PyTorch header is
included: the build takes seconds, not minutes.

``nvcc`` is looked up under ``$CUDA_HOME``/``$CUDA_PATH``, then on
``PATH``, then where PyTorch's C++ extension tooling finds the toolkit.
A missing compiler or a failed build raises with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}
#: name -> {"seconds": build wall time (0.0 when loaded from _build/),
#: "log": nvcc's output (ptxas register and shared-memory report)}
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found under $CUDA_HOME, $CUDA_PATH, on PATH or in "
        "torch.utils.cpp_extension.CUDA_HOME: the CUDA kernels of "
        "gelly_streaming_tpu_torch cannot be built"
    )


def library_path(name: str) -> str:
    """Where the library for ``csrc/<name>.cu`` is built: keyed by a hash
    of the source, of every ``csrc/*.cuh`` header (name and content) and
    of the flags."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        h.update(f.read())
    for header in sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, header), "rb") as f:
            h.update(b"\0" + header.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hash-keyed library exists;
    returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    BUILD_INFO[name] = {"seconds": seconds, "log": log}
    return out


def build_all() -> dict:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` per source started
    together; returns name -> library path. Raises the first failure."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(
        f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: fut.result() for name, fut in futures.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _LIBS[name] = lib
    return lib
