"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel lives in ``csrc/<name>.cu`` behind a plain ``extern "C"``
launcher; headers it includes are ``csrc/*.cuh``. Every source includes
``csrc/launch.cuh``, which selects the operands' card, bounds a cooperative
grid and exports ``launch_error_string``; every wrapper calls its launchers
through :func:`launch`, which passes the card and its current stream, and
their planning calls through :func:`query`, which passes the card; both
raise on an error code.
:func:`load_library` compiles it at first use into a shared library under
``_build/`` beside the package (listed in ``.gitignore``), named by a hash
of the source, every header and the flags, so an edited source or header
builds anew and an unchanged one is loaded as it is. No PyTorch header is
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


def build_all(names=None) -> dict:
    """Build every ``csrc/*.cu`` (or the sources ``names``) at once, one
    ``nvcc`` per source started together; returns name -> library path.
    Raises the first failure."""
    from concurrent.futures import ThreadPoolExecutor

    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: fut.result() for name, fut in futures.items()}


def load_libraries(names) -> None:
    """Load the libraries for the sources ``names``, building the ones not
    loaded yet side by side (:func:`build_all`); a dictionary lookup once
    they are."""
    missing = [name for name in names if name not in _LIBS]
    if missing:
        build_all(missing)
        for name in missing:
            load_library(name)


def device_index(device) -> int:
    """The CUDA index of ``device`` (the current card for a bare "cuda"),
    which a launcher selects in the CUDA runtime linked into its library."""
    import torch

    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``launch_error_string``'s C signature declared."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        lib.launch_error_string.argtypes = [ctypes.c_int]
        lib.launch_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(lib, name: str, device, *args) -> None:
    """Call the launcher ``lib.<name>`` with ``args`` (a tensor as its data
    pointer), then the CUDA index of ``device`` and that card's current
    stream, with ``device`` current in PyTorch. Raises RuntimeError naming
    the launcher when it returns a non-zero code (the launch was refused)."""
    import torch

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*ptrs, device_index(device), stream)
    if code != 0:
        _refused(lib, name, code)


def query(lib, name: str, device, *args) -> int:
    """``lib.<name>(*args, index of device)``: a launcher's plan (a count)
    for that card, which the library returns negated where it is a CUDA
    error code; raises RuntimeError naming the call on such a code."""
    value = getattr(lib, name)(*args, device_index(device))
    if value < 0:
        _refused(lib, name, -value)
    return value


def _refused(lib, name: str, code: int):
    msg = lib.launch_error_string(code).decode()
    raise RuntimeError(f"{name} failed: {msg} (cudaError {code})")
