"""The sampling estimators' reservoir scan, as one kernel launch a batch of
edges on the card.

:func:`reservoir_scan` folds a batch of edges, in order, through every
reservoir sample of the triangle estimators (the route of every id space
above ``library/sampling.py:_PACK_LIMIT``). It is the counterpart of the
step of ``gelly_streaming_tpu/library/sampling.py:_window_scan`` (``:59-94``),
an XLA step in the JAX package (a ``lax.scan``, not a Pallas kernel).

- On CUDA tensors :func:`reservoir_scan` checks its operands and makes one
  launch of the kernel in ``csrc/reservoir_scan.cu`` (built at first use by
  :mod:`.cuda_build`), counted in :data:`LAUNCHES`: a cooperative grid
  reads the whole ``[n, k]`` coin matrix in parallel for each sample's last
  replacement, then searches the edges after it for the sample's closing
  pairs, into a scratch buffer allocated here. A CUDA call launches the
  kernel or raises.
- On CPU tensors it runs :func:`reservoir_scan_plain`, the torch form, an
  edge at a time over the ``[k]`` state (about 35 launches an edge on a
  card). The tests and ``chip_smoke.py`` hold the kernel against it.

Both take the uniforms as arguments and compute the same float32 steps, so
fed the same uniforms they return equal states. The state's tensors are
read and never written: the result is new tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import device_index, load_library

#: launches of the scan kernel since import (or since a caller reset it):
#: one a batch of edges on the card
LAUNCHES = 0

#: the state's columns, in the launcher's order, and their dtypes
FIELDS = (("src", torch.int32), ("trg", torch.int32), ("third", torch.int32),
          ("src_found", torch.bool), ("trg_found", torch.bool))


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def reservoir_scan_plain(state: dict, edge_count: int, src, dst, vertex_count: int,
                         u_coin: torch.Tensor, u_third: torch.Tensor):
    """Plain PyTorch version: fold the edges ``src[i] -> dst[i]`` one by one
    through all reservoir states, edge ``i`` with the uniforms
    ``u_coin[i]``, ``u_third[i]`` (``[k]`` float32). ``src``, ``dst``: raw
    ids, 1-D numpy arrays or tensors. Returns ``(state, new_edge_count)``;
    ``state`` is not written."""
    st = dict(state)
    m = int(edge_count)
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        m += 1
        # coin-flip 1/m per sample: replace the reservoir edge
        coin = u_coin[i] < _f32(np.float32(1.0) / np.float32(m))
        # third vertex uniform over [0, V) \ {s, d}
        u1, u2 = min(s, d), max(s, d)
        distinct = u1 != u2
        n_valid = vertex_count - 1 - int(distinct)
        c0 = torch.clamp_max((u_third[i] * _f32(n_valid)).to(torch.int32), n_valid - 1)
        c = c0 + (c0 >= u1).to(torch.int32)
        if distinct:
            c = c + (c >= u2).to(torch.int32)
        st["src"] = torch.where(coin, s, st["src"])
        st["trg"] = torch.where(coin, d, st["trg"])
        st["third"] = torch.where(coin, c, st["third"])
        # closing-edge checks (undirected match, reference :108-121)
        hit_src = ((st["src"] == s) & (st["third"] == d)) | (
            (st["third"] == s) & (st["src"] == d))
        hit_trg = ((st["trg"] == s) & (st["third"] == d)) | (
            (st["third"] == s) & (st["trg"] == d))
        st["src_found"] = (st["src_found"] & ~coin) | hit_src
        st["trg_found"] = (st["trg_found"] & ~coin) | hit_trg
    return st, m


def reservoir_scan(state: dict, edge_count: int, src: torch.Tensor, dst: torch.Tensor,
                   vertex_count: int, u_coin: torch.Tensor, u_third: torch.Tensor):
    """Fold a batch of ``n`` edges through the ``[k]`` reservoir state:
    ``state`` the five columns of :data:`FIELDS` (contiguous ``[k]``),
    ``edge_count`` the edges seen before the batch, ``src``, ``dst``
    contiguous int32 ``[n]`` raw ids, ``u_coin``, ``u_third`` contiguous
    float32 ``[n, k]``, all on one device. Returns ``(state,
    new_edge_count)`` with new state tensors (an empty batch returns
    ``state``'s own). The plain version on the CPU; on the card one launch
    of the kernel and no host read."""
    _check(state, edge_count, src, dst, vertex_count, u_coin, u_third)
    n, k = u_coin.shape
    if n == 0 or k == 0:
        return dict(state), int(edge_count) + n
    if src.device.type == "cpu":
        return reservoir_scan_plain(state, edge_count, src, dst, vertex_count, u_coin, u_third)
    return _scan_kernel(state, int(edge_count), src, dst, vertex_count, u_coin, u_third)


def _scan_kernel(state: dict, edge_count: int, src, dst, vertex_count: int, u_coin, u_third):
    """The batch on the card, for checked operands: new state tensors, one
    launch on the current stream of the operands' card, no host read."""
    global LAUNCHES
    lib = _library()
    device = src.device
    out = {name: torch.empty_like(state[name]) for name, _ in FIELDS}
    n, k = u_coin.shape
    index = device_index(device)
    words = lib.reservoir_scan_scratch_words(n, k, index)
    if words < 0:
        msg = lib.reservoir_scan_error_string(-words).decode()
        raise RuntimeError(f"reservoir scan: no plan for the launch: {msg} (cudaError {-words})")
    scratch = torch.empty(words, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.reservoir_scan_launch(
            *(state[name].data_ptr() for name, _ in FIELDS),
            *(out[name].data_ptr() for name, _ in FIELDS),
            src.data_ptr(), dst.data_ptr(), u_coin.data_ptr(), u_third.data_ptr(),
            scratch.data_ptr(), words, edge_count, n, k, vertex_count, index, stream)
    if code != 0:
        msg = lib.reservoir_scan_error_string(code).decode()
        raise RuntimeError(f"reservoir scan: the launch failed: {msg} (cudaError {code})")
    LAUNCHES += 1
    return out, edge_count + n


def _check(state, edge_count, src, dst, vertex_count, u_coin, u_third) -> None:
    """Raise ValueError on operands the scan does not take; nothing is
    launched before this passes. On CPU tensors the ids are also checked to
    lie in [0, 2^31); on the card that would be a host read a batch, so the
    caller checks the host ids it uploads (``library/sampling.py`` does)."""
    if set(state) != {name for name, _ in FIELDS}:
        raise ValueError(f"reservoir scan: the state must hold exactly "
                         f"{[name for name, _ in FIELDS]}, got {sorted(state)}")
    cols = [state[name] for name, _ in FIELDS]
    tensors = (*cols, src, dst, u_coin, u_third)
    device = src.device
    if any(t.device != device for t in tensors):
        raise ValueError("reservoir scan: all operands must be on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"reservoir scan: unsupported device {device}")
    k = cols[0].shape[0] if cols[0].dim() == 1 else -1
    for (name, dtype), t in zip(FIELDS, cols):
        if t.dtype != dtype or t.shape != (k,):
            raise ValueError(f"reservoir scan: state column {name} must be {dtype} [k], one "
                             f"k for all, got {t.dtype} {tuple(t.shape)}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise ValueError(f"reservoir scan: src and dst must be int32, got {src.dtype}, "
                         f"{dst.dtype}")
    if src.dim() != 1 or dst.shape != src.shape:
        raise ValueError(f"reservoir scan: src and dst must be one [n] shape, got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}")
    n = src.shape[0]
    for name, u in (("u_coin", u_coin), ("u_third", u_third)):
        if u.dtype != torch.float32 or u.shape != (n, k):
            raise ValueError(f"reservoir scan: {name} must be float32 [n, k] = [{n}, {k}], "
                             f"got {u.dtype} {tuple(u.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("reservoir scan: operands must be contiguous")
    if not 3 <= vertex_count < 1 << 31:
        raise ValueError(f"reservoir scan: vertex_count must lie in [3, 2^31), got "
                         f"{vertex_count}")
    if not 0 <= edge_count < 1 << 62:
        raise ValueError(f"reservoir scan: edge_count must lie in [0, 2^62), got {edge_count}")
    if device.type == "cpu" and n and int(torch.minimum(src.min(), dst.min())) < 0:
        raise ValueError("reservoir scan: ids must lie in [0, 2^31)")


def _library() -> ctypes.CDLL:
    """The kernel's library; at first use its C signatures are declared."""
    lib = load_library("reservoir_scan")
    if lib.reservoir_scan_launch.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.reservoir_scan_launch.argtypes = [ptr] * 15 + [i64, i64, i32, i32, i32, i32, ptr]
        lib.reservoir_scan_launch.restype = i32
        lib.reservoir_scan_scratch_words.argtypes = [i32, i32, i32]
        lib.reservoir_scan_scratch_words.restype = i64
        err = lib.reservoir_scan_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    return lib
