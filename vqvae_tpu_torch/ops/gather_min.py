"""Column-wise min over randomly gathered rows: kernel K4.

The port of ``tools/bench_pallas_gather.py`` ``pallas_gather_min``: the
ELL relaxation's random-row gather-reduce ``min_j d[idx_j]`` as one
(1, K) row. On a CUDA tensor ``gather_min`` launches the hand-written
Hopper kernels in ``csrc/gather_min.cu`` (built with ``nvcc`` at first use,
bound with ctypes, launched on the current stream) by one of two routes
that ``gather_min_route`` picks from (R, N, K): the gather route reads one
row per index; the scan route marks the present rows and streams each of
them once. On a CPU tensor it runs ``gather_min_reference``, the plain
PyTorch version: per-chunk minima of the gathered rows, then the min of
those. Min is exact, so all agree bitwise; NaN propagates as in
``jnp.minimum``, and a column of nothing gathered is +inf. Host arrays go
to ``device`` first (default CUDA).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .._build import load_cuda_library
from ..device import resolve_device

# indices per block of the kernel, the JAX tool's CHUNK
CHUNK = 1024
# gathered rows the plain version materializes per step
_REF_ROWS = 64 * CHUNK

# Device-time model of the two routes behind ``gather_min_route``, fitted
# to ``tools/bench_gather_min.py --crossover`` on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md, PR 4). Gather route: a fixed cost, one step of a
# thread's serial walk per kUnroll = 4 rows of its row group, and the rows'
# 32-byte sectors at the rate reached at K = 36 (partly from L2). Scan
# route: a fixed cost (memset and four launches), the presence stores per
# index, and its bytes (4-byte flags cleared and read, then each present
# row once) at the streaming rate.
_GATHER_FIXED_S = 3.0e-6
_GATHER_STEP_S = 0.38e-6
_GATHER_RATE = 7.3e12
_SCAN_FIXED_S = 7.5e-6
_SCAN_INDEX_S = 12.6e-12
_SCAN_RATE = 3.0e12

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gather_min_launch": ([_VP, _VP, _CI, _CI, _VP, _VP, _VP], _CI),
    "gather_min_scan_launch": (
        [_VP, _VP, _CI, _CI, _CI, _VP, _CI, _VP, _VP, _VP], _CI),
    "gather_min_chunks": ([_CI], _CI),
    "gather_min_scan_ranges": ([_CI, _CI], _CI),
    "gather_min_error_string": ([_CI], ctypes.c_char_p),
}
ROUTES = ("gather", "scan")


def build() -> str:
    """Build (or reuse) the kernel library; returns nvcc's output."""
    return load_cuda_library("gather_min.cu", _SIGNATURES)[1]


def _library() -> ctypes.CDLL:
    return load_cuda_library("gather_min.cu", _SIGNATURES)[0]


def _check(d: torch.Tensor, idx: torch.Tensor) -> None:
    if d.dtype != torch.float32 or d.ndim != 2:
        raise TypeError(f"gather_min takes d (N, K) float32, got "
                        f"{d.dtype} {tuple(d.shape)}")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"gather_min takes idx (R,) int32, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if d.device != idx.device:
        raise ValueError("d and idx must lie on one device")
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()  # one read
        if lo < 0 or hi >= d.shape[0]:
            raise IndexError(f"idx outside 0..{d.shape[0] - 1}: "
                             f"[{lo}, {hi}]")


def gather_min(d, idx, device=None) -> torch.Tensor:
    """(1, K) f32: the column-wise min of rows ``idx`` (R,) int32 of ``d``
    (N, K) f32. CUDA tensors launch kernel K4; CPU tensors run
    ``gather_min_reference``. Host arrays are moved to ``device`` (default
    CUDA; raises without it). Indices are checked against N first (one
    device-to-host read)."""
    if not isinstance(d, torch.Tensor):
        dev = resolve_device(device)
        d = torch.from_numpy(np.ascontiguousarray(d, np.float32)).to(dev)
        idx = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
    _check(d, idx)
    if d.device.type == "cpu":
        return gather_min_reference(d, idx)
    if d.device.type != "cuda":
        raise ValueError(f"gather_min: unsupported device {d.device}")
    return launch_gather_min(d, idx)


def gather_min_route(r: int, n: int, k: int) -> str:
    """The route kernel K4 takes for R indices into N rows of K values:
    the one the device-time model above puts first. "scan" (mark the
    present rows, stream each once) wins unless the gather is a few steps
    of one block, or its rows are narrow and few enough to cost less than
    the scan's presence pass; then "gather" (one row per index)."""
    vec = 4 if k % 4 == 0 else 1
    groups = 256 // min(256, k // vec)  # row groups of a block (kThreads)
    steps = math.ceil(min(r, CHUNK) / (4 * groups))
    gather_s = (_GATHER_FIXED_S + steps * _GATHER_STEP_S
                + r * 32 * math.ceil(k / 8) / _GATHER_RATE)
    present = n * -math.expm1(-r / n)  # expected distinct rows
    scan_s = (_SCAN_FIXED_S + r * _SCAN_INDEX_S
              + (8 * n + present * k * 4) / _SCAN_RATE)
    return "scan" if scan_s < gather_s else "gather"


def launch_gather_min(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel K4 on CUDA tensors that ``gather_min`` has already checked
    (dtypes, shapes, indices in range): no check and no host read, so a
    timing loop measures the launches alone."""
    return _launch(d, idx, gather_min_route(idx.shape[0], *d.shape))


def _launch(d: torch.Tensor, idx: torch.Tensor, route: str) -> torch.Tensor:
    """Kernel K4 by ``route`` ("gather" or "scan") on checked CUDA
    tensors."""
    if route not in ROUTES:
        raise ValueError(f"gather_min: unknown route {route!r}")
    (n, k), r = d.shape, idx.shape[0]
    if r == 0 or k == 0:
        return torch.full((1, k), float("inf"), dtype=torch.float32,
                          device=d.device)
    lib = _library()
    d = d.contiguous()
    idx = idx.contiguous()
    out = torch.empty((1, k), dtype=torch.float32, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if route == "gather":
            partial = torch.empty((lib.gather_min_chunks(r), k),
                                  dtype=torch.float32, device=d.device)
            rc = lib.gather_min_launch(d.data_ptr(), idx.data_ptr(), r, k,
                                       partial.data_ptr(), out.data_ptr(),
                                       stream)
        else:
            ranges = _scan_ranges(d.device.index, n, k)
            # one buffer: a 32-bit flag per row, padded to a multiple of 4
            # (16 bytes), then the partial rows
            flag_words = (n + 3) // 4 * 4
            scratch = torch.empty(flag_words + ranges * k,
                                  dtype=torch.float32, device=d.device)
            rc = lib.gather_min_scan_launch(
                d.data_ptr(), idx.data_ptr(), n, r, k, scratch.data_ptr(),
                ranges, scratch[flag_words:].data_ptr(), out.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(
            f"gather_min kernel launch failed ({route} route): "
            f"{lib.gather_min_error_string(rc).decode()} (code {rc}; n={n} "
            f"r={r} k={k})")
    gather_min.launches += 1
    gather_min.route_launches[route] += 1
    return out


@functools.lru_cache(maxsize=None)
def _scan_ranges(device_index: int, n: int, k: int) -> int:
    """Row ranges (partial rows) of the scan route on that card."""
    ranges = _library().gather_min_scan_ranges(n, k)
    if ranges <= 0:
        raise RuntimeError(f"gather_min: cannot query CUDA device "
                           f"{device_index}")
    return ranges


gather_min.launches = 0
gather_min.route_launches = dict.fromkeys(ROUTES, 0)


def gather_min_reference(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_min`` on any device."""
    _check(d, idx)
    out = torch.full((1, d.shape[1]), float("inf"), dtype=torch.float32,
                     device=d.device)
    rows = idx.long()
    for s in range(0, rows.shape[0], _REF_ROWS):
        part = d[rows[s:s + _REF_ROWS]].amin(dim=0, keepdim=True)
        out = torch.minimum(out, part)  # NaN propagates, as jnp.minimum
    return out
