"""Column-wise min over randomly gathered rows: kernel K4.

The port of ``tools/bench_pallas_gather.py`` ``pallas_gather_min``: the
ELL relaxation's random-row gather-reduce ``min_j d[idx_j]`` as one
(1, K) row. On a CUDA tensor ``gather_min`` launches the hand-written
Hopper kernel in ``csrc/gather_min.cu`` (built with ``nvcc`` at first use,
bound with ctypes, launched on the current stream); on a CPU tensor it
runs ``gather_min_reference``, the plain PyTorch version: per-chunk minima
of the gathered rows, then the min of those, as the kernel reduces. Min is
exact, so both agree bitwise; NaN propagates as in ``jnp.minimum``, and a
column of nothing gathered is +inf. Host arrays go to ``device`` first
(default CUDA).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import load_cuda_library
from ..device import resolve_device

# indices per block of the kernel, the JAX tool's CHUNK
CHUNK = 1024
# gathered rows the plain version materializes per step
_REF_ROWS = 64 * CHUNK

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gather_min_launch": ([_VP, _VP, _CI, _CI, _VP, _VP, _VP], _CI),
    "gather_min_chunks": ([_CI], _CI),
    "gather_min_error_string": ([_CI], ctypes.c_char_p),
}


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


def launch_gather_min(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel K4 on CUDA tensors that ``gather_min`` has already checked
    (dtypes, shapes, indices in range): no check and no host read, so a
    timing loop measures the launches alone."""
    r, k = idx.shape[0], d.shape[1]
    out = torch.full((1, k), float("inf"), dtype=torch.float32,
                     device=d.device)
    if r == 0 or k == 0:
        return out
    lib = _library()
    d = d.contiguous()
    idx = idx.contiguous()
    partial = torch.empty((lib.gather_min_chunks(r), k), dtype=torch.float32,
                          device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = lib.gather_min_launch(d.data_ptr(), idx.data_ptr(), r, k,
                                   partial.data_ptr(), out.data_ptr(),
                                   stream)
    if rc != 0:
        raise RuntimeError(
            f"gather_min kernel launch failed: "
            f"{lib.gather_min_error_string(rc).decode()} (code {rc}; r={r} "
            f"k={k})")
    gather_min.launches += 1
    return out


gather_min.launches = 0


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
