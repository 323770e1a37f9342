"""Nearest-code assignment: kernel K3.

The port of ``vqvae_tpu/ops/pallas_assign.py`` ``nearest_codes``. On a CUDA
tensor ``nearest_codes`` launches the hand-written Hopper kernel in
``csrc/assign.cu`` (built with ``nvcc`` at first use, bound with ctypes,
launched on the current stream); on a CPU tensor it runs
``nearest_codes_reference``, the plain PyTorch version of the same function.
Host arrays (numpy, as the JAX function takes) go to ``device`` first,
which defaults to CUDA.

Both compute the TPU kernel's formula at full f32: ``d2 = |c|^2 - 2 z.c``,
the first index of the smallest ``d2`` per row, and ``max(min d2 + |z|^2,
0)`` as the squared distance. Squared norms are left-to-right fused
multiply-add chains (``knn_select.dot_last``), as the kernel and XLA's
jitted reductions compute them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .._build import load_cuda_library
from ..device import resolve_device
from .knn_select import dot_last

# widest latent the kernel takes (csrc/assign.cu)
MAX_DIM = 128
# elements of the (rows, K) distance block the plain version materializes
# per step
_REF_BLOCK_ELEMS = 1 << 24

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "assign_launch": ([_VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP], _CI),
    "assign_work_bytes": ([_CI, _CI, _CI], _CI),
    "assign_error_string": ([_CI], ctypes.c_char_p),
}


def build() -> str:
    """Build (or reuse) the kernel library; returns nvcc's output."""
    return load_cuda_library("assign.cu", _SIGNATURES)[1]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return load_cuda_library("assign.cu", _SIGNATURES)[0]


@functools.lru_cache(maxsize=None)
def _work_words(n: int, d: int, k: int) -> int:
    """int64 words of scratch the kernel takes at this shape
    (``assign_work_bytes``: the padded codebook, or the code slices'
    partial results), rounded up to 16 bytes."""
    nbytes = _library().assign_work_bytes(n, d, k)
    if nbytes < 0:
        raise RuntimeError(f"assign_work_bytes failed (n={n} d={d} k={k})")
    return 2 * -(-nbytes // 16)



def _check(z: torch.Tensor, codebook: torch.Tensor) -> None:
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("nearest_codes takes float32 tensors")
    if z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes {tuple(z.shape)} / {tuple(codebook.shape)}")
    if codebook.shape[0] == 0:
        raise ValueError("empty codebook")
    if z.device != codebook.device:
        raise ValueError("z and codebook must lie on one device")


def nearest_codes(z, codebook, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (N,) int64, squared distance (N,) f32) of the nearest row of
    ``codebook`` (K, D) to each row of ``z`` (N, D).

    CUDA tensors launch kernel K3; CPU tensors run
    ``nearest_codes_reference``. Host arrays are moved to ``device``
    (default CUDA; raises without it).
    """
    if not isinstance(z, torch.Tensor):
        dev = resolve_device(device)
        z = torch.from_numpy(np.ascontiguousarray(z, np.float32)).to(dev)
        codebook = torch.from_numpy(
            np.ascontiguousarray(codebook, np.float32)).to(dev)
    _check(z, codebook)
    if z.device.type == "cpu":
        return nearest_codes_reference(z, codebook)
    if z.device.type != "cuda":
        raise ValueError(f"nearest_codes: unsupported device {z.device}")
    n, d = z.shape
    if d > MAX_DIM:
        raise ValueError(f"nearest_codes: D={d} > {MAX_DIM}, the widest "
                         f"latent kernel K3 takes")
    z = z.contiguous()
    codebook = codebook.contiguous()
    k = codebook.shape[0]
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=z.device),
                torch.empty(0, dtype=torch.float32, device=z.device))
    # one allocation: the kernel's scratch (16-byte aligned), the indices,
    # then the distances (f32, two to a word)
    work = _work_words(n, d, k)
    buf = torch.empty(work + n + (n + 1) // 2, dtype=torch.int64,
                      device=z.device)
    idx = buf[work:work + n]
    dist = buf[work + n:].view(torch.float32)[:n]
    lib = _library()
    dev = z.device
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        rc = lib.assign_launch(z.data_ptr(), codebook.data_ptr(), n, d, k,
                               buf.data_ptr(), idx.data_ptr(),
                               dist.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"assign kernel launch failed: "
            f"{lib.assign_error_string(rc).decode()} (code {rc}; n={n} d={d} "
            f"k={k})")
    nearest_codes.launches += 1
    return idx, dist


nearest_codes.launches = 0


def nearest_codes_reference(z: torch.Tensor, codebook: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``nearest_codes`` on any device."""
    _check(z, codebook)
    cb_sq = dot_last(codebook, codebook)
    z_sq = dot_last(z, z)
    n, k = z.shape[0], codebook.shape[0]
    idx = torch.empty(n, dtype=torch.int64, device=z.device)
    best = torch.empty(n, dtype=torch.float32, device=z.device)
    step = max(1, _REF_BLOCK_ELEMS // k)
    for s in range(0, n, step):
        d2 = cb_sq[None, :] - 2.0 * (z[s:s + step] @ codebook.T)
        i = torch.argmin(d2, dim=1)  # first index on ties
        idx[s:s + step] = i
        best[s:s + step] = torch.gather(d2, 1, i[:, None])[:, 0]
    return idx, torch.clamp_min(best + z_sq, 0.0)
