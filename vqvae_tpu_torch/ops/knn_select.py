"""Fused kNN candidate selection: kernels K1 (packed) and K2 (unpacked).

The port of ``vqvae_tpu/ops/pallas_knn.py`` ``fused_select``. On a CUDA
tensor ``fused_select`` launches the hand-written Hopper kernel in
``csrc/knn_select.cu`` (built with ``nvcc`` at first use, bound with
ctypes, launched on the current stream); on a CPU tensor it runs
``fused_select_reference``, the plain PyTorch version of the same function
(same augmented matmul, key packing, binned top-2 and extraction).

Per query row: squared-Euclidean (or cosine) selection values to every
database row from one augmented matmul ``[-2q; |q|^2; 1]^T [x; 1; |x|^2]``,
rows >= ``n_valid`` masked to +inf; each slot ``row mod bins`` keeps its two
smallest values; the ``k_sel`` smallest of the ``2*bins`` accumulator
entries come out ascending, ties to the lowest accumulator column.
``packed``: values are clamped >= 0 and carry the block id ``row div bins``
in their low ``blk_bits`` mantissa bits (one i32 compare per update),
decoded to (truncated distance, block*bins + slot) or (non-finite, -1).
Unpacked: (distance, row id) pairs, the earlier row winning ties; entries
never filled stay (+inf, -1). Distances are selection values, not exact:
callers re-rank exactly (``ops/knn.py``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import load_cuda_library

_BIG_I32 = 2**31 - 1
# the JAX kernel's candidate lane width: k_sel must fit in it
CAND_LANES = 128
# elements of the (rows, N) distance block the plain version materializes
# per step, bounding its memory at large N
_REF_BLOCK_ELEMS = 1 << 26

# widest feature dimension the kernels take (their shared memory per block)
MAX_KERNEL_DIM = 128

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "knn_select_launch": ([_VP, _VP] + [_CI] * 9 + [_VP] * 6, _CI),
    "knn_select_work_floats": ([_CI] * 3, _CI),
    "knn_select_error_string": ([_CI], ctypes.c_char_p),
}


def build() -> str:
    """Build (or reuse) the kernel library; returns nvcc's output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    return load_cuda_library("knn_select.cu", _SIGNATURES)[1]


def _library() -> ctypes.CDLL:
    return load_cuda_library("knn_select.cu", _SIGNATURES)[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def packed_block_bits(np_: int, bins: int) -> int:
    """Low mantissa bits that carry the block id (pallas_knn.py:213)."""
    return max(1, (np_ // bins - 1).bit_length())


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last axis as a left-to-right chain of fused
    multiply-adds, the f32 rounding the JAX package's jitted reductions
    carry (each step is exact in f64, then rounded once to f32), so squared
    norms and re-rank distances round alike on both sides."""
    a64, b64 = a.double(), b.double()
    out = torch.zeros(a.shape[:-1], dtype=torch.float64, device=a.device)
    for j in range(a.shape[-1]):
        out = (out + a64[..., j] * b64[..., j]).float().double()
    return out.float()


def _augment(zq: torch.Tensor, z: torch.Tensor, metric: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Qp, Da), (Np, Da) augmented operands, Da = round_up(D + 2, 4)
    (zero columns change no sum)."""
    ones_q = torch.ones((zq.shape[0], 1), dtype=zq.dtype, device=zq.device)
    ones_x = torch.ones((z.shape[0], 1), dtype=z.dtype, device=z.device)
    if metric == "cosine":
        qa = torch.cat([-zq, ones_q], dim=1)
        xa = torch.cat([z, ones_x], dim=1)
    elif metric == "euclidean":
        qa = torch.cat([-2.0 * zq, dot_last(zq, zq)[:, None], ones_q], 1)
        xa = torch.cat([z, ones_x, dot_last(z, z)[:, None]], 1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    pad = _round_up(qa.shape[1], 4) - qa.shape[1]
    qa = torch.nn.functional.pad(qa, (0, pad)).contiguous()
    xa = torch.nn.functional.pad(xa, (0, pad)).contiguous()
    return qa, xa


def _check(zq, z, n_valid, bins, k_sel, packed) -> int:
    if zq.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError("fused_select takes float32 tensors")
    if zq.ndim != 2 or z.ndim != 2 or zq.shape[1] != z.shape[1]:
        raise ValueError(f"shapes {tuple(zq.shape)} / {tuple(z.shape)}")
    if zq.device != z.device:
        raise ValueError("zq and z must lie on one device")
    if not 0 < k_sel <= CAND_LANES:
        raise ValueError(f"k_sel={k_sel} outside 1..{CAND_LANES}")
    if bins <= 0 or z.shape[0] % bins:
        raise ValueError(f"database rows {z.shape[0]} not a multiple of "
                         f"bins={bins}")
    if not 0 <= n_valid <= z.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside 0..{z.shape[0]}")
    if not packed:
        return 0
    if bins & (bins - 1):
        raise ValueError("packed selection requires power-of-two bins")
    blk_bits = packed_block_bits(z.shape[0], bins)
    if blk_bits > 16:
        raise ValueError(
            f"packed selection would truncate {blk_bits} > 16 mantissa bits "
            f"at N={z.shape[0]}, bins={bins}; raise bins or use unpacked")
    return blk_bits


def fused_select(zq: torch.Tensor, z: torch.Tensor, n_valid: int, *,
                 metric: str, bins: int, k_sel: int, packed: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k_sel`` candidate (selection values (Qp, k_sel) f32, indices
    (Qp, k_sel) int32) of each query row of ``zq`` among the rows of ``z``.

    ``z`` (Np, D) has Np % bins == 0; rows >= ``n_valid`` are padding.
    CUDA tensors launch kernel K1 (``packed``) or K2; CPU tensors run
    ``fused_select_reference``.
    """
    blk_bits = _check(zq, z, n_valid, bins, k_sel, packed)
    if zq.device.type == "cpu":
        return fused_select_reference(zq, z, n_valid, metric=metric,
                                      bins=bins, k_sel=k_sel, packed=packed)
    if zq.device.type != "cuda":
        raise ValueError(f"fused_select: unsupported device {zq.device}")
    if zq.shape[1] > MAX_KERNEL_DIM:
        raise ValueError(f"fused_select on the GPU takes D <= "
                         f"{MAX_KERNEL_DIM} features, got {zq.shape[1]}")
    if z.shape[0] // bins > 0xFFFF:
        raise ValueError(f"fused_select on the GPU takes at most 65,535 "
                         f"blocks of bins={bins} rows, got "
                         f"{z.shape[0] // bins}")
    lib = _library()
    qa, xa = _augment(zq, z, metric)
    qp, np_ = qa.shape[0], xa.shape[0]
    dev = zq.device
    out_d = torch.empty((qp, k_sel), dtype=torch.float32, device=dev)
    out_i = torch.empty((qp, k_sel), dtype=torch.int32, device=dev)
    if qp == 0:
        return out_d, out_i
    # the kernels' scratch: split operands and candidate lists (work), the
    # first walk's per (query row, slot) values, then the entries of rows
    # that settle in full (acc, and acc_i for their row ids unpacked)
    work = torch.empty(lib.knn_select_work_floats(qp, np_, zq.shape[1]),
                       dtype=torch.float32, device=dev)
    acc = torch.empty((qp, 2 * bins), dtype=torch.int32, device=dev)
    acc_i = (acc if packed else
             torch.empty((qp, 2 * bins), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_select_launch(
            qa.data_ptr(), xa.data_ptr(), qp, np_, qa.shape[1], zq.shape[1],
            int(n_valid), bins, k_sel, int(packed), blk_bits,
            work.data_ptr(), acc.data_ptr(), acc_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"knn_select kernel launch failed: "
            f"{lib.knn_select_error_string(rc).decode()} (code {rc}; "
            f"qp={qp} np={np_} d_aug={qa.shape[1]} bins={bins} "
            f"k_sel={k_sel} packed={packed})")
    fused_select.launches += 1
    return out_d, out_i


fused_select.launches = 0


def _top2_along_blocks(v: torch.Tensor, ids: torch.Tensor):
    """Per slot (last axis), the two smallest of ``v`` (T, n_blocks, bins)
    with the earlier block first among equals — what the sequential strict-<
    update leaves in its two accumulators; ``ids`` (n_blocks, bins) gives
    each entry's row id (-1 where the value is +inf, as never filled)."""
    big = (torch.iinfo(v.dtype).max if not v.is_floating_point()
           else float("inf"))
    j1 = torch.argmin(v, dim=1, keepdim=True)          # first occurrence
    v1 = torch.gather(v, 1, j1)
    if v.shape[1] > 1:
        rest = v.scatter(1, j1, big)
        j2 = torch.argmin(rest, dim=1, keepdim=True)
        v2 = torch.gather(rest, 1, j2)
    else:
        j2 = j1
        v2 = torch.full_like(v1, big)
    ids_b = ids.unsqueeze(0).expand(v.shape[0], -1, -1)
    i1 = torch.gather(ids_b, 1, j1)
    i2 = torch.gather(ids_b, 1, j2)
    return v1[:, 0], v2[:, 0], i1[:, 0], i2[:, 0]


def fused_select_reference(zq: torch.Tensor, z: torch.Tensor, n_valid: int,
                           *, metric: str, bins: int, k_sel: int,
                           packed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_select`` on any device."""
    blk_bits = _check(zq, z, n_valid, bins, k_sel, packed)
    qa, xa = _augment(zq, z, metric)
    qp, np_ = qa.shape[0], xa.shape[0]
    n_blocks = np_ // bins
    dev = zq.device
    lo_mask = (1 << blk_bits) - 1
    hi_mask = ~lo_mask
    col = torch.arange(np_, device=dev)
    block_id = (col // bins).to(torch.int32)
    ids = col.to(torch.int32).view(n_blocks, bins)
    out_d = torch.empty((qp, k_sel), dtype=torch.float32, device=dev)
    out_i = torch.empty((qp, k_sel), dtype=torch.int32, device=dev)
    step = max(1, _REF_BLOCK_ELEMS // max(np_, 1))
    for s in range(0, qp, step):
        e = min(s + step, qp)
        d = qa[s:e] @ xa.T                                     # (T, Np)
        if packed:
            d = d.clamp_min(0.0)
        d[:, n_valid:] = float("inf")
        if packed:
            keys = (d.view(torch.int32) & hi_mask) | block_id
            k1, k2, _, _ = _top2_along_blocks(
                keys.view(e - s, n_blocks, bins), ids)
            full = torch.cat([k1, k2], dim=1)                  # (T, 2*bins)
        else:
            a1, a2, i1, i2 = _top2_along_blocks(
                d.view(e - s, n_blocks, bins), ids)
            i1 = torch.where(torch.isinf(a1), -1, i1)
            i2 = torch.where(torch.isinf(a2), -1, i2)
            full = torch.cat([a1, a2], dim=1)
            full_i = torch.cat([i1, i2], dim=1)
        for t in range(k_sel):
            c = torch.argmin(full, dim=1, keepdim=True)        # first column
            v = torch.gather(full, 1, c)
            if packed:
                dist = (v & hi_mask).view(torch.float32)
                cid = (v & lo_mask) * bins + (c.to(torch.int32) & (bins - 1))
                out_d[s:e, t] = dist[:, 0]
                out_i[s:e, t] = torch.where(torch.isfinite(dist), cid, -1)[:, 0]
                full = full.scatter(1, c, _BIG_I32)
            else:
                out_d[s:e, t] = v[:, 0]
                out_i[s:e, t] = torch.gather(full_i, 1, c)[:, 0]
                full = full.scatter(1, c, float("inf"))
    return out_d, out_i
