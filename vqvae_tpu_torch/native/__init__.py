"""ctypes bindings to the port's native host graph library (graph_core.cpp).

The port's own copy of ``vqvae_tpu/native``: the same C++ functions. The
shared library is built with g++ at first use into the package's ignored
``_build/`` directory (see ``vqvae_tpu_torch._build``).

- ``dijkstra_multi_source(W_csr, sources, return_predecessors=False)`` ->
  (K, N) float32 [, (K, N) int32 predecessors, -9999 where none]
- ``connected_components(W_csr)`` -> (n_components, labels)
- ``knn_exact(z, k)`` -> (N, k) distances, (N, k) int64 indices
- ``ell_fill_bucket``, ``knn_assemble``, ``edges_assemble``
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

from .._build import load_library

_SRC = Path(__file__).parent / "graph_core.cpp"
_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread"]
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64, _INT = ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "vq_dijkstra_multi_source": (
        [_I64P, _I32P, _F32P, _I64, _I32P, _I64, _F32P, _INT], None),
    "vq_dijkstra_multi_source_pred": (
        [_I64P, _I32P, _F32P, _I64, _I32P, _I64, _F32P, _I32P, _INT], None),
    "vq_connected_components": ([_I64P, _I32P, _I64, _I32P], _I64),
    "vq_ell_fill_bucket": (
        [_I32P, _F32P, _I64P, _I64P, _I64, _I64, _I64, _I32P, _F32P, _INT],
        None),
    "vq_knn_assemble": (
        [_I64P, _F32P, _I64, _I64, _INT, _INT, _I64P, _I32P, _F32P, _INT],
        _I64),
    "vq_edges_assemble": (
        [_I64P, _I64P, _F32P, _I64, _I64, _I64P, _I32P, _F32P, _INT], _I64),
    "vq_knn_exact": ([_F32P, _I64, _I64, _I64, _F32P, _I64P, _INT], None),
}


def build() -> str:
    """Build (or reuse) the library; returns the compiler output."""
    return load_library(_SRC, _CMD, _SIGNATURES)[1]


def _load() -> ctypes.CDLL:
    return load_library(_SRC, _CMD, _SIGNATURES)[0]


def _threads() -> int:
    return int(os.environ.get("VQVAE_TPU_NATIVE_THREADS",
                              os.cpu_count() or 1))


def _csr_parts(W) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    W = W.tocsr()
    indptr = np.ascontiguousarray(W.indptr, np.int64)
    indices = np.ascontiguousarray(W.indices, np.int32)
    data = np.ascontiguousarray(W.data, np.float32)
    return indptr, indices, data, W.shape[0]


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def dijkstra_multi_source(W, sources, return_predecessors: bool = False):
    """(K, N) float32 shortest-path distances, threaded over sources; with
    ``return_predecessors`` also the (K, N) int32 predecessors (scipy's
    -9999 at each source and at unreachable nodes)."""
    lib = _load()
    indptr, indices, data, n = _csr_parts(W)
    if data.size and (data < 0).any():
        raise ValueError("Negative weights")
    sources = np.ascontiguousarray(sources, np.int32)
    if sources.size and (sources.min() < 0 or sources.max() >= n):
        raise ValueError("source index out of range")
    out = np.empty((len(sources), n), np.float32)
    if return_predecessors:
        pred = np.empty((len(sources), n), np.int32)
        lib.vq_dijkstra_multi_source_pred(
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            _ptr(data, ctypes.c_float), n, _ptr(sources, ctypes.c_int32),
            len(sources), _ptr(out, ctypes.c_float),
            _ptr(pred, ctypes.c_int32), _threads())
        return out, pred
    lib.vq_dijkstra_multi_source(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_float), n, _ptr(sources, ctypes.c_int32),
        len(sources), _ptr(out, ctypes.c_float), _threads())
    return out


def connected_components(W) -> Tuple[int, np.ndarray]:
    lib = _load()
    indptr, indices, _, n = _csr_parts(W)
    labels = np.empty(n, np.int32)
    n_comp = lib.vq_connected_components(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32), n,
        _ptr(labels, ctypes.c_int32))
    return int(n_comp), labels


def knn_exact(z: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Euclidean kNN on the host, self-matches included: (N, k)
    float32 distances ascending and int64 indices (+inf / -1 past N)."""
    lib = _load()
    z = np.ascontiguousarray(z, np.float32)
    n, d = z.shape
    dists = np.empty((n, k), np.float32)
    idx = np.empty((n, k), np.int64)
    lib.vq_knn_exact(_ptr(z, ctypes.c_float), n, d, k,
                     _ptr(dists, ctypes.c_float), _ptr(idx, ctypes.c_int64),
                     _threads())
    return dists, idx


def ell_fill_bucket(src_rows: np.ndarray, w: np.ndarray, starts: np.ndarray,
                    counts: np.ndarray, n_pad: int, cap: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (n_pad, cap) ELL bucket (row ids + weights) in one threaded
    pass; see vq_ell_fill_bucket in graph_core.cpp."""
    lib = _load()
    src_rows = np.ascontiguousarray(src_rows, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    nb = np.empty((n_pad, cap), np.int32)
    wb = np.empty((n_pad, cap), np.float32)
    lib.vq_ell_fill_bucket(
        _ptr(src_rows, ctypes.c_int32), _ptr(w, ctypes.c_float),
        _ptr(starts, ctypes.c_int64), _ptr(counts, ctypes.c_int64),
        len(starts), n_pad, cap, _ptr(nb, ctypes.c_int32),
        _ptr(wb, ctypes.c_float), _threads())
    return nb, wb


def knn_assemble(dists: np.ndarray, idxs: np.ndarray, n: int, mode: str,
                 sym: str):
    """Symmetrized kNN CSR adjacency straight from the search result —
    scipy-identical semantics (see vq_knn_assemble in graph_core.cpp)."""
    from scipy import sparse

    lib = _load()
    idxs = np.ascontiguousarray(idxs, np.int64)
    dists = np.ascontiguousarray(dists, np.float32)
    k = idxs.shape[1] if idxs.ndim == 2 else 0
    indptr = np.empty(n + 1, np.int64)
    cap = 2 * n * k
    cols = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    nnz = lib.vq_knn_assemble(
        _ptr(idxs, ctypes.c_int64), _ptr(dists, ctypes.c_float), n, k,
        1 if mode == "distance" else 0, 1 if sym == "mutual" else 0,
        _ptr(indptr, ctypes.c_int64), _ptr(cols, ctypes.c_int32),
        _ptr(w, ctypes.c_float), _threads())
    if nnz > np.iinfo(np.int32).max:
        raise OverflowError(
            f"symmetrized kNN graph has {nnz} nonzeros — exceeds int32 CSR "
            f"index range; this path needs int64 indices")
    return sparse.csr_matrix(
        (w[:nnz].copy(), cols[:nnz].copy(), indptr.astype(np.int32)),
        shape=(n, n))


def edges_assemble(rows: np.ndarray, cols: np.ndarray, w: np.ndarray,
                   n: int):
    """Symmetric CSR from a unique undirected edge list (one native pass,
    per-row sorted columns). The pairs must be unique and self-loop-free."""
    from scipy import sparse

    lib = _load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    e = rows.shape[0]
    if 2 * e > np.iinfo(np.int32).max:
        raise OverflowError(
            f"symmetric graph would have {2 * e} nonzeros — exceeds int32 "
            f"CSR index range; this path needs int64 indices")
    indptr = np.empty(n + 1, np.int64)
    out_cols = np.empty(2 * e, np.int32)
    out_w = np.empty(2 * e, np.float32)
    nnz = lib.vq_edges_assemble(
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(w, ctypes.c_float), e, n, _ptr(indptr, ctypes.c_int64),
        _ptr(out_cols, ctypes.c_int32), _ptr(out_w, ctypes.c_float),
        _threads())
    if nnz != 2 * e:
        raise RuntimeError(
            f"native edges_assemble returned nnz={nnz}, expected {2 * e} "
            f"(duplicate or self-loop edges in the input list?)")
    return sparse.csr_matrix((out_w, out_cols, indptr.astype(np.int32)),
                             shape=(n, n))


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.CalledProcessError,
            FileNotFoundError):
        return False
