"""Reference-compatible geodesic shortest-path API — the port of
``vqvae_tpu/ops/geo_compat.py``.

The reference's geo layer signatures: scipy-layout (K, N) outputs,
``unweighted`` hop counts, ``return_predecessors`` with scipy's -9999
sentinel, and the validated-graph contract. Distances go through the
work-based backend (``ops/backend.py``: native host Dijkstra or the
device relaxation); predecessor queries run on the native host Dijkstra
(path reconstruction is a sequential consumer on the host).
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
from scipy import sparse

from .backend import multi_source_distances


def ensure_valid_graph(W) -> sparse.csr_matrix:
    """A square scipy sparse matrix with no negative weight, as CSR."""
    if not sparse.issparse(W):
        raise TypeError("W must be a scipy sparse matrix")
    if W.shape[0] != W.shape[1]:
        raise ValueError("W must be square")
    if W.nnz > 0 and (W.data < 0).any():
        raise ValueError("Negative weights")
    return W.tocsr()


def _prep(W, unweighted: bool) -> sparse.csr_matrix:
    W = ensure_valid_graph(W)
    if unweighted and W.nnz > 0:
        W = W.copy()
        W.data.fill(1.0)
    return W


def dijkstra_multi_source(
    W,
    sources,
    directed: bool = False,
    unweighted: bool = False,
    return_predecessors: bool = False,
    dtype=np.float32,
    device=None,
) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """(K, N) distances (and the (K, N) int32 predecessors). ``device``
    places the device relaxation when the backend takes it (None means
    CUDA)."""
    if len(sources) == 0:
        raise ValueError("sources must be a non-empty sequence of node "
                         "indices")
    if directed:
        raise NotImplementedError("directed traversal is not used by the "
                                  "pipeline; pass directed=False")
    sources = np.asarray(sources, dtype=int)
    W = _prep(W, unweighted)
    if return_predecessors:
        from .. import native

        d, p = native.dijkstra_multi_source(W, sources,
                                            return_predecessors=True)
        return d.astype(dtype, copy=False), p.astype(np.int32, copy=False)
    d = multi_source_distances(W, sources, device=device).T  # (K, N)
    return np.ascontiguousarray(d).astype(dtype, copy=False)


def dijkstra_single_source(W, source: int, directed: bool = False,
                           unweighted: bool = False,
                           return_predecessors: bool = False,
                           dtype=np.float32, device=None):
    """The 1-D form of ``dijkstra_multi_source``."""
    result = dijkstra_multi_source(W, [int(source)], directed=directed,
                                   unweighted=unweighted,
                                   return_predecessors=return_predecessors,
                                   dtype=dtype, device=device)
    if return_predecessors:
        d, p = result
        return d[0], p[0]
    return result[0]


def distances_between(W, sources, targets, directed: bool = False,
                      unweighted: bool = False, dtype=np.float32,
                      device=None) -> np.ndarray:
    """Compact (S, T) matrix: one multi-source pass, then the target
    columns."""
    if len(sources) == 0 or len(targets) == 0:
        raise ValueError("sources and targets must be non-empty.")
    d_full = dijkstra_multi_source(W, sources, directed=directed,
                                   unweighted=unweighted, dtype=dtype,
                                   device=device)
    return d_full[:, np.asarray(targets, dtype=int)]
