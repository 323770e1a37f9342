"""kNN latent-graph construction and connectivity utilities.

The port of ``vqvae_tpu/ops/graph.py``: kNN (``ops.knn``, on the device)
-> sparse CSR adjacency with ``mutual`` (min / intersection) or ``union``
(max) symmetrization, ``distance`` vs ``connectivity`` weights, self-edge
stripping, the LCC mask and the connectivity statistics; and the blocked
numpy exact kNN (``force_method="host"``). CSR assembly and component
bookkeeping are O(E) host work: scipy for small graphs, the port's native
one-pass C++ (``vqvae_tpu_torch.native``) above ``NATIVE_ASSEMBLE_MIN``
entries.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy import sparse
from scipy.sparse.csgraph import breadth_first_order, connected_components

from .. import native
from .knn import knn_search

# directed-entry count above which CSR assembly and LCC labelling route to
# the native library (tests lower it to exercise the native path)
NATIVE_ASSEMBLE_MIN = 1_000_000


def _assemble(distances: np.ndarray, indices: np.ndarray, n: int,
              mode: str, sym: str) -> sparse.csr_matrix:
    if sym not in ("mutual", "union"):
        raise ValueError(f"Invalid symmetry mode: {sym}")
    if distances.size >= NATIVE_ASSEMBLE_MIN and native.available():
        return native.knn_assemble(distances, indices, n, mode, sym)
    data = (distances.ravel() if mode == "distance"
            else np.ones(distances.size, np.float32))
    rows = np.repeat(np.arange(n), indices.shape[1])
    cols = indices.ravel()
    W = sparse.csr_matrix((data.astype(np.float32), (rows, cols)),
                          shape=(n, n))
    W = W.minimum(W.T) if sym == "mutual" else W.maximum(W.T)
    W.setdiag(0.0)
    W.eliminate_zeros()
    return W


def _strip_self(dists: np.ndarray, idxs: np.ndarray, n: int):
    """Drop the self-match: normally the first column; with exact
    duplicates a twin may rank first, so drop the row-wise argmin."""
    if (idxs[:, 0] == np.arange(n)).all():
        return dists[:, 1:], idxs[:, 1:]
    argmin = np.argmin(dists, axis=1)
    keep = np.ones_like(dists, dtype=bool)
    keep[np.arange(n), argmin] = False
    return dists[keep].reshape(n, -1), idxs[keep].reshape(n, -1)


def build_knn_graph(
    z: np.ndarray,
    k: int = 10,
    metric: str = "euclidean",
    mode: str = "distance",
    sym: str = "mutual",
    approx: bool = False,
    device=None,
    mesh=None,
) -> Tuple[sparse.csr_matrix, Dict[str, np.ndarray]]:
    """kNN graph. Returns (CSR adjacency, {"distances", "indices"}).

    k is capped at N-1, the self-neighbor is stripped, the diagonal is
    zero and the matrix is symmetrized per ``sym``. ``approx`` takes the
    fused selection route (kernels K1/K2 on the GPU). ``mesh`` shards the
    kNN's query axis (``knn_search``); the assembly then runs on every
    rank, as JAX multi-host runs it on every process.
    """
    z = np.asarray(z, np.float32)
    if z.ndim != 2:
        raise ValueError("z must be (N, D)")
    n = z.shape[0]
    if n == 0:
        return (sparse.csr_matrix((0, 0), dtype=np.float32),
                {"distances": np.empty((0, 0), np.float32),
                 "indices": np.empty((0, 0), dtype=int)})
    k_eff = max(0, min(k, n - 1))
    if k_eff == 0:
        return (sparse.csr_matrix((n, n), dtype=np.float32),
                {"distances": np.empty((n, 0), np.float32),
                 "indices": np.empty((n, 0), dtype=int)})
    dists, idxs = knn_search(z, min(k_eff + 1, n), metric=metric,
                             approx=approx, device=device, mesh=mesh)
    dists, idxs = _strip_self(dists, idxs, n)
    W = _assemble(dists, idxs, n, mode, sym)
    return W, {"distances": dists.astype(np.float32, copy=False),
               "indices": idxs}


def build_knn_graph_auto(
    z: np.ndarray,
    k: int = 10,
    metric: str = "euclidean",
    mode: str = "distance",
    sym: str = "mutual",
    force_method: Optional[str] = None,
    device=None,
    mesh=None,
) -> Tuple[sparse.csr_matrix, Dict[str, np.ndarray]]:
    """Reference-compatible entry point: ``force_method="approx"`` takes
    the fused selection, ``"host"`` the blocked numpy exact kNN (the
    oracle that needs no device), anything else the exact device route
    (one tiled kernel covers all N, so the reference's size threshold has
    no counterpart)."""
    if force_method == "host":
        return _build_knn_graph_host(z, k, metric, mode, sym, device)
    return build_knn_graph(z, k=k, metric=metric, mode=mode, sym=sym,
                           approx=(force_method == "approx"), device=device,
                           mesh=mesh)


def _build_knn_graph_host(z, k, metric, mode, sym, device=None):
    """Blocked numpy exact kNN: ``|a|^2 - 2 a.b + |b|^2`` (or ``1 - a.b``
    for cosine) a block of rows at a time, ``argpartition`` then a stable
    sort of the k + 1 candidates, then the self-match stripped."""
    z = np.asarray(z, np.float32)
    n = z.shape[0]
    k_eff = max(0, min(k, n - 1))
    if n == 0 or k_eff == 0:
        return build_knn_graph(z, k, metric, mode, sym, device=device)
    if metric == "cosine":
        zn = z / (np.linalg.norm(z, axis=1, keepdims=True) + 1e-8)
    else:
        zn = z
    sq = (zn * zn).sum(1)
    kq = min(k_eff + 1, n)
    dists = np.empty((n, kq), np.float32)
    idxs = np.empty((n, kq), np.int64)
    block = max(1, 2_000_000 // max(n, 1))
    for s in range(0, n, block):
        e = min(s + block, n)
        dots = zn[s:e] @ zn.T
        d = ((1.0 - dots) if metric == "cosine"
             else (sq[s:e, None] - 2 * dots + sq[None, :]))
        part = np.argpartition(d, kq - 1, axis=1)[:, :kq]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idxs[s:e] = np.take_along_axis(part, order, axis=1)
        dists[s:e] = np.take_along_axis(pd, order, axis=1)
    if metric == "euclidean":
        dists = np.sqrt(np.maximum(dists, 0.0))
    dists, idxs = _strip_self(dists, idxs, n)
    W = _assemble(dists, idxs, n, mode, sym)
    return W, {"distances": dists, "indices": idxs}


def bfs_node_order(W: sparse.csr_matrix) -> np.ndarray:
    """BFS relabeling permutation ``perm[new_id] = old_id``, restarting at
    the lowest unvisited node, over stored edges (the builders hand in
    symmetrized graphs). Makes shortest paths roughly monotone in node id,
    so the alternating Gauss-Seidel sweeps converge in a few passes."""
    n = W.shape[0]
    W = W.tocsr()
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for start in range(n):
        if visited[start]:
            continue
        nodes = breadth_first_order(W, start, directed=True,
                                    return_predecessors=False)
        nodes = nodes[~visited[nodes]]
        visited[nodes] = True
        order[pos:pos + len(nodes)] = nodes
        pos += len(nodes)
        if pos == n:
            break
    return order


def largest_connected_component(W: sparse.csr_matrix) -> np.ndarray:
    """Boolean mask of the nodes in the largest component (large graphs go
    to the native union-find; the mask does not depend on labels)."""
    if W.nnz >= NATIVE_ASSEMBLE_MIN and native.available():
        n_comp, labels = native.connected_components(W.tocsr())
    else:
        n_comp, labels = connected_components(W, directed=False)
    if n_comp <= 1:
        return np.ones(W.shape[0], dtype=bool)
    return labels == np.argmax(np.bincount(labels))


def symmetric_csr_from_edges(rows: np.ndarray, cols: np.ndarray,
                             w: np.ndarray, n: int) -> sparse.csr_matrix:
    """Symmetric CSR from a unique undirected edge list (``rows < cols``,
    no duplicates): scipy-identical to ``csr((w, (rows, cols))) + .T``;
    large lists go to the native one-pass assembler, which requires
    ``rows < cols`` (checked here)."""
    if 2 * rows.shape[0] >= NATIVE_ASSEMBLE_MIN and native.available():
        if rows.shape[0] and not bool(np.all(rows < cols)):
            raise ValueError(
                "symmetric_csr_from_edges: edge list must satisfy rows < cols "
                "(upper-triangular, self-loop-free) for the native assembly")
        return native.edges_assemble(rows, cols, w, n)
    W = sparse.csr_matrix((w, (rows, cols)), shape=(n, n))
    return W + W.T


def analyze_graph_connectivity(W: sparse.csr_matrix) -> Dict:
    """Connectivity statistics: node and edge counts, the components, the
    largest one's size and share, and the weighted degrees' mean, min and
    max."""
    n = W.shape[0]
    n_components, labels = connected_components(W, directed=False)
    largest = int(np.bincount(labels).max()) if n_components > 1 else n
    degrees = np.asarray(W.sum(axis=1)).ravel()
    return {
        "n_nodes": n,
        "n_edges": int(W.nnz),
        "n_components": int(n_components),
        "largest_component_size": largest,
        "connectivity_ratio": largest / max(n, 1),
        "avg_degree": float(degrees.mean()) if n else 0.0,
        "min_degree": float(degrees.min()) if n else 0.0,
        "max_degree": float(degrees.max()) if n else 0.0,
    }
