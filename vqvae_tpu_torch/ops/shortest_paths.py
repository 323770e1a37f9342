"""Multi-source shortest paths by source-batched Bellman-Ford over an edge
list — the port of ``vqvae_tpu/ops/shortest_paths.py``.

The (N, K) distance matrix ``D`` is relaxed for all K sources at once,
one edge chunk at a time::

    D[dst, :] = min(D[dst, :], min over the chunk's in-edges (D[src, :] + w))

Each chunk gathers ``D[src] + w`` and scatters it into ``D`` with an
``amin`` reduction (JAX's ``segment_min`` followed by ``minimum``; the
gather is taken before the scatter, so a chunk reads the distances left
by the chunk before it, as in JAX). Sweeps alternate their chunk order
(forward, then backward), and the loop ends after a sweep that lowers no
entry, or after ``max_iters`` sweeps. The chunk size and order are JAX's,
so the sweep count is JAX's too; the fixed point is exact (every entry is
the minimum over paths of the left-to-right f32 path sum), so the
distances are JAX's bit for bit. Each sweep ends with one host read (has
anything improved?).

Edge-list convention: directed edges (src, dst, w), both directions of an
undirected graph present; padding edges are +inf self-loops on the last
node, which can never lower a distance.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device


class EdgeList(NamedTuple):
    """Static-shape directed edge list on one device."""

    src: torch.Tensor  # (E,) int64
    dst: torch.Tensor  # (E,) int64
    w: torch.Tensor    # (E,) float32 (+inf for padding)
    n_nodes: int
    dst_sorted: bool = False  # True when edges are sorted by destination

    @staticmethod
    def from_arrays(src, dst, w, n_nodes: int, pad_multiple: int = 8192,
                    device=None) -> "EdgeList":
        """Padded to a multiple of ``pad_multiple`` (at least one) with
        +inf self-loops on the last node, so destination order survives.
        ``device`` None means CUDA (raises without it)."""
        dev = resolve_device(device)
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        w = np.asarray(w, np.float32)
        if (w < 0).any():
            raise ValueError("Negative weights")
        dst_sorted = bool(len(dst) == 0 or (dst[:-1] <= dst[1:]).all())
        e = len(src)
        e_pad = max(pad_multiple,
                    ((e + pad_multiple - 1) // pad_multiple) * pad_multiple)
        if e_pad > e:
            pad_node = np.int32(max(n_nodes - 1, 0))
            src = np.concatenate([src, np.full(e_pad - e, pad_node,
                                               np.int32)])
            dst = np.concatenate([dst, np.full(e_pad - e, pad_node,
                                               np.int32)])
            w = np.concatenate([w, np.full(e_pad - e, np.inf, np.float32)])

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, dtype=dtype)

        return EdgeList(put(src, torch.int64), put(dst, torch.int64),
                        put(w, torch.float32), int(n_nodes), dst_sorted)

    @staticmethod
    def from_csr(W, pad_multiple: int = 8192, device=None) -> "EdgeList":
        """From a scipy sparse matrix with undirected traversal semantics
        (scipy dijkstra's ``directed=False``): one edge per unordered pair
        with the smaller stored weight, in both directions, sorted by
        destination (stable)."""
        from scipy import sparse

        if not sparse.issparse(W):
            raise TypeError("W must be a scipy sparse matrix")
        if W.shape[0] != W.shape[1]:
            raise ValueError("W must be square")
        n = W.shape[0]
        coo = W.tocoo()
        lo = np.minimum(coo.row, coo.col).astype(np.int64)
        hi = np.maximum(coo.row, coo.col).astype(np.int64)
        keep = lo != hi
        key = lo[keep] * n + hi[keep]
        data = coo.data[keep].astype(np.float32)
        order = np.argsort(key, kind="stable")
        key_s, w_s = key[order], data[order]
        uniq, start = np.unique(key_s, return_index=True)
        w_min = np.minimum.reduceat(w_s, start) if len(w_s) else w_s
        iu = (uniq // n).astype(np.int32)
        ju = (uniq % n).astype(np.int32)
        src = np.concatenate([iu, ju])
        dst = np.concatenate([ju, iu])
        w = np.concatenate([w_min, w_min])
        order = np.argsort(dst, kind="stable")
        return EdgeList.from_arrays(src[order], dst[order], w[order], n,
                                    pad_multiple, device=device)

    @property
    def device(self) -> torch.device:
        return self.src.device


@torch.no_grad()
def _bellman_ford(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  d0: torch.Tensor, chunk: int, max_iters: int):
    """Chunked Gauss-Seidel Bellman-Ford; returns (distances, sweeps)."""
    n_chunks = src.shape[0] // chunk
    k = d0.shape[1]
    d = d0.clone()
    it, changed = 0, True
    while changed and it < max_iters:
        reverse = it % 2 == 1
        before = d.clone()
        for i in range(n_chunks):
            idx = n_chunks - 1 - i if reverse else i
            sl = slice(idx * chunk, (idx + 1) * chunk)
            contrib = d[src[sl]] + w[sl, None]  # (chunk, K)
            d.scatter_reduce_(0, dst[sl, None].expand(chunk, k), contrib,
                              "amin")
        changed = bool((d < before).any())  # one host read a sweep
        it += 1
    return d, it


def multi_source_shortest_paths(
    edges: EdgeList,
    sources,
    unweighted: bool = False,
    chunk: int = 262_144,
    max_iters: Optional[int] = None,
    d0: Optional[torch.Tensor] = None,
    return_iters: bool = False,
):
    """(N, K) float32 distances (a tensor on ``edges.device``) from each
    source to every node; unreachable nodes get +inf. (Transposed against
    scipy's (K, N); ``geo_compat`` transposes.)

    ``unweighted`` counts hops; ``d0`` warm-starts from per-entry upper
    bounds; ``return_iters`` also returns the sweep count."""
    sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64,
                              device=edges.device)
    if sources.ndim != 1 or sources.shape[0] == 0:
        raise ValueError("sources must be a non-empty 1-D index array")
    k = int(sources.shape[0])
    n = edges.n_nodes
    if d0 is None:
        d0 = torch.full((n, k), float("inf"), dtype=torch.float32,
                        device=edges.device)
        d0[sources, torch.arange(k, device=edges.device)] = 0.0
    w = edges.w
    if unweighted:
        w = torch.where(torch.isfinite(w), torch.ones_like(w),
                        torch.full_like(w, float("inf")))
    e_pad = int(edges.src.shape[0])
    chunk = min(chunk, e_pad)
    if e_pad % chunk != 0:
        chunk = int(np.gcd(e_pad, chunk))
    if max_iters is None:
        max_iters = n + 1
    d, iters = _bellman_ford(edges.src, edges.dst, w, d0, chunk,
                             int(max_iters))
    return (d, iters) if return_iters else d


def single_source_shortest_paths(edges: EdgeList, source: int,
                                 unweighted: bool = False, **kw):
    """1-D distances (N,) from one source."""
    return multi_source_shortest_paths(edges, np.asarray([source]),
                                       unweighted, **kw)[:, 0]


def distances_between(edges: EdgeList, sources, targets,
                      unweighted: bool = False, **kw):
    """Compact (S, T) distances: one multi-source pass, then the target
    rows (the reference's semantics)."""
    sources = np.asarray(sources, np.int64)
    targets = np.asarray(targets, np.int64)
    if sources.size == 0 or targets.size == 0:
        raise ValueError("sources and targets must be non-empty.")
    d = multi_source_shortest_paths(edges, sources, unweighted, **kw)
    return d[torch.as_tensor(targets, device=d.device)].T
