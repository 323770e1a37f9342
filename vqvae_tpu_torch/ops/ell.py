"""Degree-bucketed (ELL-style) graph relaxation — scatter-free sweeps.

The port of ``vqvae_tpu/ops/ell.py``: multi-source shortest paths as an
(N, K) distance matrix relaxed for all K sources at once. Nodes are grouped
into geometric in-degree buckets (``_cap_ladder``); each bucket stores a
dense (N_b, cap) neighbor-row / weight matrix padded with +inf weights, and
relaxing one row chunk is

    cand = min_j( D[nbr[:, j]] + w[:, j] )     # gathers
    D[chunk_rows] = min(D[chunk_rows], cand)    # contiguous update

The sweep is chunk-sequential Gauss-Seidel in bucket-row (permuted)
layout: each chunk's update is written back before the next chunk reads
the matrix, and the chunk order alternates forward/backward between
sweeps, so distances travel many hops per sweep along the (BFS-relabeled)
node order. The loop ends after a sweep with no improvement.

The fixed point is exact and independent of layout and order: every entry
ends as the minimum over paths of the left-to-right f32 path sum, so the
result equals the JAX engine's bit for bit. ``d0`` may carry any per-entry
upper bounds (warm starts); relaxation is monotone from above.

The sweep is a plain PyTorch loop on the device (the JAX engine has no
Pallas kernel either), with one host read a sweep.

``active`` (off by default, as in JAX) is JAX's chunk-level frontier
skipping: two row masks, ``cp`` (rows improved in the previous sweep) and
``cc`` (rows improved so far in this sweep), and a chunk is relaxed only
when some in-neighbor of its rows is marked in either. JAX decides that
on the device (``lax.cond``); this eager loop reads the decision back, one
host read a chunk, so the skipped chunks, the sweep count and the relaxed
chunks per bucket are JAX's exactly, and so is the fixed point.

``mesh`` (``parallel.Mesh``) shards the K (source) axis when the world
size divides K (JAX's ``P(None, "data")``; an uneven K stays replicated):
each rank relaxes its own block of columns (``source_columns``) to the
exact fixed point. Every operation is elementwise in K, so no collective
runs during the sweeps; the ranks may sweep different numbers of times
and ``ELL_STATS`` records the largest. With ``active`` each rank skips
chunks by its own columns' frontier: the distances are the same, the
chunk counts are the rank's own.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..parallel.mesh import all_reduce, shard_range
from ..utils.profiling import count, span

_INF = np.float32(np.inf)

# one record per solve: sweep count, wall seconds, K, effective bytes,
# chunks visited and relaxed, the relaxed share (active_frac), GB/s
ELL_STATS: list = []

# row-chunk cap of a relaxation step (bounds the live (chunk, K) buffers)
ROW_CHUNK = 8192
# f32 elements of the live (chunk, deg_block, K) gather buffer
DEG_BLOCK_BUDGET = 10_000_000


class BucketedGraph(NamedTuple):
    """Degree-bucketed in-neighbor structure on one device.

    Rows of all buckets are concatenated into one padded row space;
    ``inv_perm`` maps node id -> row, ``perm_nodes`` row -> node id (dummy
    pad rows gather row 0 and carry +inf weights). ``nbrs`` stores ROW ids
    so relaxation gathers stay in row space end to end.
    """

    nbrs: Tuple[torch.Tensor, ...]   # per bucket: (N_b, cap_b) int32 rows
    wts: Tuple[torch.Tensor, ...]    # per bucket: (N_b, cap_b) f32 (+inf pad)
    inv_perm: torch.Tensor           # (N,) int64: node -> row
    perm_nodes: torch.Tensor         # (N_pad,) int64: row -> node (pad -> 0)
    n_nodes: int

    @staticmethod
    def from_csr(W, assume_symmetric: bool = False, device=None,
                 cap_grow: float = 1.5, min_rows: int = 8192
                 ) -> "BucketedGraph":
        """From a scipy sparse matrix with undirected traversal semantics
        (min stored weight per unordered pair, both directions).

        Symmetric matrices take the fast path (each CSR row IS the node's
        in-neighbor list); ``assume_symmetric`` also skips the O(E) check.
        ``cap_grow`` is the bucket caps' growth factor, ``min_rows`` the
        size below which a bucket merges into the next."""
        n = W.shape[0]
        Wc = W.tocsr()
        if assume_symmetric or (Wc != Wc.T).nnz == 0:
            counts = np.diff(Wc.indptr).astype(np.int64)
            return _from_sorted_impl(Wc.indices.astype(np.int32),
                                     Wc.data.astype(np.float32), counts, n,
                                     device, cap_grow, min_rows)
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
        return BucketedGraph.from_edges(
            np.concatenate([iu, ju]), np.concatenate([ju, iu]),
            np.concatenate([w_min, w_min]), n, device, cap_grow, min_rows)

    @staticmethod
    def from_edges(src, dst, w, n_nodes: int, device=None,
                   cap_grow: float = 1.5, min_rows: int = 8192
                   ) -> "BucketedGraph":
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        w = np.asarray(w, np.float32)
        order = np.argsort(dst, kind="stable")
        counts = np.bincount(dst, minlength=n_nodes).astype(np.int64)
        return _from_sorted_impl(src[order], w[order], counts, n_nodes,
                                 device, cap_grow, min_rows)

    @property
    def device(self) -> torch.device:
        return self.inv_perm.device


def _cap_ladder(max_deg: int, grow: float = 1.5) -> list:
    """Degree caps of the buckets: geometric with growth ``grow``, rounded
    to multiples of 4 (tighter caps cut the padded gather slots)."""
    caps = [8]
    while caps[-1] < max(max_deg, 8):
        nxt = max(caps[-1] + 4, int(caps[-1] * grow))
        caps.append((nxt + 3) // 4 * 4)
    return caps


def _from_sorted_impl(src: np.ndarray, w: np.ndarray, counts: np.ndarray,
                      n_nodes: int, device=None, cap_grow: float = 1.5,
                      min_rows: int = 8192) -> BucketedGraph:
    """Build from dst-sorted in-edge arrays (src[i], w[i] grouped per
    destination node with per-node ``counts``)."""
    if (w < 0).any():
        raise ValueError("Negative weights")
    dev = resolve_device(device)
    starts = np.concatenate([[0], np.cumsum(counts)])[:n_nodes]
    e_total = len(src)
    max_deg = int(counts.max()) if n_nodes else 0
    caps = _cap_ladder(max_deg, cap_grow)
    bucket_of = np.searchsorted(np.asarray(caps), np.maximum(counts, 1))

    # merge sparsely-populated buckets upward: every bucket costs its own
    # chunk loop in the sweep
    sizes = np.bincount(bucket_of, minlength=len(caps))
    for b in range(len(caps) - 1):
        if 0 < sizes[b] < min_rows:
            bucket_of[bucket_of == b] = b + 1
            sizes[b + 1] += sizes[b]
            sizes[b] = 0

    # pass 1: bucket membership, row offsets, inv_perm
    node_order, row_offsets, pads = [], [], []
    offset = 0
    for b in range(len(caps)):
        nodes_b = np.nonzero(bucket_of == b)[0]
        node_order.append(nodes_b)
        row_offsets.append(offset)
        chunk_b = _row_chunk(nodes_b.size)
        n_pad = (max(chunk_b, -(-nodes_b.size // chunk_b) * chunk_b)
                 if nodes_b.size else 0)
        pads.append(n_pad)
        offset += n_pad
    inv_perm = np.empty(n_nodes, np.int64)
    for b, nodes_b in enumerate(node_order):
        if nodes_b.size:
            inv_perm[nodes_b] = row_offsets[b] + np.arange(nodes_b.size)
    perm_nodes = np.zeros(max(offset, 1), np.int64)
    perm_nodes[inv_perm] = np.arange(n_nodes)
    src_rows = (inv_perm[src].astype(np.int32) if e_total
                else src.astype(np.int32))

    # pass 2: padded (rows, cap) neighbor/weight matrices per bucket
    fill = native.ell_fill_bucket if native.available() else None
    w = np.ascontiguousarray(w, np.float32)
    src_rows = np.ascontiguousarray(src_rows, np.int32)
    nbrs, wts = [], []
    for b, cap in enumerate(caps):
        nodes_b = node_order[b]
        if nodes_b.size == 0:
            nbrs.append(torch.zeros((0, cap), dtype=torch.int32, device=dev))
            wts.append(torch.zeros((0, cap), dtype=torch.float32, device=dev))
            continue
        n_pad = pads[b]
        if fill is not None and e_total:
            nb, wb = fill(src_rows, w, starts[nodes_b], counts[nodes_b],
                          n_pad, cap)
        else:
            offs = starts[nodes_b][:, None] + np.arange(cap)[None, :]
            valid = np.arange(cap)[None, :] < counts[nodes_b][:, None]
            offs = np.clip(offs, 0, max(e_total - 1, 0))
            nb = np.where(valid, src_rows[offs] if e_total else 0,
                          0).astype(np.int32)
            wb = np.where(valid, w[offs] if e_total else _INF,
                          _INF).astype(np.float32)
            if n_pad > nodes_b.size:  # dummy rows: row 0, +inf weights
                extra = n_pad - nodes_b.size
                nb = np.concatenate([nb, np.zeros((extra, cap), np.int32)])
                wb = np.concatenate([wb, np.full((extra, cap), _INF,
                                                 np.float32)])
        nbrs.append(torch.from_numpy(nb).to(dev))
        wts.append(torch.from_numpy(wb).to(dev))
    return BucketedGraph(
        nbrs=tuple(nbrs), wts=tuple(wts),
        inv_perm=torch.from_numpy(inv_perm).to(dev),
        perm_nodes=torch.from_numpy(
            perm_nodes[:offset] if offset else perm_nodes).to(dev),
        n_nodes=int(n_nodes))


def _deg_block(chunk: int, deg: int, k: int) -> int:
    """Neighbor columns gathered per relaxation step: as many as keep the
    (chunk, B, K) gather buffer within ``DEG_BLOCK_BUDGET`` elements, then
    halved until B divides the cap."""
    b = min(max(1, DEG_BLOCK_BUDGET // max(chunk * k, 1)), deg)
    while deg % b:
        b //= 2
    return max(b, 1)


def _row_chunk(n_rows: int) -> int:
    """Power-of-two row chunk, at most ``ROW_CHUNK``."""
    if n_rows <= 0:
        return 1
    c = 1
    while c < min(n_rows, ROW_CHUNK):
        c *= 2
    return c


@torch.no_grad()
def _ell_run(graph: BucketedGraph, d0: torch.Tensor, max_iters: int,
             active: bool = False):
    """Gauss-Seidel relaxation in bucket-row layout; returns (distances in
    node order, sweeps, relaxed chunks per bucket)."""
    k = d0.shape[1]
    d_perm = d0[graph.perm_nodes]  # (N_pad, K) row-space distances
    n_rows = d_perm.shape[0]
    offsets = np.cumsum([0] + [int(nb.shape[0]) for nb in graph.nbrs])
    counts = [0] * len(graph.nbrs)
    cp = torch.ones(n_rows, dtype=torch.bool, device=d0.device)
    it, changed = 0, True
    while changed and it < max_iters:
        with span("vqvae.kmedoids.ell_sweep"):
            reverse = it % 2 == 1
            changed_dev = torch.zeros((), dtype=torch.bool, device=d0.device)
            cc = torch.zeros(n_rows, dtype=torch.bool, device=d0.device)
            for b, (nb_all, wb_all) in enumerate(zip(graph.nbrs, graph.wts)):
                rows, deg = nb_all.shape
                if rows == 0:
                    continue
                chunk = _row_chunk(rows)
                n_chunks = rows // chunk
                blk = _deg_block(chunk, deg, k)
                for i in range(n_chunks):
                    idx = n_chunks - 1 - i if reverse else i
                    r0 = int(offsets[b]) + idx * chunk
                    nb = nb_all[idx * chunk:(idx + 1) * chunk]
                    if active and not bool((cp[nb] | cc[nb]).any()):
                        continue  # no in-neighbor moved: its candidates stand
                    wb = wb_all[idx * chunk:(idx + 1) * chunk]
                    cur = d_perm[r0:r0 + chunk]
                    new = cur
                    if blk > 1:
                        nbb = nb.view(chunk, deg // blk, blk)
                        wbb = wb.view(chunk, deg // blk, blk)
                        for j in range(deg // blk):
                            cand = d_perm[nbb[:, j]] + wbb[:, j, :, None]
                            new = torch.minimum(new, cand.amin(dim=1))
                    else:
                        for j in range(deg):
                            new = torch.minimum(
                                new, d_perm[nb[:, j]] + wb[:, j, None])
                    if active:
                        row_ch = (new < cur).any(dim=1)
                        cc[r0:r0 + chunk] = row_ch
                        changed_dev |= row_ch.any()
                    else:
                        changed_dev |= (new < cur).any()
                    d_perm[r0:r0 + chunk] = new
                    counts[b] += 1
            changed = bool(changed_dev)  # one host read a sweep
        count("vqvae.kmedoids.ell_sweeps")
        cp = cc
        it += 1
    return d_perm[graph.inv_perm], it, counts


def source_columns(k: int, mesh) -> Tuple[int, int]:
    """(start, stop) of the source columns this rank relaxes: its block of
    K when the mesh shards it (K divisible by the world size), else all."""
    if mesh is None or k % mesh.world_size:
        return 0, k
    return shard_range(k, mesh)


def multi_source_shortest_paths_ell(graph: BucketedGraph, sources,
                                    d0: Optional[torch.Tensor] = None,
                                    max_iters: Optional[int] = None,
                                    active: bool = False,
                                    return_iters: bool = False,
                                    mesh=None):
    """(N, K) distances (a tensor on ``graph.device``) from each of K
    sources, by bucketed Gauss-Seidel relaxation.

    ``d0``: optional (N, K) per-entry upper bounds to warm-start from (the
    cold start is +inf everywhere, 0 at each source's own column).
    ``active``: chunk-level frontier skipping (see the module notes).
    ``return_iters`` also returns the sweep count. ``mesh``: shard K over
    its ranks; each rank then returns its columns ``source_columns(K,
    mesh)`` only, and ``d0`` may hold all K columns or just those."""
    dev = graph.device
    sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64,
                              device=dev)
    c0, c1 = source_columns(int(sources.shape[0]), mesh)
    if d0 is not None and d0.shape[1] == sources.shape[0]:
        d0 = d0[:, c0:c1]
    sources = sources[c0:c1]
    k = int(sources.shape[0])
    n = graph.n_nodes
    if d0 is None:
        d0 = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
        d0[sources, torch.arange(k, device=dev)] = 0.0
    if max_iters is None:
        max_iters = n + 1
    t0 = time.perf_counter()
    d, iters, counts = _ell_run(graph, d0, max_iters, active)
    iters = int(all_reduce(torch.tensor([iters]), mesh, "max")[0])
    dt = time.perf_counter() - t0
    # relaxed chunk of bucket b: a (K,) distance row + weight + index per
    # edge slot (+ two mask bytes when active), read + write of its
    # (chunk, K) rows; a skipped chunk: its index slice + two mask gathers
    swept = visits = relaxed = 0
    for b, nb in enumerate(graph.nbrs):
        rows, deg = int(nb.shape[0]), int(nb.shape[1])
        if rows == 0:
            continue
        chunk = _row_chunk(rows)
        slots = chunk * deg
        n_chunks = rows // chunk
        swept += counts[b] * (slots * (k * 4 + 8 + (2 if active else 0))
                              + 2 * chunk * k * 4)
        swept += max(iters * n_chunks - counts[b], 0) * slots * 6
        visits += iters * n_chunks
        relaxed += counts[b]
    ELL_STATS.append({"iters": iters, "seconds": dt, "k": k, "bytes": swept,
                      "chunk_visits": visits, "chunk_relaxed": relaxed,
                      "active_frac": relaxed / max(visits, 1),
                      "gbps": swept / max(dt, 1e-9) / 1e9})
    return (d, iters) if return_iters else d
