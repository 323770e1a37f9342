"""The host-side prep inside ``fit_kmedoids``, timed step by step.

The port of ``tools/bench_kmedoids_prep.py``: on ``make_random_graph``'s
symmetric CSR (a copy of JAX's: ``--nodes`` x ``--k`` draws from numpy
``default_rng(0)``, 80 % id-local edges, wrapped, weights in [0.1, 1.1)),
the seconds of the BFS node order (``ops.graph.bfs_node_order``), the CSR
permutation done two ways (scipy's double fancy index, which
``fit_kmedoids`` runs, and a COO rebuild; spot-checked equal), and
``BucketedGraph.from_csr`` of the permuted graph with
``assume_symmetric`` (the fast path) and without it (the dedup path),
each built on ``--device``.

Run: ``python -m vqvae_tpu_torch.tools.bench_kmedoids_prep
[--nodes 983040] [--k 10] [--device cpu]``; prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch
from scipy import sparse

from ..device import resolve_device
from ..ops.ell import BucketedGraph
from ..ops.graph import bfs_node_order


def make_random_graph(n: int, k: int, seed: int = 0) -> sparse.csr_matrix:
    """Symmetric CSR with about n * k undirected edges (a union-kNN-like
    shape): 80 % short-range (id-local) and 20 % long-range edges, ids
    wrapped rather than clamped, so no node gathers a giant degree."""
    rng = np.random.default_rng(seed)
    e = n * k
    rows = rng.integers(0, n - 1, size=e, dtype=np.int64)
    span = np.where(rng.random(e) < 0.8,
                    rng.integers(1, 50, size=e),
                    rng.integers(1, n, size=e))
    cols = (rows + span) % n
    rows, cols = np.minimum(rows, cols), np.maximum(rows, cols)
    keep = rows < cols
    rows, cols = rows[keep], cols[keep]
    w = rng.random(rows.size).astype(np.float32) + 0.1
    W = sparse.csr_matrix((w, (rows, cols)), shape=(n, n))
    W = W + W.T
    return W.tocsr()


def coo_permute(W: sparse.csr_matrix, perm: np.ndarray) -> sparse.csr_matrix:
    """``W[perm][:, perm]`` by relabelling the COO entries once."""
    inv = np.empty(W.shape[0], np.int64)
    inv[perm] = np.arange(W.shape[0])
    coo = W.tocoo()
    return sparse.csr_matrix((coo.data, (inv[coo.row], inv[coo.col])),
                             shape=W.shape)


def run(nodes: int = 983040, k: int = 10, device=None) -> Dict:
    """The split on ``device`` (default the GPU), in seconds."""
    dev = resolve_device(device)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t[name] = time.perf_counter() - t0
        return out

    t: Dict[str, float] = {}
    W = timed("make_graph", lambda: make_random_graph(nodes, k))
    perm = timed("bfs_node_order", lambda: bfs_node_order(W))
    Wp = timed("csr_perm_scipy_double_index", lambda: W[perm][:, perm])
    Wp2 = timed("csr_perm_coo_rebuild", lambda: coo_permute(W, perm))
    if Wp2.nnz != Wp.nnz:
        raise AssertionError("the two permutations differ in nnz")
    for r in (0, nodes // 2, nodes - 1):
        if not np.allclose(Wp[r].toarray(), Wp2[r].toarray()):
            raise AssertionError(f"the two permutations differ at row {r}")
    timed("bucketed_from_csr_sym", lambda: BucketedGraph.from_csr(
        Wp, assume_symmetric=True, device=dev))
    timed("bucketed_from_csr_dedup", lambda: BucketedGraph.from_csr(
        Wp, assume_symmetric=False, device=dev))
    return {"nodes": nodes, "nnz": int(W.nnz), "device": dev.type,
            "seconds": t}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=983040)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.nodes, args.k, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
