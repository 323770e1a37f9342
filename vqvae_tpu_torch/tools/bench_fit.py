"""Shortest-path backends, host against device: the crossover, and k-medoids
fits by backend.

The port of ``tools/bench_fit.py``, the measurement behind
``ops.backend.HOST_WORK_THRESHOLD``. On each graph (``--graph`` a saved
CSR ``.npz``, or for each of ``--nodes`` a union kNN graph with Euclidean
distance weights over ``bench.py``-style clustered latents, seed 0):

- the grid: ``multi_source_distances`` from each of ``--sources`` counts
  of random sources on both backends, the best of ``--runs`` after a
  warm-up: ``host`` (the native threaded Dijkstra), ``device`` (the ELL
  relaxation from a bucketed graph built once, as k-medoids' passes
  reuse it) and ``device_build`` (one call from the CSR matrix, which
  builds the bucketed graph first, as a lone ``multi_source_distances``
  call does). The crossover is where device time falls below host time,
  linear in the source count between the two grid points that bracket
  it, given as work (sources x stored edges) and as work per host
  thread, the form of the threshold, for both device columns;
- ``--threads``: the host Dijkstra from 8 sources (one a thread on an
  8-thread host) with each of these thread counts
  (``VQVAE_TPU_NATIVE_THREADS``), to see whether its time scales with
  the host's threads;
- ``--codes`` (JAX's measurement): ``fit_kmedoids(init="kpp_parallel")``
  per ``--backends`` entry, its seconds and QE.

Prints one JSON object. Times are host-clock seconds to a device sync.

Run: ``python -m vqvae_tpu_torch.tools.bench_fit [--nodes 65536,262144]
[--graph <npz>] [--sources 8,32,128,512] [--threads 1,2,4,8]
[--codes 512] [--backends host,device] [--runs 2] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy import sparse

from .. import native
from ..device import resolve_device
from ..ops import build_knn_graph, fit_kmedoids
from ..ops.backend import _host_threads, multi_source_distances
from ..ops.ell import BucketedGraph


def make_latents(n_nodes: int, dim: int = 16, seed: int = 0) -> np.ndarray:
    """Clustered gaussian latents (10 overlapping lobes), as ``bench.py``
    ``make_latents``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.2, size=(10, dim)).astype(np.float32)
    labels = rng.integers(0, 10, size=n_nodes)
    z = centers[labels] + rng.normal(0, 1.0, size=(n_nodes, dim)).astype(
        np.float32)
    return z.astype(np.float32)


def _best(fn, runs: int, dev: torch.device) -> float:
    """Best seconds of ``runs`` calls of ``fn`` after one warm-up."""
    times = []
    for r in range(runs + 1):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if r:
            times.append(time.perf_counter() - t0)
    return min(times)


def crossover(grid: List[Dict], device_key: str = "device_s"
              ) -> Optional[float]:
    """The source count where device time (``device_key``) falls below
    host time, linear between the bracketing grid points; None when the
    grid does not bracket it."""
    for a, b in zip(grid, grid[1:]):
        ga = a["host_s"] - a[device_key]
        gb = b["host_s"] - b[device_key]
        if ga < 0 <= gb:
            return a["sources"] + (b["sources"] - a["sources"]) * (
                -ga / (gb - ga))
    return None


def crossover_grid(W, sources: Sequence[int] = (8, 32, 128, 512),
                   runs: int = 2, device=None, seed: int = 0) -> Dict:
    """Host and device ``multi_source_distances`` seconds over the source
    counts, and the crossover (in sources, work and work per thread)."""
    dev = resolve_device(device)
    W = W.tocsr()
    n, nnz = W.shape[0], int(W.nnz)
    t0 = time.perf_counter()
    graph = BucketedGraph.from_csr(W, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    grid = []
    for k in sources:
        src = np.sort(rng.choice(n, size=min(k, n), replace=False))
        host_s = _best(lambda: multi_source_distances(W, src, "host"), runs,
                       dev)
        device_s = _best(lambda: multi_source_distances(
            graph, src, "device", device_out=True), runs, dev)
        device_build_s = _best(lambda: multi_source_distances(
            W, src, "device", device_out=True, device=dev), runs, dev)
        grid.append({"sources": int(len(src)), "work": float(len(src) * nnz),
                     "host_s": host_s, "device_s": device_s,
                     "device_build_s": device_build_s})
        print(f"[bench_fit] {n} nodes, {nnz} edges, {len(src)} sources: "
              f"host {host_s:.4f}s, device {device_s:.4f}s (with the "
              f"graph's build {device_build_s:.4f}s)", file=sys.stderr)
    threads = _host_threads()
    out = {"nodes": n, "edges": nnz, "host_threads": threads,
           "native_threads": native._threads(),
           "device_graph_build_s": build_s, "grid": grid}
    for key, label in (("device_s", ""), ("device_build_s", "_with_build")):
        k_star = crossover(grid, key)
        out[f"crossover_sources{label}"] = k_star
        out[f"crossover_work{label}"] = (None if k_star is None
                                         else k_star * nnz)
        out[f"crossover_work_per_thread{label}"] = (
            None if k_star is None else k_star * nnz / threads)
        out[f"device_wins_everywhere{label}"] = all(
            g[key] <= g["host_s"] for g in grid)
    return out


def thread_scaling(W, n_sources: int, threads: Sequence[int],
                   runs: int = 2, seed: int = 0) -> List[Dict]:
    """Host Dijkstra seconds from ``n_sources`` sources at each thread
    count."""
    W = W.tocsr()
    rng = np.random.default_rng(seed)
    src = np.sort(rng.choice(W.shape[0], size=min(n_sources, W.shape[0]),
                             replace=False))
    prev = os.environ.get("VQVAE_TPU_NATIVE_THREADS")
    rows = []
    try:
        for t in threads:
            os.environ["VQVAE_TPU_NATIVE_THREADS"] = str(t)
            secs = _best(lambda: multi_source_distances(W, src, "host"),
                         runs, torch.device("cpu"))
            rows.append({"threads": int(t), "sources": int(len(src)),
                         "host_s": secs})
            print(f"[bench_fit] host Dijkstra, {t} threads: {secs:.4f}s",
                  file=sys.stderr)
    finally:
        if prev is None:
            os.environ.pop("VQVAE_TPU_NATIVE_THREADS", None)
        else:
            os.environ["VQVAE_TPU_NATIVE_THREADS"] = prev
    return rows


def fit_by_backend(W, codes: int, backends: Sequence[str], runs: int = 2,
                   device=None) -> Dict[str, Dict]:
    """``fit_kmedoids(init="kpp_parallel", seed=42)`` seconds (best of
    ``runs`` after a warm-up) and QE per backend."""
    dev = resolve_device(device)
    out = {}
    for backend in backends:
        qe = []
        secs = _best(lambda: qe.append(fit_kmedoids(
            W, K=codes, init="kpp_parallel", seed=42, backend=backend,
            device=dev)[2]), runs, dev)
        out[backend] = {"seconds": secs, "qe": qe[0]}
        print(f"[bench_fit] fit_kmedoids K={codes} {backend}: {secs:.3f}s "
              f"qe={qe[0]:.2f}", file=sys.stderr)
    return out


def _graphs(args, dev):
    if args.graph:
        W = sparse.load_npz(args.graph).tocsr()
        yield W
        return
    for n in (int(x) for x in args.nodes.split(",")):
        z = make_latents(n, dim=16, seed=0)
        W, _ = build_knn_graph(z, k=args.knn, metric="euclidean",
                               mode="distance", sym="union", device=dev)
        yield W


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", default="65536",
                    help="comma list of node counts of generated graphs")
    ap.add_argument("--graph", default=None,
                    help="a saved CSR graph (.npz) instead of --nodes")
    ap.add_argument("--knn", type=int, default=10)
    ap.add_argument("--sources", default="8,32,128,512")
    ap.add_argument("--threads", default="",
                    help="comma list of host thread counts to time")
    ap.add_argument("--codes", type=int, default=0,
                    help="K of the fit_kmedoids timing (0: no fit)")
    ap.add_argument("--backends", default="host,device")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sources = [int(x) for x in args.sources.split(",")]
    results = []
    for W in _graphs(args, dev):
        rec = crossover_grid(W, sources, runs=args.runs, device=dev)
        if args.threads:
            rec["thread_scaling"] = thread_scaling(
                W, 8,
                [int(x) for x in args.threads.split(",")], runs=args.runs)
        if args.codes:
            rec["fit"] = fit_by_backend(W, args.codes,
                                        args.backends.split(","),
                                        runs=args.runs, device=dev)
        results.append(rec)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
