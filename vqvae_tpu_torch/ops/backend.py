"""Shortest-path backend dispatch: device relaxation vs native host Dijkstra.

The port of ``vqvae_tpu/ops/backend.py``. Two backends, identical
distances:

- ``device``: the bucketed Gauss-Seidel relaxation (``ops/ell.py``) on the
  GPU — wins at scale (large E x K) — or, for an ``EdgeList``, the
  edge-list Bellman-Ford (``ops/shortest_paths.py``);
- ``host``: the native C++ threaded binary-heap Dijkstra
  (``vqvae_tpu_torch.native``) — wins on small graphs.

``auto`` picks by estimated work (K * E) against ``HOST_WORK_THRESHOLD``.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse

from .. import native
from ..device import resolve_device
from ..native import _host_threads
from ..parallel.mesh import all_gather_rows
from .ell import (BucketedGraph, multi_source_shortest_paths_ell,
                  source_columns)
from .shortest_paths import EdgeList, multi_source_shortest_paths


# below this K*E work estimate (sources x stored edges) the threaded host
# Dijkstra is taken over the device relaxation. Measured with
# ``tools/bench_fit`` on an NVIDIA H100 80GB HBM3 at 700.00 W whose host
# exposes 8 threads (clustered-latent kNN graphs, k = 10 union, 1 to 512
# sources; the device graph built once, as k-medoids reuses it): the
# device's relaxation overtakes the host at 8.9e4 work on 1,024 nodes
# (15 k edges), 4.6e6 on 4,096 and 2.1e6 on 16,384 nodes (0.26 M edges),
# and wins from a single source on 65,536 and 262,144 nodes (1.0 M and
# 4.2 M edges); 8 threads took 1/4 to 1/12 of one thread's time from 8
# sources (16,384 to 262,144 nodes). So 2.5e5 a thread (2e6 on that host) sits in the measured
# band and scales with the cores this host exposes. A lone call from a
# CSR matrix also builds the device graph (0.05 s at 1.0 M edges, 0.25 s
# at 4.2 M), where the host keeps winning up to 22-85 sources.
HOST_WORK_THRESHOLD = 2.5e5 * _host_threads()


def _native_ok() -> bool:
    return native.available()


def multi_source_distances(W_or_graph, sources: np.ndarray,
                           backend: str = "auto", d0=None,
                           device_out: bool = False, device=None,
                           mesh=None):
    """(N, K) float32 distances from each of K sources to all nodes.

    ``W_or_graph``: a scipy sparse matrix, a ``BucketedGraph`` or an
    ``EdgeList``.
    ``d0``: per-entry upper bounds warm-starting the device relaxation
    (the host Dijkstra, exact from scratch, ignores it). ``device_out``
    returns the device tensor instead of numpy. ``device`` places the
    bucketed graph built from a CSR input. ``mesh`` shards the bucketed
    relaxation's K axis: with ``device_out`` each rank gets its columns
    (``ell.source_columns``), else the columns are gathered (every rank
    returns all K). The host Dijkstra and the edge-list engine run whole
    on every rank.
    """
    sources = np.asarray(sources)
    is_csr = sparse.issparse(W_or_graph)
    if backend == "auto":
        if is_csr:
            work = float(W_or_graph.nnz) * len(sources)
            backend = ("host" if work < HOST_WORK_THRESHOLD and _native_ok()
                       else "device")
        else:
            backend = "device"
    if backend == "host":
        if not is_csr:
            raise ValueError("host backend needs a scipy CSR graph")
        return native.dijkstra_multi_source(
            W_or_graph, sources.astype(np.int32)).T.copy()
    if backend != "device":
        raise ValueError(f"unknown backend {backend!r}")
    if isinstance(W_or_graph, EdgeList):
        d = multi_source_shortest_paths(W_or_graph, sources, d0=d0)
    else:
        graph = (W_or_graph if isinstance(W_or_graph, BucketedGraph)
                 else BucketedGraph.from_csr(W_or_graph,
                                             device=resolve_device(device)))
        d = multi_source_shortest_paths_ell(graph, sources, d0=d0,
                                            mesh=mesh)
        c0, c1 = source_columns(len(sources), mesh)
        if not device_out and c1 - c0 < len(sources):
            d = all_gather_rows(d.T.contiguous(), len(sources), mesh).T
    return d if device_out else d.cpu().numpy()
