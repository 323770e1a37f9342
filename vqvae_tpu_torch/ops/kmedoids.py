"""Graph-native geodesic K-medoids (device relaxation + native host Dijkstra).

The port of ``vqvae_tpu/ops/kmedoids.py``: k-means++ initialization over
graph distances, assignment from a multi-source shortest-path pass, and
the quantization error as the float64 sum of squared finite geodesic
distances. No N x N matrix is formed.

- ``kpp``: the reference's exact sequential scheme, one single-source pass
  per new center, d^2 sampling with the disconnection guards.
- ``kpp_parallel``: k-means||-style rounds, each sampling a block of
  centers jointly from the current d^2 distribution (Gumbel top-m without
  replacement) and relaxing from the whole block in one pass; the rounds'
  distances double as the final assignment. Sampling is numpy
  ``default_rng(seed)`` on the host, exactly as in the JAX package, so
  both draw the same medoids from the same distances.

Each distance pass picks its backend by work (``GraphHandle.choose``): the
native host Dijkstra for small work, the device ELL relaxation otherwise;
an ``EdgeList`` graph always relaxes on its device by edge-list
Bellman-Ford.

``mesh`` (``parallel.Mesh``) shards the device passes' K axis as JAX does:
``_warm_d0`` builds only the rank's columns, the relaxation runs on them,
and ``_round_update`` / ``assign_points_to_medoids`` reduce the per-row
minimum and its column over ranks (``all_reduce_min_argmin``: among equal
minima the lowest global column, as ``jnp.argmin``), so the round state
and the host sampling's ``d_min`` are the same on every rank, and every
rank draws the same sources from ``default_rng(seed)``. Decisions that
depend on the host (backend by work, the BFS relabel) are agreed over
ranks. An ``EdgeList`` graph is not sharded: its engine relaxes every
column on each rank (``GraphHandle.shard_mesh`` is None).
"""
from __future__ import annotations

import time
from typing import List, Tuple, Union

import numpy as np
import torch
from scipy import sparse

from ..device import resolve_device
from ..parallel.mesh import agree_any, all_reduce_min_argmin
from ..utils.profiling import span
from .backend import HOST_WORK_THRESHOLD, _native_ok, multi_source_distances
from .ell import BucketedGraph, source_columns
from .graph import bfs_node_order
from .shortest_paths import EdgeList

GraphLike = Union[sparse.spmatrix, BucketedGraph, EdgeList]

# one record per kpp_parallel fit: passes, per-pass seconds, host sampling
# seconds, device-graph build seconds, BFS reorder seconds
KMED_STATS: list = []


class GraphHandle:
    """Per-call backend dispatch with cached graph conversions.

    k-means++ rounds relax from a handful of sources (host Dijkstra wins)
    while a K-wide pass relaxes from all K (device wins), so the backend
    is chosen per call by its work, not once per fit."""

    def __init__(self, W, backend: str = "auto", device=None,
                 assume_symmetric: bool = False, mesh=None):
        self._forced = None if backend == "auto" else backend
        self.mesh = mesh
        self._csr = None
        self._bucketed = None
        self._edges = None
        self._assume_sym = assume_symmetric
        self._build_s = 0.0
        if isinstance(W, EdgeList):
            self._edges = W
            self.device = W.device
            self.n_nodes = W.n_nodes
            self.nnz = int(W.src.shape[0])
        elif isinstance(W, BucketedGraph):
            self._bucketed = W
            self.device = W.device
            self.n_nodes = W.n_nodes
            self.nnz = int(sum(int(b.numel()) for b in W.nbrs))
        elif sparse.issparse(W):
            self._csr = W.tocsr()
            self.device = resolve_device(device)
            self.n_nodes = W.shape[0]
            self.nnz = int(W.nnz)
        else:
            raise TypeError(f"unsupported graph type {type(W)}")

    def choose(self, k_sources: int) -> str:
        """Backend the next ``distances`` call with k_sources would pick."""
        if self._forced is not None:
            return self._forced
        work = float(self.nnz) * max(k_sources, 1)
        host_ok = self._csr is not None and _native_ok()
        device = not (work < HOST_WORK_THRESHOLD and host_ok)
        return "device" if agree_any(device, self.mesh) else "host"

    def distances(self, sources: np.ndarray, d0=None,
                  device_out: bool = False):
        """(N, K) distances; ``d0`` warm-starts the device relaxation (the
        host Dijkstra ignores it), ``device_out`` keeps a device tensor
        (under a sharding mesh, the rank's columns only)."""
        sources = np.asarray(sources)
        if self.choose(len(sources)) == "host":
            if self._csr is None:
                raise ValueError("host backend needs a scipy CSR graph")
            return multi_source_distances(self._csr, sources, "host")
        if self._edges is not None:
            return multi_source_distances(self._edges, sources, "device",
                                          d0=d0, device_out=device_out)
        self.ensure_device_graph()
        return multi_source_distances(self._bucketed, sources, "device",
                                      d0=d0, device_out=device_out,
                                      mesh=self.mesh)

    @property
    def shard_mesh(self):
        """The mesh whose ranks split a device pass's columns: none for an
        edge-list graph, which relaxes every column on each rank."""
        return None if self._edges is not None else self.mesh

    def ensure_device_graph(self) -> None:
        """Build the bucketed device graph now (otherwise built lazily in
        the first device ``distances`` call); an ``EdgeList`` is already
        on its device."""
        if self._bucketed is None and self._csr is not None:
            t0 = time.perf_counter()
            self._bucketed = BucketedGraph.from_csr(
                self._csr, assume_symmetric=self._assume_sym,
                device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._build_s = time.perf_counter() - t0


def _resolve(W, backend: str, device=None,
             mesh=None) -> Tuple[GraphHandle, int]:
    handle = (W if isinstance(W, GraphHandle)
              else GraphHandle(W, backend, device=device, mesh=mesh))
    if mesh is not None and handle.mesh is None:
        handle.mesh = mesh
    return handle, handle.n_nodes


def _safe_sq_probs(d_min: np.ndarray, centers: List[int]) -> np.ndarray:
    """d^2 sampling weights with the reference's inf/disconnection guards."""
    finite = np.isfinite(d_min)
    if finite.any():
        max_finite = float(d_min[finite].max())
        safe = np.where(finite, d_min, max_finite * 2.0)
    else:
        safe = np.ones_like(d_min)
    probs = safe.astype(np.float64) ** 2
    probs[np.asarray(centers, dtype=int)] = 0.0
    return probs


def kpp_initialization(W: GraphLike, K: int, seed: int = 42,
                       backend: str = "auto", device=None) -> List[int]:
    """Exact sequential graph k-means++ (reference semantics)."""
    graph, n = _resolve(W, backend, device)
    rng = np.random.default_rng(seed)
    centers = [int(rng.integers(0, n))]
    d_min = np.full(n, np.inf, dtype=np.float32)
    for _ in range(1, K):
        d_new = np.asarray(graph.distances(np.asarray([centers[-1]])))[:, 0]
        d_min = np.minimum(d_min, d_new)
        probs = _safe_sq_probs(d_min, centers)
        total = probs.sum()
        if total > 0:
            probs /= total
            centers.append(int(rng.choice(n, p=probs)))
        else:
            remaining = np.setdiff1d(np.arange(n), np.asarray(centers))
            if remaining.size == 0:
                break
            centers.append(int(rng.choice(remaining)))
    return centers


def _warm_d0(d_min: torch.Tensor, sources: torch.Tensor,
             mesh=None) -> torch.Tensor:
    """(N, K) upper bounds: every column starts at the running
    nearest-center distance, each source's own column at 0. Under a
    sharding mesh only this rank's columns (``source_columns``)."""
    c0, c1 = source_columns(int(sources.shape[0]), mesh)
    sources = sources[c0:c1]
    k = sources.shape[0]
    d0 = d_min[:, None].expand(d_min.shape[0], k).clone()
    d0[sources, torch.arange(k, device=d0.device)] = 0.0
    return d0


def _min_argmin(d: torch.Tensor, k: int, mesh=None):
    """Per-row minimum over the K columns and its global column (ties to
    the first column, as ``jnp.argmin``); ``d`` holds this rank's columns
    ``source_columns(k, mesh)``."""
    c0, _ = source_columns(k, mesh)
    best = torch.amin(d, dim=1)
    col = torch.argmin(d, dim=1) + c0
    return all_reduce_min_argmin(best, col, mesh)


def _round_update(d_new, d_min, assign, round_ids, mesh=None):
    """Running min and argmin over a round's columns."""
    best, col = _min_argmin(d_new, int(round_ids.shape[0]), mesh)
    assign = torch.where(best < d_min, round_ids[col], assign)
    return torch.minimum(d_min, best), assign


def _pick_schedule(K: int, width: int, schedule: str) -> List[int]:
    """Per-round pick counts summing to K-1, each <= width: ``flat``
    width-sized blocks, ``ramp`` doubling 1, 2, 4, ... capped at width."""
    rem, sizes = K - 1, []
    b = 1 if schedule == "ramp" else width
    while rem > 0:
        m = min(b, width, rem)
        sizes.append(m)
        rem -= m
        if schedule == "ramp":
            b *= 2
    return sizes


def kpp_parallel_initialization(W: GraphLike, K: int, seed: int = 42,
                                rounds: int = 4, backend: str = "auto",
                                return_assignment: bool = False,
                                schedule: str = "flat", device=None,
                                mesh=None):
    """Batched k-means|| initialization: R multi-source passes in all.

    With ``return_assignment`` the rounds' passes double as the final
    assignment (every center is relaxed exactly once), returning
    (centers, assign, dist). On the device path each round warm-starts
    from the running nearest-center distances (exact: the warm fixed point
    is min(dist(s, v), d_min(v))) and the round state stays on the device;
    only d_min comes back per round for the host sampling. ``mesh``
    shards each device pass's columns (see the module notes).
    """
    graph, n = _resolve(W, backend, device, mesh)
    mesh = graph.shard_mesh
    rng = np.random.default_rng(seed)
    first = int(rng.integers(0, n))
    centers: List[int] = [first]
    d_min = np.full(n, np.inf, dtype=np.float32)
    assign = np.zeros(n, dtype=np.int64)
    rounds = max(1, min(rounds, K - 1)) if K > 1 else 0
    if rounds == 0:
        if return_assignment:
            d0 = (np.asarray(graph.distances(np.asarray([first])))[:, 0]
                  if n else d_min)
            return centers, assign, d0
        return centers

    # every round relaxes the same number of sources; short rounds are
    # padded with an existing center, whose column can never strictly
    # improve d_min and is inert for the min and argmin updates
    per_round = int(np.ceil((K - 1) / rounds))
    sizes = _pick_schedule(K, per_round, schedule)
    use_device = graph.choose(per_round) == "device"
    stats = {"n": int(n), "K": int(K), "passes": 0, "pass_seconds": [],
             "sample_seconds": 0.0}
    if use_device:
        dev = graph.device
        graph.ensure_device_graph()
        stats["device_graph_seconds"] = graph._build_s
        d_min_dev = torch.full((n,), float("inf"), dtype=torch.float32,
                               device=dev)
        assign_dev = torch.zeros((n,), dtype=torch.int64, device=dev)

    new_centers = [first] * per_round
    round_ids = np.zeros(per_round, dtype=np.int64)
    r = 0
    while True:
        with span("vqvae.kmedoids.pass", stats["pass_seconds"]):
            srcs = np.asarray(new_centers, np.int64)
            if use_device:
                d0 = _warm_d0(d_min_dev, torch.from_numpy(srcs).to(dev),
                              mesh)
                d_new = graph.distances(srcs, d0=d0, device_out=True)
                d_min_dev, assign_dev = _round_update(
                    d_new, d_min_dev, assign_dev,
                    torch.from_numpy(round_ids).to(dev), mesh)
                d_min = d_min_dev.cpu().numpy()  # sync: the pass ends here
            else:
                d_new = graph.distances(srcs)
                best = d_new.min(axis=1)
                improved = best < d_min
                if return_assignment:
                    assign = np.where(improved,
                                      round_ids[d_new.argmin(axis=1)], assign)
                d_min = np.minimum(d_min, best)
        stats["passes"] += 1
        if r >= len(sizes) or len(centers) >= K:
            break
        m = min(sizes[r], K - len(centers))
        r += 1
        with span("vqvae.kmedoids.sample", stats, "sample_seconds"):
            probs = _safe_sq_probs(d_min, centers)
            if probs.sum() <= 0:
                pool = np.setdiff1d(np.arange(n), np.asarray(centers))
                picks = rng.choice(pool, size=min(m, pool.size),
                                   replace=False)
            else:
                # Gumbel top-m: m distinct samples ~ probs without
                # replacement
                logp = np.full(n, -np.inf)
                nz = probs > 0
                logp[nz] = np.log(probs[nz])
                gumbel = rng.gumbel(size=n)
                picks = np.argsort(-(logp + gumbel))[:m]
                picks = picks[np.isfinite(logp[picks])]
            real = [int(p) for p in picks]
            n_pad = per_round - len(real)
            new_centers = real + [centers[0]] * n_pad
            round_ids = np.concatenate([
                len(centers) + np.arange(len(real), dtype=np.int64),
                np.zeros(n_pad, dtype=np.int64)])
            centers.extend(real)

    KMED_STATS.append(stats)
    centers = centers[:K]
    if use_device:
        assign = assign_dev.cpu().numpy()
    if return_assignment:
        return centers, assign, d_min
    return centers


def assign_points_to_medoids(W: GraphLike, medoids: np.ndarray,
                             backend: str = "auto", device=None, mesh=None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """One multi-source pass; returns (assign (N,), dist_to_assigned (N,)).
    A device pass reduces its minimum and column on the device (over the
    ranks of a sharding mesh)."""
    medoids = np.asarray(medoids, np.int64)
    graph, _ = _resolve(W, backend, device, mesh)
    if graph.choose(len(medoids)) == "device":
        d = graph.distances(medoids, device_out=True)
        dist, assign = _min_argmin(d, len(medoids), graph.shard_mesh)
        return assign.cpu().numpy().astype(np.int64), dist.cpu().numpy()
    d = np.asarray(graph.distances(medoids))  # (N, K)
    assign = d.argmin(axis=1)
    return assign.astype(np.int64), d[np.arange(d.shape[0]), assign]


def compute_quantization_error(dist_to_assigned: np.ndarray) -> float:
    """Sum of squared finite geodesic distances, in float64."""
    finite = np.isfinite(dist_to_assigned)
    if finite.any():
        return float(np.sum(dist_to_assigned[finite].astype(np.float64) ** 2))
    return float("inf")


def fit_kmedoids(W: GraphLike, K: int = 512, init: str = "kpp",
                 seed: int = 42, kpp_rounds: int = 4,
                 kpp_schedule: str = "flat", backend: str = "auto",
                 reorder: bool = True, device=None,
                 assume_symmetric: bool = False, mesh=None
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Graph K-medoids: init + one-shot assignment + QE (no Lloyd
    refinement, as the reference).

    ``init``: "kpp", "kpp_parallel" or "random". ``reorder``: BFS-relabel
    the graph before the passes when ``nnz * K >= HOST_WORK_THRESHOLD``
    (sweep-count reduction); results map back to the original node ids.
    The threshold scales with the host's cores, and the node order changes
    which nodes the sampling picks, so parity runs pin ``reorder`` and
    ``backend``. ``mesh`` shards the device passes (see the module notes);
    every rank returns the same result.
    """
    perm = None
    reorder_s = 0.0
    if (reorder and sparse.issparse(W) and agree_any(
            float(W.nnz) * max(K, 1) >= HOST_WORK_THRESHOLD, mesh)):
        t0 = time.perf_counter()
        perm = bfs_node_order(W)
        W = W.tocsr()[perm][:, perm]
        reorder_s = time.perf_counter() - t0
    if sparse.issparse(W):  # symmetry survives the BFS permutation
        W = GraphHandle(W, backend, device=device,
                        assume_symmetric=assume_symmetric, mesh=mesh)
    graph, n = _resolve(W, backend, device, mesh)
    assign = dist = None
    if init == "kpp":
        medoids = np.asarray(kpp_initialization(graph, K, seed=seed),
                             dtype=np.int64)
    elif init == "kpp_parallel":
        n_stats = len(KMED_STATS)
        medoids, assign, dist = kpp_parallel_initialization(
            graph, K, seed=seed, rounds=kpp_rounds,
            return_assignment=True, schedule=kpp_schedule)
        medoids = np.asarray(medoids, dtype=np.int64)
        if len(KMED_STATS) > n_stats:
            KMED_STATS[-1]["reorder_seconds"] = reorder_s
    elif init == "random":
        rng = np.random.default_rng(seed)
        medoids = rng.choice(n, size=min(K, n), replace=False).astype(np.int64)
    else:
        raise ValueError("init must be 'kpp', 'kpp_parallel' or 'random'")
    if assign is None:
        assign, dist = assign_points_to_medoids(graph, medoids)
    qe = compute_quantization_error(dist)
    if perm is not None:  # map back to original node ids
        medoids = perm[medoids]
        assign_orig = np.empty_like(assign)
        assign_orig[perm] = assign
        assign = assign_orig
    return medoids, assign, qe


def fit_kmedoids_with_connectivity_check(
    W, K: int = 512, init: str = "kpp", seed: int = 42, device=None
) -> Tuple[np.ndarray, np.ndarray, float, dict]:
    """``fit_kmedoids`` with the reference's connectivity metadata: node,
    edge and component counts, the largest component's size, the medoid
    count, the QE and the method (the JAX package's name for it)."""
    from scipy.sparse.csgraph import connected_components

    n = W.shape[0]
    n_components, labels = connected_components(W, directed=False)
    metadata = {
        "n_nodes": int(n),
        "n_edges": int(W.nnz),
        "n_components": int(n_components),
        "largest_component_size": int(np.bincount(labels).max()) if n else 0,
    }
    medoids, assign, qe = fit_kmedoids(W, K=K, init=init, seed=seed,
                                       device=device)
    metadata.update({
        "n_medoids": len(medoids),
        "quantization_error": qe,
        "method": "tpu_kmedoids",
    })
    return medoids, assign, qe, metadata
