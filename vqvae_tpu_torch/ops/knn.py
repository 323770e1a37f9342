"""All-pairs kNN: tiled distance selection + one exact f32 re-rank.

The port of ``vqvae_tpu/ops/knn.py``. Two selection routes end in the same
exact re-rank (``_exact_rerank``):

- ``"fused"`` (the JAX ``"pallas"`` route, the default for approximate
  requests): ``ops/knn_select.fused_select`` — kernels K1/K2 on the GPU —
  picks ``k + margin`` candidates per query from binned top-2
  accumulators, without the distance matrix ever reaching memory.
- ``"exact"`` (the JAX ``"xla"`` route): per (query tile, db tile) squared
  distances and an exact per-tile top-(k + margin), stacked across tiles.

Above ``device_max`` rows (Euclidean only) the search runs the native
exact kNN on the host (``native.knn_exact``), as the JAX package's
escape hatch does.

``mesh`` (``parallel.Mesh``) shards the query axis as JAX's ``shard_map``
does: each rank selects and re-ranks its contiguous block of every query
block (``block // world_size`` rows) against the whole database, and the
(N, k) results are all-gathered in row order. Per-row work does not depend
on the block, so the result equals the unsharded one bit for bit. JAX
derives its effective selection parameters from ``block // world_size``;
here they depend on the database tile alone (the port has no ``sel_tile``),
so every world size runs the same kernel, K1 or K2.

Self-matches are included (graph assembly strips them). Euclidean
distances are returned as true distances, cosine as ``1 - similarity`` on
normalized vectors.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..parallel.mesh import all_gather_rows
from .knn_select import CAND_LANES, dot_last, fused_select

# last effective kNN configuration, recorded by knn_search for provenance
KNN_EFFECTIVE: dict = {}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dot_last_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``dot_last`` in numpy: the same f32 rounding of each step."""
    out = np.zeros(a.shape[:-1], np.float64)
    for j in range(a.shape[-1]):
        out = (out + a[..., j].astype(np.float64) * b[..., j]).astype(
            np.float32).astype(np.float64)
    return out.astype(np.float32)


def _exact_distances(q, all_i, z, metric: str) -> torch.Tensor:
    """(T, C) exact f32 distances from query rows ``q`` to rows ``all_i``
    of ``z``. On the CPU in numpy, single-threaded: a run of the CPU parity
    tests once returned the last third of a 400-row block with distances
    off by up to 3e-4 relative (the chunk of a three-way split of the
    (T, C, D) tensors among torch's intra-op threads), so the host path
    keeps these few operations out of that pool."""
    if q.device.type != "cpu":
        cand = z[all_i.long()]                          # (T, C, D)
        if metric == "euclidean":
            diff = q[:, None, :] - cand
            return torch.sqrt(torch.clamp_min(dot_last(diff, diff), 0.0))
        return 1.0 - dot_last(q[:, None, :].expand_as(cand), cand)
    qn, cand = q.numpy(), z.numpy()[all_i.numpy()]
    if metric == "euclidean":
        diff = qn[:, None, :] - cand
        exact = np.sqrt(np.maximum(_dot_last_np(diff, diff), 0.0))
    else:
        exact = 1.0 - _dot_last_np(np.broadcast_to(qn[:, None, :],
                                                   cand.shape), cand)
    return torch.from_numpy(np.ascontiguousarray(exact, np.float32))


def _exact_rerank(q, qv, all_d, all_i, z, k: int, metric: str):
    """Exact f32 re-rank of stacked candidates (T, C) for query rows ``q``.

    Non-finite ``all_d`` entries mark unfilled / padded candidates and are
    excluded; returned distances are exact for the returned indices, ties
    to the earlier candidate column (as ``lax.top_k``)."""
    exact = _exact_distances(q, all_i, z, metric)
    exact = torch.where(torch.isfinite(all_d), exact, float("inf"))
    vals, sel = torch.sort(exact, dim=1, stable=True)
    best_d = torch.where(qv[:, None], vals[:, :k], float("inf"))
    best_i = torch.gather(all_i, 1, sel[:, :k])
    return best_d, best_i


def _knn_block_exact(zq, z, n_valid: int, q_valid, *, k: int, metric: str,
                     query_tile: int, db_tile: int, margin: int):
    """Exact route: per-tile top-(k + margin) candidates, stacked over db
    tiles, then the exact re-rank per query tile."""
    qp, np_ = zq.shape[0], z.shape[0]
    k_sel = min(k + margin, db_tile)
    db_sq = dot_last(z, z)
    row_valid = torch.arange(np_, device=z.device) < n_valid
    dists, idxs = [], []
    for qs in range(0, qp, query_tile):
        q = zq[qs:qs + query_tile]
        q_sq = dot_last(q, q)
        cand_d, cand_i = [], []
        for start in range(0, np_, db_tile):
            x = z[start:start + db_tile]
            dots = q @ x.T
            if metric == "cosine":
                d = 1.0 - dots
            else:
                d = q_sq[:, None] - 2.0 * dots + db_sq[None, start:start + db_tile]
            d = torch.where(row_valid[None, start:start + db_tile], d,
                            float("inf"))
            # a stable sort, not torch.topk: equal distances (duplicate
            # points) must keep the lower row first, as lax.top_k does
            vals, j = torch.sort(d, dim=1, stable=True)
            cand_d.append(vals[:, :k_sel])
            cand_i.append((j[:, :k_sel] + start).to(torch.int32))
        d_t, i_t = _exact_rerank(q, q_valid[qs:qs + query_tile],
                                 torch.cat(cand_d, 1), torch.cat(cand_i, 1),
                                 z, k, metric)
        dists.append(d_t)
        idxs.append(i_t)
    return torch.cat(dists), torch.cat(idxs)


def effective_select_params(db_tile: int, bins: int, packed: bool):
    """The (bins, packed) the fused selection ACTUALLY uses for a db tile —
    bins halve until they divide the tile, and packed keys need
    power-of-two bins (``vqvae_tpu/ops/knn.py`` ``effective_pallas_params``;
    the TPU's sel_tile has no counterpart here)."""
    bins = min(bins, db_tile)
    while bins > 8 and db_tile % bins:  # bins must divide the db tile
        bins //= 2
    if packed and (bins & (bins - 1)):
        warnings.warn(
            f"packed kNN selection disabled: effective bins={bins} is not a "
            f"power of two (db_tile={db_tile}); running the unpacked kernel")
        packed = False
    return bins, packed


def resolve_knn_kernel(approx: bool, kernel: str | None = None) -> str:
    """``kernel`` if given, else ``"fused"`` for approximate requests and
    ``"exact"`` otherwise (on every device: on the CPU the fused route runs
    the selection's plain version)."""
    if kernel is None:
        kernel = "fused" if approx else "exact"
    if kernel not in ("exact", "fused"):
        raise ValueError(f"unknown kNN kernel {kernel!r}")
    return kernel


def knn_search(
    z: np.ndarray,
    k: int,
    metric: str = "euclidean",
    query_tile: int = 1024,
    db_tile: int | None = None,
    query_block: int = 131_072,
    approx: bool = False,
    margin: int | None = None,
    kernel: str | None = None,
    bins: int = 1024,
    packed: bool = True,
    device: str | torch.device | None = None,
    device_max: int = 4_000_000,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs kNN of the rows of ``z`` (N, D): (distances, indices),
    each (N, k) numpy, ``k`` capped at N, self-matches included.

    ``margin`` (default 8 fused / 4 exact): candidates kept beyond ``k``
    before the exact re-rank. ``db_tile`` (default 8192 fused / 32768
    exact) is clamped to ``[128, round_up(N, 128)]``; for the fused route
    the effective ``bins`` halve until they divide it, so small N (e.g.
    N=300 -> db_tile 384 -> bins 384) runs the unpacked kernel K2.
    ``query_block`` rows go to one ``fused_select`` call. Above
    ``device_max`` rows a Euclidean search runs the native exact kNN on
    the host instead (threaded, distances in its own summation order).
    ``mesh``: shard the query axis over the process group's ranks (every
    rank returns the whole result).
    """
    kernel = resolve_knn_kernel(approx, kernel)
    dev = resolve_device(device)
    if margin is None:
        margin = 8 if kernel == "fused" else 4
    if db_tile is None:
        db_tile = 8192 if kernel == "fused" else 32768
    z = np.asarray(z, dtype=np.float32)
    if z.ndim != 2:
        raise ValueError("z must be (N, D)")
    n = z.shape[0]
    if n == 0 or k <= 0:
        return np.empty((n, 0), np.float32), np.empty((n, 0), np.int64)
    k = min(k, n)
    if n > device_max and metric == "euclidean":
        KNN_EFFECTIVE.update(kernel="native", bins=None, packed=False,
                             db_tile=None)
        return native.knn_exact(z, k)

    query_tile = max(8, min(query_tile, _round_up(n, 8)))
    db_tile = max(128, min(db_tile, _round_up(n, 128)))
    if metric == "cosine":
        zn = z / (np.linalg.norm(z, axis=1, keepdims=True) + 1e-8)
    elif metric == "euclidean":
        zn = z
    else:
        raise ValueError(f"unknown metric {metric!r}")
    n_db_pad = _round_up(n, db_tile)
    z_db = torch.zeros((n_db_pad, z.shape[1]), dtype=torch.float32,
                       device=dev)
    z_db[:n] = torch.from_numpy(np.ascontiguousarray(zn)).to(dev)
    n_shards = 1 if mesh is None else mesh.world_size
    block_align = query_tile * n_shards
    block = min(_round_up(n, block_align), _round_up(query_block, block_align))
    local = block // n_shards  # query rows of one rank in one block

    if kernel == "fused":
        bins, packed = effective_select_params(db_tile, bins, packed)
        k_sel = min(k + margin, CAND_LANES)
        KNN_EFFECTIVE.update(kernel=kernel, bins=bins, packed=packed,
                             db_tile=db_tile)
    else:
        KNN_EFFECTIVE.update(kernel=kernel, bins=None, packed=False,
                             db_tile=db_tile)

    dists = np.empty((n, k), np.float32)
    idxs = np.empty((n, k), np.int64)
    rank = 0 if mesh is None else mesh.rank
    for s in range(0, n, block):
        e = min(s + block, n)
        qs = min(s + rank * local, e)  # this rank's rows of the block
        qe = min(qs + local, e)
        q = torch.zeros((local, z.shape[1]), dtype=torch.float32, device=dev)
        q[:qe - qs] = z_db[qs:qe]
        qv = torch.arange(local, device=dev) < (qe - qs)
        if kernel == "fused":
            cand_d, cand_i = fused_select(q, z_db, n, metric=metric,
                                          bins=bins, k_sel=k_sel,
                                          packed=packed)
            d, i = _exact_rerank(q, qv, cand_d, cand_i, z_db, k, metric)
        else:
            d, i = _knn_block_exact(q, z_db, n, qv, k=k, metric=metric,
                                    query_tile=query_tile, db_tile=db_tile,
                                    margin=margin)
        d = all_gather_rows(d, block, mesh)
        i = all_gather_rows(i, block, mesh)
        dists[s:e] = d[:e - s].cpu().numpy()
        idxs[s:e] = i[:e - s].cpu().numpy().astype(np.int64)
    return dists, idxs
