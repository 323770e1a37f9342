"""IVF (inverted-file) kNN: a pruned self-kNN search.

The port of ``vqvae_tpu/ops/ivf.py`` ``knn_search_ivf``, with its
signature, defaults and environment knobs (``VQVAE_TPU_KNN_MARGIN``,
``VQVAE_TPU_IVF_PROBE``, ``VQVAE_TPU_IVF_CENTROIDS``). The steps:

1. a coarse quantizer: ``lloyd_iters`` Lloyd iterations on a numpy
   ``default_rng(seed)`` sample, from centres drawn from it (the same
   draws as the JAX package);
2. each row's ``n_choice`` (4) nearest centroids, over blocks of 65,536
   rows, the lower index first among equal values (``lax.top_k``'s order);
3. a capacity-balanced assignment on the host (numpy, as JAX's);
4. a dense ``(C, cap)`` layout of ids (-1 pad) and coordinates: pad rows
   carry row 0's coordinates and are masked by id validity;
5. a probe table of ``P`` buckets per bucket, ranked by the members'
   votes and backfilled by centroid distance, itself first (numpy);
6. the search: each bucket's rows against the ``P * cap`` candidates of
   its probes, a fast-form top-``k_sel``, then an exact f32 re-rank to
   the top ``k``;
7. the scatter back to row order.

Each query examines ``P * cap`` candidates instead of N. Self-matches are
included and returned distances are exact f32 Euclidean distances. No
kernel: the JAX side is XLA (matmul, ``top_k``, ``segment_sum``), so
these are PyTorch calls. On the card the search takes several buckets per
batch (each bucket's tile is independent, where JAX scans one at a time).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .kmeans_euclidean import assign_fast_form, lloyd_update

# bytes of the (B, cap, P * cap) f32 distance tiles of one search batch;
# the int64 selection keys built from them take twice as much again
SEARCH_TILE_BYTES = 1 << 29


def _lloyd_sample(z: torch.Tensor, centers0: torch.Tensor, n_iter: int
                  ) -> torch.Tensor:
    """Plain Lloyd on a (S, D) sample; returns (C, D) centres."""
    z_sq = (z * z).sum(1)
    centers = centers0
    for _ in range(n_iter):
        labels, _ = assign_fast_form(z, z_sq, centers)
        centers = lloyd_update(z, labels, centers)
    return centers


def _ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as (x, position along the last axis): the f32
    bits mapped to a signed order, then the position in the low 32 bits."""
    bits = x.contiguous().view(torch.int32)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    pos = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return order.to(torch.int64) * (1 << 32) + pos


def topk_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` smallest entries along the last axis,
    ascending, the lower position first among equal values: the order of
    ``lax.top_k(-x, k)``, which ``torch.topk`` does not promise."""
    keys = torch.topk(_ordered_keys(x), k, dim=-1, largest=False).values
    return keys & 0xFFFFFFFF


def _assign_topc(z: torch.Tensor, centers: torch.Tensor, block: int,
                 n_choice: int) -> torch.Tensor:
    """Top-``n_choice`` nearest centroids per row, blocked over rows."""
    c_sq = (centers * centers).sum(1)
    out = []
    for s in range(0, z.shape[0], block):
        q = z[s:s + block]
        d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ centers.T) + c_sq[None, :]
        out.append(topk_smallest(d2, n_choice).to(torch.int32))
    return torch.cat(out)


def _balance_buckets(choices: np.ndarray, C: int, cap: int) -> np.ndarray:
    """Capacity-constrained assignment: each row takes its best-ranked
    centroid with free space; rows whose every candidate is full spill to
    the globally least-loaded bucket. Returns (N,) final labels."""
    n, n_choice = choices.shape
    counts = np.zeros(C, np.int64)
    labels = np.full(n, -1, np.int64)
    pending = np.arange(n)
    for c in range(n_choice):
        if pending.size == 0:
            break
        want = choices[pending, c]
        # process bucket-by-bucket: take up to the remaining capacity
        order = np.argsort(want, kind="stable")
        want_s = want[order]
        rows_s = pending[order]
        uniq, start = np.unique(want_s, return_index=True)
        end = np.append(start[1:], len(want_s))
        leftover = []
        for b, s, e in zip(uniq, start, end):
            room = cap - counts[b]
            take = min(room, e - s) if room > 0 else 0
            if take > 0:
                labels[rows_s[s:s + take]] = b
                counts[b] += take
            if take < e - s:
                leftover.append(rows_s[s + take:e])
        pending = (np.concatenate(leftover) if leftover
                   else np.empty(0, np.int64))
    for r in pending:  # all candidates full: least-loaded bucket
        b = int(np.argmin(counts))
        labels[r] = b
        counts[b] += 1
    return labels


def _bucket_ids(labels: np.ndarray, C: int, cap: int) -> np.ndarray:
    """(C, cap) int32 row ids of each bucket, in row order, -1 pad."""
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=C)
    bucket_ids = np.full((C, cap), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in range(C):
        bucket_ids[b, :counts[b]] = order[starts[b]:starts[b + 1]]
    return bucket_ids


def _probe_table(centers: np.ndarray, labels: np.ndarray,
                 choices: np.ndarray, P: int) -> np.ndarray:
    """(C, P) int32 buckets to probe for each bucket: itself first, then
    the buckets its members' top-``n_choice`` lists name most often
    (stable order among equal votes), backfilled by centroid distance."""
    C, n_choice = centers.shape[0], choices.shape[1]
    c_sq = (centers * centers).sum(1)
    cd = c_sq[:, None] - 2.0 * (centers @ centers.T) + c_sq[None, :]
    cd_order = np.argsort(cd, axis=1)
    votes = np.zeros((C, C), np.int64)
    flat_b = np.repeat(labels, n_choice)
    np.add.at(votes, (flat_b, choices.reshape(-1)), 1)
    probe = np.empty((C, P), np.int32)
    for g in range(C):
        ranked = np.argsort(-votes[g], kind="stable")
        ranked = ranked[votes[g][ranked] > 0]
        take = [g] + [int(b) for b in ranked if b != g][:P - 1]
        for b in cd_order[g]:  # backfill sparse vote rows
            if len(take) >= P:
                break
            if b not in take:
                take.append(int(b))
        probe[g] = take[:P]
    return probe


def _search_batch(bz: torch.Tensor, ids: torch.Tensor,
                  probe_tab: torch.Tensor, g: torch.Tensor, k: int,
                  k_sel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, cap, k) distances and ids for the buckets ``g``."""
    B = g.shape[0]
    _, cap, D = bz.shape
    P = probe_tab.shape[1]
    qv = ids[g] >= 0                                    # (B, cap)
    q = torch.where(qv[..., None], bz[g], 0.0)
    probes = probe_tab[g]                               # (B, P)
    cand_ids = ids[probes].reshape(B, P * cap)
    cvalid = cand_ids >= 0
    cz = torch.where(cvalid[..., None], bz[probes].reshape(B, P * cap, D),
                     0.0)
    d2 = ((q * q).sum(-1)[..., None] - 2.0 * torch.bmm(q, cz.transpose(1, 2))
          + (cz * cz).sum(-1)[:, None, :])
    d2 = torch.where(cvalid[:, None, :], d2, torch.inf)
    sel = topk_smallest(d2, k_sel)                      # (B, cap, k_sel)
    del d2
    # exact f32 re-rank of the selected candidates (the fast form cancels)
    pick = torch.gather(cand_ids[:, None, :].expand(B, cap, P * cap), 2, sel)
    cand = torch.gather(cz, 1, sel.reshape(B, cap * k_sel, 1).expand(
        B, cap * k_sel, D)).reshape(B, cap, k_sel, D)
    diff = q[:, :, None, :] - cand
    exact = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    exact = torch.where(pick >= 0, exact, torch.inf)
    order = topk_smallest(exact, k)
    best_d = torch.where(qv[..., None], torch.gather(exact, 2, order),
                         torch.inf)
    return best_d, torch.gather(pick, 2, order)


def _ivf_search(bz: torch.Tensor, ids: torch.Tensor,
                probe_tab: torch.Tensor, k: int, k_sel: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, cap, k) distances and ids, ``SEARCH_TILE_BYTES`` of distance
    tiles at a time."""
    C, cap, _ = bz.shape
    P = probe_tab.shape[1]
    per_bucket = cap * P * cap * 4
    batch = max(1, min(C, SEARCH_TILE_BYTES // per_bucket))
    outs_d, outs_i = [], []
    for s in range(0, C, batch):
        g = torch.arange(s, min(s + batch, C), device=bz.device)
        d, i = _search_batch(bz, ids, probe_tab, g, k, k_sel)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@contextlib.contextmanager
def _step(stats: Optional[Dict], name: str, dev: torch.device
          ) -> Iterator[None]:
    """Adds the block's seconds (to a device sync) to ``stats[name]``."""
    t0 = time.perf_counter()
    yield
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats[name] = stats.get(name, 0.0) + time.perf_counter() - t0


def knn_search_ivf(
    z: np.ndarray,
    k: int,
    n_centroids: Optional[int] = None,
    n_probe: Optional[int] = None,
    cap_factor: float = 1.25,
    train_sample: int = 131_072,
    lloyd_iters: int = 10,
    margin: int | None = None,
    seed: int = 0,
    device=None,
    stats: Optional[Dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Self-kNN via balanced IVF on ``device`` (default the GPU; raises
    when CUDA is absent and no device is given): (N, k) float32 exact
    Euclidean distances, ascending, and (N, k) int64 indices, self-matches
    included. ``n_centroids`` defaults to ~N/480 rounded to a power of
    two; ``n_probe`` (env ``VQVAE_TPU_IVF_PROBE``, default 16) trades
    recall for speed. ``stats``, when given, receives each step's seconds
    (``lloyd``, ``top4``, ``balance``, ``layout``, ``probe_table``,
    ``search``, ``scatter``) and the shape (``C``, ``P``, ``cap``,
    ``k_sel``)."""
    dev = resolve_device(device)
    if margin is None:
        margin = int(os.environ.get("VQVAE_TPU_KNN_MARGIN", 4))
    if n_probe is None:
        n_probe = int(os.environ.get("VQVAE_TPU_IVF_PROBE", 16))
    z = np.asarray(z, np.float32)
    n, d = z.shape
    if n_centroids is None:
        n_centroids = int(os.environ.get(
            "VQVAE_TPU_IVF_CENTROIDS",
            max(64, 1 << int(np.log2(max(n / 480, 64))))))
    C = min(n_centroids, max(8, n // 8))
    P = min(n_probe, C)
    cap = _round_up(int(np.ceil(n / C * cap_factor)), 8)
    k_eff = min(k, n)
    k_sel = min(k_eff + margin, P * cap)
    if stats is not None:
        stats.update(C=C, P=P, cap=cap, k_sel=k_sel)

    # 1. coarse quantizer on a sample
    with _step(stats, "lloyd", dev):
        rng = np.random.default_rng(seed)
        s = min(train_sample, n)
        sample = z[rng.choice(n, size=s, replace=False)] if s < n else z
        init = sample[rng.choice(s, size=C, replace=False)]
        centers = _lloyd_sample(torch.from_numpy(sample).to(dev),
                                torch.from_numpy(init).to(dev), lloyd_iters)

    # 2. top-4 candidate buckets per row (blocked), balanced on the host
    n_choice = min(4, C)
    block = 65536 if n >= 65536 else _round_up(n, 8)
    with _step(stats, "top4", dev):
        z_dev = torch.from_numpy(z).to(dev)
        choices = _assign_topc(z_dev, centers, block,
                               n_choice).cpu().numpy()
    with _step(stats, "balance", dev):
        labels = _balance_buckets(choices, C, cap)

    # 3. dense bucket layout (C, cap); pad rows carry row 0's coordinates
    with _step(stats, "layout", dev):
        bucket_ids = _bucket_ids(labels, C, cap)
        ids = torch.from_numpy(bucket_ids).to(dev)
        bz = z_dev[torch.clamp(ids, min=0).long()]

    # 4. probe table
    with _step(stats, "probe_table", dev):
        probe_tab = torch.from_numpy(
            _probe_table(centers.cpu().numpy(), labels, choices, P)).to(dev)

    # 5. bucket search
    with _step(stats, "search", dev):
        out_d, out_i = _ivf_search(bz, ids, probe_tab.long(), k_eff, k_sel)

    # 6. scatter back to row order
    with _step(stats, "scatter", dev):
        dists = np.empty((n, k_eff), np.float32)
        idxs = np.empty((n, k_eff), np.int64)
        od = out_d.reshape(C * cap, k_eff).cpu().numpy()
        oi = out_i.reshape(C * cap, k_eff).cpu().numpy()
        flat_ids = bucket_ids.reshape(C * cap)
        valid = flat_ids >= 0
        dists[flat_ids[valid]] = od[valid]
        idxs[flat_ids[valid]] = oi[valid]
    return dists, idxs
