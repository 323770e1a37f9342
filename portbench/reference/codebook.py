"""Plain PyTorch reference of the spatial geodesic codebook stage, in
float32 on the run's device.

Written from the stage's description:

- the approximate kNN the configuration runs (``graph.method`` approx,
  the stage's fused selection with its defaults): per query, selection
  values |q|^2 + |x|^2 - 2 q.x to every row; each slot ``row mod bins``
  keeps its two smallest; the ``k_sel`` smallest of those ``2 bins``
  entries are the candidates, re-ranked by exact distance; the list is the
  nearest ``k + 1`` (the node itself among them, then dropped). Beside
  each list it keeps what decides it (each bin's third value, the first
  candidate left out, the first re-ranked row left out), so that a
  comparison can tell a near-tie from a lost neighbour;
- the union graph: an undirected edge wherever either end lists the other;
- each edge's Riemannian length 0.5 (|J(z_i) dz| + |J(z_j) dz|), dz =
  z_j - z_i, J the Jacobian of z -> sigmoid(decoder(z)) with z decoded as
  a 1x1 latent grid (evaluation mode: the norms' running statistics), by
  ``torch.func.jvp``;
- connected components by label propagation, the largest one's nodes;
- shortest-path distances by Bellman-Ford over the edge list (a node's
  distance the minimum over its in-edges of the tail's distance plus the
  length), from many sources at once, and each node's nearest source;
- the medoids by k-means|| rounds (``kpp_parallel``) over those distances
  in breadth-first node order: the first center drawn uniformly, then each
  round's block drawn jointly from the d^2 distribution by Gumbel top-m,
  with numpy's ``default_rng(seed)``, as the stage states its sampling.

It imports nothing of the program.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import vae as ref_vae

# the stage's approximate selection (its fused route's defaults): database
# tiles of DB_TILE rows, BINS slots, MARGIN candidates past the list, at
# most LANES candidates
DB_TILE, BINS, MARGIN, LANES = 8192, 1024, 8, 128
# two implementations of one selection value differ by rounding: the
# packed selection keeps 15 of its mantissa bits (relative 2**-15), and
# the expanded product rounds on the scale of |q|^2 + |x|^2
TAU_REL, TAU_ABS = 2.0 ** -14, 2.0 ** -18
# a decision is a near-tie where the values it compares lie within TIES
# tolerances of each other
TIES = 4.0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def select_params(n: int, k_list: int) -> Tuple[int, int, int]:
    """(bins, k_sel, padded rows) of the selection over ``n`` rows: the
    tile is clamped to [128, n rounded up to 128] and the bins halve until
    they divide it."""
    tile = max(128, min(DB_TILE, _round_up(n, 128)))
    bins = min(BINS, tile)
    while bins > 8 and tile % bins:
        bins //= 2
    return bins, min(k_list + MARGIN, LANES), _round_up(n, tile)


def approx_knn(z: torch.Tensor, k_list: int, block: int = 1024) -> Dict:
    """The selection's lists of every row of ``z`` (the matmul in the
    precision the caller sets): ``ids`` (N, k_list) nearest first, the row
    itself among them; ``fragile`` (N, k_list), entries a near-tie could
    drop; ``sel_last`` and ``fin_last`` (N,), the last candidate's
    selection value and the last entry's exact squared distance; ``sq``
    and ``sq_max``, the rows' squared norms."""
    n, dev = z.shape[0], z.device
    bins, k_sel, n_pad = select_params(n, k_list)
    blocks = n_pad // bins
    k_sel = min(k_sel, 2 * bins if blocks > 1 else bins)
    sq = (z * z).sum(1)
    sq_max = float(sq.max())
    inf = float("inf")
    ids = torch.empty((n, k_list), dtype=torch.long, device=dev)
    fragile = torch.empty((n, k_list), dtype=torch.bool, device=dev)
    sel_last = torch.empty(n, device=dev)
    fin_last = torch.empty(n, device=dev)
    slots = torch.arange(bins, device=dev)
    for s in range(0, n, block):
        q = z[s:s + block]
        b = q.shape[0]
        sv = torch.full((b, n_pad), inf, device=dev)
        sv[:, :n] = sq[s:s + block, None] + sq[None, :] - 2.0 * (q @ z.T)
        top = min(3, blocks)
        v3, blk = torch.topk(sv.view(b, blocks, bins), top, dim=1,
                             largest=False, sorted=True)
        if top < 3:
            v3 = torch.cat([v3, v3.new_full((b, 3 - top, bins), inf)], 1)
            blk = torch.cat([blk, blk.new_zeros((b, 3 - top, bins))], 1)
        keep = min(2, blocks)
        acc = v3[:, :keep].reshape(b, keep * bins)
        acc_row = (blk[:, :keep] * bins + slots).reshape(b, keep * bins)
        av, aj = torch.topk(acc, min(k_sel + 1, acc.shape[1]), dim=1,
                            largest=False, sorted=True)
        a_next = (av[:, k_sel] if av.shape[1] > k_sel
                  else torch.full((b,), inf, device=dev))
        cand = acc_row.gather(1, aj[:, :k_sel]).clamp_max(n - 1)
        valid = torch.isfinite(av[:, :k_sel])
        diff = q[:, None, :] - z[cand]
        ex = torch.where(valid, (diff * diff).sum(-1), inf)
        ev, ej = torch.sort(ex, dim=1, stable=True)
        e_next = (ev[:, k_list] if k_sel > k_list
                  else torch.full((b,), inf, device=dev))
        lst = cand.gather(1, ej[:, :k_list])
        ls = sv.gather(1, lst)
        le = ev[:, :k_list]
        tol_q = TAU_ABS * (sq[s:s + block] + sq_max)[:, None]
        near = lambda x, y: y - x <= TIES * (TAU_REL * x.abs() + tol_q)  # noqa: E731
        t3 = v3[:, 2].gather(1, lst % bins)
        fragile[s:s + block] = (near(ls, t3) | near(ls, a_next[:, None])
                                | near(le, e_next[:, None]))
        ids[s:s + block] = lst
        sel_last[s:s + block] = av[:, k_sel - 1]
        fin_last[s:s + block] = le[:, -1]
    return {"ids": ids, "fragile": fragile, "sel_last": sel_last,
            "fin_last": fin_last, "sq": sq, "sq_max": sq_max, "bins": bins,
            "n_pad": n_pad}


def could_list(z: torch.Tensor, sel: Dict, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """(P,) whether a near-tie could put row ``v`` on row ``u``'s list
    (pairs the reference's lists leave out): ``v`` within ties of the
    second value of its bin, of the last candidate and of the last
    entry."""
    if u.numel() == 0:
        return torch.zeros(0, dtype=torch.bool, device=z.device)
    n, bins, sq = z.shape[0], sel["bins"], sel["sq"]
    blocks = sel["n_pad"] // bins
    rows = (v % bins)[:, None] + bins * torch.arange(blocks, device=z.device)
    ok = rows < n
    rows = rows.clamp_max(n - 1)
    vals = sq[u, None] + sq[rows] - 2.0 * (z[u, None, :] * z[rows]).sum(-1)
    vals = torch.where(ok, vals, float("inf"))
    second = (torch.topk(vals, 2, dim=1, largest=False).values[:, 1]
              if blocks > 1 else torch.full_like(vals[:, 0], float("inf")))
    s_uv = sq[u] + sq[v] - 2.0 * (z[u] * z[v]).sum(-1)
    e_uv = ((z[u] - z[v]) ** 2).sum(-1)
    tol = lambda x: TIES * (TAU_REL * x.abs()  # noqa: E731
                            + TAU_ABS * (sq[u] + sel["sq_max"]))
    return ((s_uv <= second + tol(s_uv))
            & (s_uv <= sel["sel_last"][u] + tol(s_uv))
            & (e_uv <= sel["fin_last"][u] + tol(e_uv)))


def drop_self(ids: torch.Tensor, extra: torch.Tensor) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """The lists (and a per-entry companion) without each row itself (or,
    where a twin ranks first and the row is absent, without the first)."""
    n, k = ids.shape
    me = ids == torch.arange(n, device=ids.device)[:, None]
    absent = ~me.any(1)
    me[absent, 0] = True
    me &= torch.cumsum(me.int(), 1) == 1
    keep = ~me
    return ids[keep].view(n, k - 1), extra[keep].view(n, k - 1)


def union_edges(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique undirected edges (rows < cols) of the kNN lists."""
    n, k = nbr.shape
    a = torch.arange(n, device=nbr.device).repeat_interleave(k)
    b = nbr.reshape(-1)
    key = torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b))
    return key // n, key % n


def decode_image(sd: Dict, cfg: Dict):
    """z (B, latent) -> sigmoid(decoder(z as a 1x1 grid)) as (B, pixels)."""
    image = cfg["vae"]["image_size"]

    def f(z):
        x = ref_vae.decode(sd, z[:, None, None, :], image, train=False)
        return torch.sigmoid(x).reshape(z.shape[0], -1)

    return f


def edge_lengths(sd: Dict, cfg: Dict, z: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor, batch: int = 65536) -> torch.Tensor:
    f = decode_image(sd, cfg)
    out = torch.empty(rows.shape[0], device=z.device)
    for s in range(0, rows.shape[0], batch):
        za, zb = z[rows[s:s + batch]], z[cols[s:s + batch]]
        dz = zb - za
        _, ja = torch.func.jvp(f, (za,), (dz,))
        _, jb = torch.func.jvp(f, (zb,), (dz,))
        out[s:s + batch] = 0.5 * (torch.linalg.vector_norm(ja, dim=1)
                                  + torch.linalg.vector_norm(jb, dim=1))
    return out


def kink_ratio(sd: Dict, cfg: Dict, z: torch.Tensor,
               batch: int = 65536) -> torch.Tensor:
    """(N,) the least |ReLU input| of the decoder at each latent over that
    unit's summed absolute terms (the magnitude that bounds its rounding),
    in float64: where it is tiny, float32 rounding decides which side of
    the kink the unit lies, and two exact implementations may gate it
    differently."""
    image = cfg["vae"]["image_size"]
    d64 = {k: v.double() if v.is_floating_point() else v
           for k, v in sd.items()}
    out = torch.empty(z.shape[0], dtype=torch.float64, device=z.device)
    for s in range(0, z.shape[0], batch):
        h = z[s:s + batch].double()[:, :, None, None]
        mag = h.abs()
        w, b = d64["decoder.conv_in.weight"], d64["decoder.conv_in.bias"]
        h = torch.nn.functional.conv2d(h, w, b)
        mag = torch.nn.functional.conv2d(mag, w.abs(), b.abs())
        least = torch.full((h.shape[0],), float("inf"), dtype=torch.float64,
                           device=z.device)
        for j, norm in enumerate(ref_vae.DEC_NORMS):
            conv = f"decoder.deconv_layers.{3 * j}"
            w, b = d64[f"{conv}.weight"], d64[f"{conv}.bias"]
            h = torch.nn.functional.conv_transpose2d(h, w, b, stride=2,
                                                     padding=1)
            mag = torch.nn.functional.conv_transpose2d(mag, w.abs(), b.abs(),
                                                       stride=2, padding=1)
            scale = (d64[f"{norm}.weight"] / torch.sqrt(
                d64[f"{norm}.running_var"] + ref_vae.BN_EPS))[:, None, None]
            mean = d64[f"{norm}.running_mean"][:, None, None]
            shift = d64[f"{norm}.bias"][:, None, None]
            h = (h - mean) * scale + shift
            mag = mag * scale.abs() + (mean * scale).abs() + shift.abs()
            ratio = h.abs() / mag.clamp_min(1e-300)
            least = torch.minimum(least, ratio.flatten(1).min(1).values)
            h = torch.relu(h)
            mag = torch.where(h > 0, mag, torch.zeros_like(mag))
        out[s:s + batch] = least
    return out


def components(rows: torch.Tensor, cols: torch.Tensor, n: int
               ) -> torch.Tensor:
    """(N,) component labels (the least node id of each component)."""
    lab = torch.arange(n, device=rows.device)
    src = torch.cat([rows, cols])
    dst = torch.cat([cols, rows])
    while True:
        new = lab.scatter_reduce(0, dst, lab[src], "amin")
        new = new[new]  # pointer jumping
        if torch.equal(new, lab):
            return lab
        lab = new


def largest_component(labels: torch.Tensor) -> torch.Tensor:
    counts = torch.bincount(labels, minlength=labels.shape[0])
    return labels == torch.argmax(counts)


def bellman_ford(rows: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                 n: int, sources: torch.Tensor) -> torch.Tensor:
    """(N,) float32 distance from the nearest source over the undirected
    edges."""
    src = torch.cat([rows, cols])
    dst = torch.cat([cols, rows])
    ww = torch.cat([w, w])
    d = torch.full((n,), float("inf"), device=rows.device)
    d[sources] = 0.0
    while True:
        new = d.scatter_reduce(0, dst, d[src] + ww, "amin")
        if torch.equal(new, d):
            return d
        d = new


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def nearest_source(rows: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                   n: int, sources: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distance, slot) of every node's nearest source (its position in
    ``sources``; equal distances go to the lowest slot; -1 where no source
    reaches): Bellman-Ford, then the slots carried along the edges that
    are tight (tail distance plus length equals the head's distance)."""
    d = bellman_ford(rows, cols, w, n, sources)
    src = torch.cat([rows, cols])
    dst = torch.cat([cols, rows])
    ww = torch.cat([w, w])
    tight = (d[src] + ww == d[dst]) & torch.isfinite(d[dst])
    src, dst = src[tight], dst[tight]
    big = torch.iinfo(torch.long).max
    slot = torch.full((n,), big, dtype=torch.long, device=rows.device)
    slot[sources] = torch.arange(sources.shape[0], device=rows.device)
    fixed = torch.zeros(n, dtype=torch.bool, device=rows.device)
    fixed[sources] = True
    while True:
        new = slot.scatter_reduce(0, dst, slot[src], "amin")
        new = torch.where(fixed, slot, new)
        if torch.equal(new, slot):
            break
        slot = new
    return d, torch.where(slot == big, -1, slot)


def bfs_order(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``perm[new] = old``: breadth-first from the lowest unvisited node,
    each node's neighbours in their stored order (level by level, which is
    a queue's order: a node goes where it is first reached)."""
    n = len(indptr) - 1
    visited = np.zeros(n, dtype=bool)
    out: List[np.ndarray] = []
    start = 0
    while start < n:
        visited[start] = True
        frontier = np.array([start], dtype=np.int64)
        while len(frontier):
            out.append(frontier)
            a, b = indptr[frontier], indptr[frontier + 1]
            lens = b - a
            pos = (np.arange(int(lens.sum()))
                   - np.repeat(np.cumsum(lens) - lens, lens)
                   + np.repeat(a, lens))
            nb = indices[pos]
            nb = nb[~visited[nb]]
            _, first = np.unique(nb, return_index=True)
            frontier = nb[np.sort(first)].astype(np.int64)
            visited[frontier] = True
        rest = np.flatnonzero(~visited)
        start = int(rest[0]) if len(rest) else n
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def draws_in_bfs_order(nnz: int, K: int) -> bool:
    """The stage relabels its graph breadth-first before the rounds where
    the work, stored edges times K, reaches 2.5e5 a thread of the host."""
    return nnz * max(K, 1) >= 2.5e5 * max(1, len(os.sched_getaffinity(0)))


def pick_schedule(K: int, rounds: int) -> List[int]:
    """Centers drawn in each round after the first: blocks of
    ceil((K - 1) / rounds), the last one short."""
    rounds = max(1, min(rounds, K - 1))
    width = math.ceil((K - 1) / rounds)
    sizes, rem = [], K - 1
    while rem > 0:
        sizes.append(min(width, rem))
        rem -= sizes[-1]
    return sizes


def sq_probs(d: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """d^2 weights, unreachable nodes at twice the farthest reachable,
    centers at 0, in float64."""
    finite = np.isfinite(d)
    safe = (np.where(finite, d, float(d[finite].max()) * 2.0)
            if finite.any() else np.ones_like(d))
    p = safe.astype(np.float64) ** 2
    p[centers] = 0.0
    return p


def draw(rng: np.random.Generator, probs: np.ndarray, m: int
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(picks, keys): ``m`` distinct nodes ~ ``probs`` by Gumbel top-m,
    largest key first."""
    logp = np.full(probs.shape[0], -np.inf)
    nz = probs > 0
    logp[nz] = np.log(probs[nz])
    keys = logp + rng.gumbel(size=probs.shape[0])
    picks = np.argsort(-keys)[:m]
    return picks[np.isfinite(logp[picks])], keys


def kpp_parallel(rows: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                 n: int, perm: np.ndarray, K: int, seed: int, rounds: int,
                 held: np.ndarray = None, key_tie: float = 0.0):
    """The medoids (node ids) by k-means|| rounds over the graph's
    shortest paths, drawing in the node order ``perm``.

    With ``held`` (the program's medoids, in its order) each round starts
    from the program's centers before it, and the return is the number of
    the program's draws that differ from the reference's beyond near-ties
    (keys within ``key_tie``), its first center and count included;
    without, the reference's own medoids."""
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rng = np.random.default_rng(seed)
    first = int(perm[rng.integers(0, n)])
    if held is None:
        centers = [first]
    else:
        held = np.asarray(held, dtype=np.int64)
        bad = int(len(held) != min(K, n)) * K
        bad += int(len(held) == 0 or held[0] != first)
        centers = list(held[:1])
    for m in pick_schedule(K, rounds):
        m = min(m, K - len(centers))
        if m <= 0 or (held is not None and len(centers) >= len(held)):
            break
        src = torch.as_tensor(np.asarray(centers), device=rows.device)
        d = to_numpy(bellman_ford(rows, cols, w, n, src))[perm]
        picks, keys = draw(rng, sq_probs(d, inv[centers]), m)
        if held is None:
            centers.extend(int(p) for p in perm[picks])
            continue
        prog = inv[held[len(centers):len(centers) + m]]
        bad += abs(len(prog) - len(picks))
        j = min(len(prog), len(picks))
        off = ((prog[:j] != picks[:j])
               & (np.abs(keys[prog[:j]] - keys[picks[:j]]) > key_tie))
        bad += int(off.sum())
        centers.extend(int(c) for c in held[len(centers):len(centers) + m])
    return bad if held is not None else np.asarray(centers, np.int64)
