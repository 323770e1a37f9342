"""K-sweep elbow analysis with clustering-quality metrics.

The port of ``demos/kmedoids_geodesic_analysis.py``: sweep codebook sizes
over a union kNN graph of an experiment's training latents (spatial grids
mean-pooled per image, the first ``max_points``), restricted to its
largest connected component, and record per K the quantization error
(the elbow curve), purity, NMI and ARI against the dataset labels, and the
codebook perplexity. Writes ``<experiment>/demo_kmedoids_analysis.json``;
``main`` also draws ``demo_kmedoids_analysis.png``.

NMI (arithmetic mean of the entropies) and ARI are computed here in numpy
with scikit-learn's definitions (``normalized_mutual_info_score``,
``adjusted_rand_score``), which the JAX demo imports: the port needs no
scikit-learn.

Run: ``python -m vqvae_tpu_torch.demos.kmedoids_geodesic_analysis
<experiment_dir> [--Ks 16 32 64 128] [--k_graph 10] [--seed 42]
[--max_points 10000] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..ops import build_knn_graph, fit_kmedoids, largest_connected_component
from ..utils.latents import load_latents


def purity(labels_true, labels_pred) -> float:
    total = 0
    for c in np.unique(labels_pred):
        members = labels_true[labels_pred == c]
        if members.size:
            total += np.bincount(members).max()
    return total / max(len(labels_true), 1)


def _contingency(labels_true, labels_pred) -> np.ndarray:
    _, t = np.unique(labels_true, return_inverse=True)
    _, p = np.unique(labels_pred, return_inverse=True)
    table = np.zeros((t.max() + 1, p.max() + 1), np.int64)
    np.add.at(table, (t, p), 1)
    return table


def _entropy(counts: np.ndarray) -> float:
    pi = counts[counts > 0].astype(np.float64)
    if pi.size <= 1:
        return 0.0
    s = pi.sum()
    return float(-np.sum((pi / s) * (np.log(pi) - np.log(s))))


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """scikit-learn's ``normalized_mutual_info_score`` (arithmetic)."""
    table = _contingency(labels_true, labels_pred)
    if table.shape[0] == table.shape[1] == 1:
        return 1.0
    pi, pj = table.sum(1), table.sum(0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    nzx, nzy = np.nonzero(table)
    nz = table[nzx, nzy].astype(np.float64)
    total = float(table.sum())
    outer = pi[nzx].astype(np.int64) * pj[nzy].astype(np.int64)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    mi = (nz / total) * (np.log(nz) - np.log(total)) + (nz / total) * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    mi = max(float(mi.sum()), 0.0)
    if mi == 0.0:
        return 0.0
    return float(mi / ((_entropy(pi) + _entropy(pj)) / 2.0))


def adjusted_rand(labels_true, labels_pred) -> float:
    """scikit-learn's ``adjusted_rand_score``, from the pair counts."""
    table = _contingency(labels_true, labels_pred)
    n = int(table.sum())
    sum_sq = int((table * table).sum())
    fp = int((table @ table.sum(0)).sum()) - sum_sq
    fn = int((table.T @ table.sum(1)).sum()) - sum_sq
    tp = sum_sq - n
    tn = n * n - fp - fn - sum_sq
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def run(experiment_dir, Ks=(16, 32, 64, 128), k_graph: int = 10,
        seed: int = 42, max_points: int = 10000, device=None) -> list:
    """The K sweep on ``device`` (default the GPU); writes and returns its
    rows."""
    dev = resolve_device(device)
    exp = Path(experiment_dir)
    lat = load_latents(next(exp.rglob("latents_train")))
    z, y = lat["z"], lat["y"]
    if z.ndim == 4:  # per-image analysis: pool the grid
        z = z.mean(axis=(1, 2))
    z = z[:max_points].astype(np.float32)
    y = y[:max_points]

    W, _ = build_knn_graph(z, k=k_graph, sym="union", device=dev)
    mask = largest_connected_component(W)
    W_lcc = W[mask][:, mask]
    y_lcc = y[mask]

    rows = []
    for K in Ks:
        _, assign, qe = fit_kmedoids(W_lcc, K=K, init="kpp_parallel",
                                     seed=seed, device=dev)
        hist = np.bincount(assign, minlength=K).astype(np.float64)
        p = hist / max(hist.sum(), 1.0)
        ppl = float(np.exp(-(p * np.log(p + 1e-12)).sum()))
        rows.append({
            "K": K, "qe": qe,
            "purity": purity(y_lcc, assign),
            "nmi": normalized_mutual_info(y_lcc, assign),
            "ari": adjusted_rand(y_lcc, assign),
            "perplexity": ppl,
        })
        print(f"K={K}: qe={qe:.1f} purity={rows[-1]['purity']:.3f} "
              f"nmi={rows[-1]['nmi']:.3f} ari={rows[-1]['ari']:.3f} "
              f"ppl={ppl:.1f}")

    out = exp / "demo_kmedoids_analysis.json"
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"[demo] saved {out}")
    return rows


def plot(experiment_dir, rows: list) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    ks = [r["K"] for r in rows]
    axes[0].plot(ks, [r["qe"] for r in rows], "o-")
    axes[0].set_xlabel("K")
    axes[0].set_ylabel("quantization error")
    axes[0].set_title("elbow")
    axes[1].plot(ks, [r["purity"] for r in rows], "o-", label="purity")
    axes[1].plot(ks, [r["nmi"] for r in rows], "s-", label="NMI")
    axes[1].plot(ks, [r["ari"] for r in rows], "^-", label="ARI")
    axes[1].legend()
    axes[1].set_xlabel("K")
    fig.tight_layout()
    out = Path(experiment_dir) / "demo_kmedoids_analysis.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"[demo] saved {out}")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment_dir", type=str)
    ap.add_argument("--Ks", type=int, nargs="+", default=[16, 32, 64, 128])
    ap.add_argument("--k_graph", type=int, default=10)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max_points", type=int, default=10000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rows = run(args.experiment_dir, Ks=args.Ks, k_graph=args.k_graph,
               seed=args.seed, max_points=args.max_points,
               device=args.device)
    plot(args.experiment_dir, rows)
    return rows


if __name__ == "__main__":
    main()
