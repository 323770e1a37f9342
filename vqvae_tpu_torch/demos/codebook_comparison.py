"""Euclidean K-means vs geodesic K-medoids codebook comparison.

The port of ``demos/codebook_comparison.py``: both codebooks from an
experiment's training latents (spatial grids flattened to cells, the first
``max_points``), compared on latent reconstruction MSE, perplexity and
their own error (k-means inertia, k-medoids QE). The Euclidean side is
``ops.fit_kmeans``; the geodesic side a union kNN graph, its largest
connected component and ``fit_kmedoids`` (kpp_parallel). Writes
``<experiment>/demo_codebook_comparison.json``; ``main`` also draws
``demo_codebook_comparison.png``.

Run: ``python -m vqvae_tpu_torch.demos.codebook_comparison <experiment_dir>
[--K 64] [--k_graph 10] [--seed 42] [--max_points 20000] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..ops import (build_knn_graph, fit_kmeans, fit_kmedoids,
                   largest_connected_component)
from ..utils.latents import load_latents


def perplexity(labels: np.ndarray, K: int) -> float:
    hist = np.bincount(labels[labels >= 0], minlength=K).astype(np.float64)
    p = hist / max(hist.sum(), 1.0)
    return float(np.exp(-(p * np.log(p + 1e-12)).sum()))


def run(experiment_dir, K: int = 64, k_graph: int = 10, seed: int = 42,
        max_points: int = 20000, device=None) -> dict:
    """Build both codebooks on ``device`` (default the GPU) and write the
    comparison JSON; returns it."""
    dev = resolve_device(device)
    exp = Path(experiment_dir)
    lat_dirs = list(exp.rglob("latents_train"))
    if not lat_dirs:
        raise FileNotFoundError(f"no latents_train under {exp}")
    z = load_latents(lat_dirs[0])["z"]
    if z.ndim == 4:  # spatial: flatten grid cells to nodes
        z = z.reshape(-1, z.shape[-1])
    z = z[:max_points].astype(np.float32)
    print(f"[demo] latents: {z.shape}")

    centers, eu_labels, inertia = fit_kmeans(z, K, seed=seed, device=dev)
    eu_mse = float(np.mean(np.sum((z - centers[eu_labels]) ** 2, axis=1)))
    print(f"[euclidean] inertia={inertia:.1f} recon_mse={eu_mse:.4f} "
          f"perplexity={perplexity(eu_labels, K):.1f}")

    W, _ = build_knn_graph(z, k=k_graph, sym="union", device=dev)
    mask = largest_connected_component(W)
    W_lcc = W[mask][:, mask]
    medoids, geo_labels_lcc, qe = fit_kmedoids(W_lcc, K=K,
                                               init="kpp_parallel",
                                               seed=seed, device=dev)
    geo_labels = np.full(len(z), -1, np.int64)
    geo_labels[mask] = geo_labels_lcc
    z_lcc = z[mask]
    geo_mse = float(np.mean(np.sum(
        (z_lcc - z_lcc[medoids][geo_labels_lcc]) ** 2, axis=1)))
    print(f"[geodesic] qe={qe:.1f} recon_mse={geo_mse:.4f} "
          f"perplexity={perplexity(geo_labels, K):.1f}")

    results = {
        "K": K, "k_graph": k_graph, "n_points": int(len(z)),
        "euclidean": {"inertia": inertia, "recon_mse": eu_mse,
                      "perplexity": perplexity(eu_labels, K)},
        "geodesic": {"qe": qe, "recon_mse": geo_mse,
                     "perplexity": perplexity(geo_labels, K),
                     "lcc_nodes": int(mask.sum())},
    }
    out = exp / "demo_codebook_comparison.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[demo] saved {out}")
    return results


def plot(experiment_dir, results: dict) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    eu, geo = results["euclidean"], results["geodesic"]
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    axes[0].bar(["euclidean", "geodesic"], [eu["recon_mse"],
                                            geo["recon_mse"]])
    axes[0].set_title("latent recon MSE")
    axes[1].bar(["euclidean", "geodesic"], [eu["perplexity"],
                                            geo["perplexity"]])
    axes[1].set_title("perplexity")
    fig.tight_layout()
    out = Path(experiment_dir) / "demo_codebook_comparison.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"[demo] saved {out}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment_dir", type=str)
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--k_graph", type=int, default=10)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max_points", type=int, default=20000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    results = run(args.experiment_dir, K=args.K, k_graph=args.k_graph,
                  seed=args.seed, max_points=args.max_points,
                  device=args.device)
    plot(args.experiment_dir, results)
    return results


if __name__ == "__main__":
    main()
