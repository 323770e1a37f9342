"""How the kNN ``k`` changes connectivity and geodesic distances.

The port of ``visualizations/knn_experiments.py``: on an experiment's
latents (``--latents``, spatial grids flattened to cells, the first
``--n``) or on ``--n`` standard normal 16-D points (numpy
``default_rng(0)``, as JAX), for each ``k`` a union kNN graph
(``ops.build_knn_graph``), its components and largest-component share
(``analyze_graph_connectivity``), and the geodesic distances from sources
0-7 (``ops.backend.multi_source_distances``): their finite values' mean.
``main`` draws the LCC share and the normalized mean against k, and the
distance histograms, into ``--out``.

Run: ``python -m vqvae_tpu_torch.visualizations.knn_experiments
[--latents <dir|npz>] [--ks 5 10 20 50] [--n 5000]
[--out demo_outputs/knn_experiments.png] [--device cpu]``.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..ops import analyze_graph_connectivity, build_knn_graph
from ..ops.backend import multi_source_distances
from ..utils.latents import load_latents

SOURCES = np.arange(8, dtype=np.int64)


def load_points(latents: Optional[str], n: int) -> np.ndarray:
    if latents:
        z = load_latents(latents)["z"]
        if z.ndim == 4:
            z = z.reshape(-1, z.shape[-1])
        return z[:n].astype(np.float32)
    return np.random.default_rng(0).normal(size=(n, 16)).astype(np.float32)


def run(z: np.ndarray, ks: Sequence[int] = (5, 10, 20, 50),
        device=None) -> Dict:
    """Per k: components, LCC share, the mean finite geodesic distance
    from sources 0-7 and those distances; computed on ``device``
    (default the GPU)."""
    dev = resolve_device(device)
    rows = []
    for k in ks:
        W, _ = build_knn_graph(z, k=k, sym="union", device=dev)
        stats = analyze_graph_connectivity(W)
        D = multi_source_distances(W, SOURCES, device=dev)
        finite = D[np.isfinite(D)]
        rows.append({"k": int(k), "n_components": stats["n_components"],
                     "connectivity_ratio": stats["connectivity_ratio"],
                     "mean_geodesic": (float(finite.mean()) if finite.size
                                       else float("nan")),
                     "distances": finite})
        print(f"k={k}: components={stats['n_components']} "
              f"lcc={stats['connectivity_ratio']:.2%} "
              f"mean geodesic={rows[-1]['mean_geodesic']:.3f}")
    return {"n": int(len(z)), "rows": rows}


def plot(result: Dict, out):
    from .plot_utils import apply_style, save_fig

    apply_style()
    import matplotlib.pyplot as plt

    rows = result["rows"]
    ks = [r["k"] for r in rows]
    means = np.asarray([r["mean_geodesic"] for r in rows])
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for r in rows:
        axes[1].hist(r["distances"], bins=50, alpha=0.5,
                     label=f"k={r['k']}", density=True)
    axes[0].plot(ks, [r["connectivity_ratio"] for r in rows], "o-",
                 label="LCC fraction")
    axes[0].plot(ks, means / max(means), "s-",
                 label="mean geodesic (norm.)")
    axes[0].set_xlabel("k")
    axes[0].legend()
    axes[1].set_xlabel("geodesic distance")
    axes[1].legend()
    path = save_fig(fig, out)
    print(f"[viz] saved {path}")
    return path


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--latents", type=str, default=None,
                    help="latents dir/npz; synthetic gaussian if omitted")
    ap.add_argument("--ks", type=int, nargs="+", default=[5, 10, 20, 50])
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--out", type=str,
                    default="demo_outputs/knn_experiments.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    result = run(load_points(args.latents, args.n), args.ks,
                 device=args.device)
    plot(result, args.out)
    return result


if __name__ == "__main__":
    main()
