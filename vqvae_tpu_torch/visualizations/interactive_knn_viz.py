"""Clickable kNN/geodesic explorer with a graph cached per k.

The port of ``visualizations/interactive_knn_viz.py``: a noisy 2-D spiral
(numpy ``default_rng(0)``, as JAX), ``Explorer`` keeping one union kNN
graph per k and computing the geodesic distances from a source on
demand. ``run`` returns the points and the distances from node 0. With a
display, ``main`` recolors by the distance from each clicked point;
headless, it saves the static panel to ``--out``.

Run: ``python -m vqvae_tpu_torch.visualizations.interactive_knn_viz
[--n 800] [--k 8] [--out demo_outputs/interactive_knn_viz.png]
[--device cpu]``.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict

import numpy as np

from ..device import resolve_device
from ..ops import build_knn_graph
from ..ops.backend import multi_source_distances


def make_spiral(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 4 * np.pi, n)
    z = np.stack([t * np.cos(t), t * np.sin(t)], 1).astype(np.float32)
    return z + rng.normal(0, 0.3, z.shape).astype(np.float32)


class Explorer:
    """One graph per k, built at first use; distances per source."""

    def __init__(self, z2d: np.ndarray, k: int, device=None):
        self.z = z2d
        self.device = resolve_device(device)
        self._cache = {}
        self.set_k(k)

    def set_k(self, k: int) -> None:
        if k not in self._cache:
            self._cache[k], _ = build_knn_graph(self.z, k=k, sym="union",
                                                device=self.device)
        self.W = self._cache[k]

    def distances_from(self, idx: int) -> np.ndarray:
        return multi_source_distances(self.W, np.asarray([idx]),
                                      device=self.device)[:, 0]


def run(n: int = 800, k: int = 8, device=None) -> Dict:
    """The spiral, its explorer and the distances from node 0 on
    ``device`` (default the GPU)."""
    z = make_spiral(n)
    explorer = Explorer(z, k, device=device)
    return {"z": z, "k": k, "explorer": explorer,
            "distances": explorer.distances_from(0)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--out", type=str,
                    default="demo_outputs/interactive_knn_viz.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    result = run(args.n, args.k, device=args.device)
    z, explorer = result["z"], result["explorer"]

    import matplotlib

    interactive = bool(os.environ.get("DISPLAY"))
    if not interactive:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))

    def draw(idx: int):
        ax.clear()
        d = explorer.distances_from(idx)
        finite = np.isfinite(d)
        ax.scatter(z[finite, 0], z[finite, 1], c=d[finite], s=8,
                   cmap="viridis")
        ax.scatter(z[~finite, 0], z[~finite, 1], c="lightgray", s=8)
        ax.scatter(*z[idx], c="red", s=100, marker="*")
        ax.set_title(f"geodesic distances from node {idx} (k={args.k})")
        fig.canvas.draw_idle()

    draw(0)
    if interactive:
        def on_click(event):
            if event.xdata is None:
                return
            p = np.array([event.xdata, event.ydata], np.float32)
            draw(int(np.argmin(((z - p) ** 2).sum(1))))

        fig.canvas.mpl_connect("button_press_event", on_click)
        plt.show()
    else:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f"[viz] headless: saved {out}")
    return result


if __name__ == "__main__":
    main()
