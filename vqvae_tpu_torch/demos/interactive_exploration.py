"""Synthetic-latent kNN/geodesic explorer.

The port of ``demos/interactive_exploration.py``: a union kNN graph over
two-moons 2-D latents (numpy ``default_rng(0)``, as JAX) and the geodesic
distances from three probe nodes (``ops.backend.multi_source_distances``);
``main`` draws one panel per probe into ``--out``
(``demo_outputs/interactive_knn.png``).

Run: ``python -m vqvae_tpu_torch.demos.interactive_exploration [--n 1000]
[--k 8] [--out <png>] [--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..ops import build_knn_graph
from ..ops.backend import multi_source_distances


def make_two_moons(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n // 2)
    a = np.stack([np.cos(t), np.sin(t)], 1)
    b = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    z = np.concatenate([a, b]) + rng.normal(0, 0.05, (2 * (n // 2), 2))
    return z.astype(np.float32)


def run(n: int = 1000, k: int = 8, device=None) -> dict:
    """The latents, the probe nodes and their (N, 3) geodesic distances,
    computed on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    z = make_two_moons(n)
    W, _ = build_knn_graph(z, k=k, sym="union", device=dev)
    probes = [0, n // 3, 2 * n // 3]
    D = multi_source_distances(W, np.asarray(probes), device=dev)
    return {"z": z, "probes": probes, "distances": D}


def plot(result: dict, out) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z, probes, D = result["z"], result["probes"], result["distances"]
    fig, axes = plt.subplots(1, len(probes), figsize=(5 * len(probes), 4))
    for ax, (pi, p) in zip(np.atleast_1d(axes), enumerate(probes)):
        d = D[:, pi]
        finite = np.isfinite(d)
        sc = ax.scatter(z[finite, 0], z[finite, 1], c=d[finite], s=6,
                        cmap="viridis")
        ax.scatter(*z[p], c="red", s=80, marker="*")
        ax.set_title(f"geodesic distance from node {p}")
        fig.colorbar(sc, ax=ax)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"[demo] saved {out}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--out", type=str,
                    default="demo_outputs/interactive_knn.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    result = run(n=args.n, k=args.k, device=args.device)
    plot(result, args.out)
    return result


if __name__ == "__main__":
    main()
