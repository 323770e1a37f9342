"""Riemannian re-weighting's effect on graph structure.

The port of ``experiments_geo/run_riemann_experiments.py``: a Euclidean
union kNN graph over an experiment's training latents (spatial grids
flattened to cells, the first ``max_points``), a decile-stratified subset
of ``max_edges`` edges re-weighted with Riemannian lengths through the
experiment's VAE decoder (``cli.build_codebook_legacy``'s
``_reweight_graph_with_riemannian``), and the path-dilation ratio (mean
shortest path from 32 sources after / before) with the component counts.
As in JAX, the raw ratio mixes units (decoder-Jacobian lengths spliced
into a Euclidean graph) and a unit-free one renormalizes the total edge
weight first. Writes ``<experiment>/riemann_graph_effect.json``.

Run: ``python -m vqvae_tpu_torch.experiments_geo.run_riemann_experiments
<experiment_dir> [--k 10] [--max_edges 5000] [--max_points 10000]
[--seed 42] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from scipy.sparse.csgraph import connected_components

from ..cli.build_codebook_legacy import _reweight_graph_with_riemannian
from ..cli.quality_checks import _load_vae
from ..device import resolve_device
from ..ops import build_knn_graph
from ..ops.backend import multi_source_distances
from ..ops.riemannian import make_decoder_image_fn
from ..utils.latents import load_latents


def mean_shortest_path(W, n_sources: int = 32, seed: int = 0,
                       device=None) -> float:
    rng = np.random.default_rng(seed)
    sources = rng.choice(W.shape[0], size=min(n_sources, W.shape[0]),
                         replace=False)
    D = multi_source_distances(W, sources, device=device)
    finite = D[np.isfinite(D) & (D > 0)]
    return float(finite.mean()) if finite.size else float("inf")


def run(experiment_dir, k: int = 10, max_edges: int = 5000,
        max_points: int = 10000, seed: int = 42, device=None) -> dict:
    """The experiment on ``device`` (default the GPU); writes and returns
    its results."""
    dev = resolve_device(device)
    exp = Path(experiment_dir)
    model, vae_dir = _load_vae(exp, dev)
    z = load_latents(vae_dir / "latents_train")["z"]
    if z.ndim == 4:
        z = z.reshape(-1, z.shape[-1])
    z = z[:max_points].astype(np.float32)
    decode_fn = make_decoder_image_fn(model, model.topology)

    W_eu, _ = build_knn_graph(z, k=k, sym="union", device=dev)
    ncomp_eu, _ = connected_components(W_eu, directed=False)
    sp_eu = mean_shortest_path(W_eu, seed=seed, device=dev)

    W_riem_raw = _reweight_graph_with_riemannian(
        W_eu, z, decode_fn, mode="subset", max_edges=max_edges, seed=seed,
        device=dev)
    sp_riem_raw = mean_shortest_path(W_riem_raw, seed=seed, device=dev)
    ratio_raw = sp_riem_raw / max(sp_eu, 1e-12)
    scale = W_eu.sum() / max(W_riem_raw.sum(), 1e-12)
    W_riem = W_riem_raw * scale
    ncomp_riem, _ = connected_components(W_riem, directed=False)
    sp_riem = mean_shortest_path(W_riem, seed=seed, device=dev)

    ratio = sp_riem / max(sp_eu, 1e-12)
    results = {
        "k": k, "n_points": int(len(z)), "max_edges": max_edges,
        "components_euclidean": int(ncomp_eu),
        "components_riemannian": int(ncomp_riem),
        "mean_sp_euclidean": sp_eu,
        "mean_sp_riemannian": sp_riem,
        "path_dilation_ratio": ratio,
        "mean_sp_riemannian_raw": sp_riem_raw,
        "path_dilation_ratio_raw": ratio_raw,
    }
    print(json.dumps(results, indent=2))
    out = exp / "riemann_graph_effect.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[exp] connectivity unchanged: {ncomp_eu == ncomp_riem}; "
          f"dilation ratio R={ratio:.3f} (unit-free), "
          f"R_raw={ratio_raw:.3f} (mixed units)")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment_dir", type=str)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max_edges", type=int, default=5000)
    ap.add_argument("--max_points", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.experiment_dir, k=args.k, max_edges=args.max_edges,
               max_points=args.max_points, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()
