"""Spatial geodesic codebook build — the port of
``vqvae_tpu/cli/build_codebook.py``.

Spatial latents -> grid cells flattened to nodes -> Euclidean kNN
connectivity graph (union) -> Riemannian re-weighting of every unique edge
through decoder JVPs -> symmetric CSR -> LCC -> graph K-medoids -> codes
(N, H, W) with -1 off the LCC. Writes the JAX package's four artifacts:

    knn_graph_geodesic.npz   (scipy CSR of the LCC graph; `utils/npz.py`)
    codebook.npz             {medoid_indices, z_medoid, config_json}
    codebook.pt              (mirror of the reference artifact)
    codes.npy

Run: ``python -m vqvae_tpu_torch.cli.build_codebook --config <yaml>
[--device cpu]``; the VAE checkpoint must be a reference-format ``.pt``
file (``utils/checkpoint.py``). As in JAX, every geo kernel shards over
the mesh (``get_mesh()``): under ``torchrun`` the kNN query blocks, the
edge chunks and the k-medoids source columns split over the ranks, every
rank assembles the same graph, and rank 0 writes the artifacts.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Config, load_config
from ..device import resolve_device
from ..ops.graph import (build_knn_graph_auto, largest_connected_component,
                         symmetric_csr_from_edges)
from ..ops.kmedoids import fit_kmedoids
from ..ops.knn import resolve_knn_kernel
from ..ops.riemannian import (edge_lengths_riemannian_auto,
                              make_decoder_image_fn)
from ..parallel.mesh import barrier, get_mesh, init_distributed, is_primary
from ..utils.checkpoint import load_vae_from_checkpoint
from ..utils.latents import flatten_spatial, load_latents
from ..utils.npz import save_csr_npz
from ..utils.profiling import count, span


def build_codebook_main(cfg: Config, device=None) -> Path:
    """Run the codebook stage for ``cfg`` on ``device`` (default the GPU;
    raises when CUDA is absent and no device is given)."""
    init_distributed(device=device)
    dev = resolve_device(device)
    mesh = get_mesh()  # every geo kernel shards over the process group
    with span("vqvae.codebook.build"):
        return _build(cfg, dev, mesh)


def _build(cfg: Config, dev: torch.device, mesh) -> Path:
    out_dir = Path(cfg["out_dir"])
    if is_primary():
        out_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    timings_s = {}

    vae_cfg = dict(cfg["vae"])
    vae_cfg.setdefault("topology", "spatial")
    vae_cfg["enc_channels"] = tuple(vae_cfg.get("enc_channels",
                                                (64, 128, 256)))
    vae_cfg["dec_channels"] = tuple(vae_cfg.get("dec_channels",
                                                (256, 128, 64)))
    vae_cfg.setdefault("recon_loss", "mse")
    vae_cfg.setdefault("mse_use_sigmoid", True)
    with span("vqvae.codebook.inputs"):
        model = load_vae_from_checkpoint(cfg["vae_ckpt_path"], vae_cfg,
                                         device=dev)
        decode_fn = make_decoder_image_fn(model, model.topology)
        z = load_latents(cfg["latents_path"])["z"]
    if z.ndim != 4:
        raise ValueError(
            f"spatial codebook build expects (N,H,W,C) latents, got {z.shape}")
    n, h, w, c = z.shape
    print(f"[codebook] latents: N={n}, H={h}, W={w}, C={c} (device {dev})")
    z_flat = flatten_spatial(z)

    graph_cfg = cfg.get("graph", Config({}))
    k = int(graph_cfg.get("k", cfg.get("k", 20)))
    sym = str(graph_cfg.get("sym", cfg.get("sym", "union")))
    method = graph_cfg.get("method", "approx")
    if method == "exact":
        method = None
    print(f"[codebook] kNN selection: "
          f"{resolve_knn_kernel(method is not None)} "
          f"(graph.method={'exact' if method is None else method})")
    with span("vqvae.codebook.knn", timings_s):
        W_eu, _ = build_knn_graph_auto(z_flat, k=k, metric="euclidean",
                                       mode="connectivity", sym=sym,
                                       force_method=method, device=dev,
                                       mesh=mesh)
    print(f"[codebook] kNN graph: {W_eu.shape[0]} nodes, {W_eu.nnz} edges "
          f"({timings_s['knn']:.3f}s)")

    rows, cols = W_eu.nonzero()
    keep = rows < cols
    rows, cols = rows[keep], cols[keep]
    batch_size = int(cfg.get("system", Config({})).get(
        "batch_size", cfg.get("batch_size", 512)))
    with span("vqvae.codebook.riemannian", timings_s):
        lengths = edge_lengths_riemannian_auto(
            decode_fn, z_flat, rows, cols, batch_size=batch_size, device=dev,
            mesh=mesh)
    print(f"[codebook] Riemannian re-weighting: {len(lengths)} edges "
          f"({timings_s['riemannian']:.3f}s)")

    # the CSR + LCC step in four chained spans: their seconds add up to
    # ``lcc``, the step's own two clock readings
    with span("vqvae.codebook.csr", timings_s) as csr:
        W_geo = symmetric_csr_from_edges(rows, cols, np.asarray(lengths),
                                         W_eu.shape[0])
    with span("vqvae.codebook.components", timings_s, after=csr) as cc:
        mask_lcc = largest_connected_component(W_geo)
    with span("vqvae.codebook.subgraph", timings_s, after=cc) as sub:
        if mask_lcc.sum() < W_geo.shape[0]:
            print(f"[codebook] Using LCC: {int(mask_lcc.sum())}/"
                  f"{W_geo.shape[0]} nodes")
            W_lcc = W_geo[mask_lcc][:, mask_lcc].tocsr()
            z_lcc = z_flat[mask_lcc]
        else:
            W_lcc, z_lcc = W_geo.tocsr(), z_flat
    with span("vqvae.codebook.graph_write", timings_s, after=sub) as write:
        if is_primary():
            count("vqvae.codebook.graph_write_chunks",
                  save_csr_npz(out_dir / "knn_graph_geodesic.npz", W_lcc))
    timings_s["lcc"] = (write.end - csr.start) / 1e9

    quant_cfg = cfg.get("quantize", Config({}))
    K = int(quant_cfg.get("K", cfg.get("K", 512)))
    init = str(quant_cfg.get("init", cfg.get("init", "kpp_parallel")))
    seed = int(quant_cfg.get("seed", cfg.get("seed", 42)))
    kpp_rounds = int(quant_cfg.get("kpp_rounds", cfg.get("kpp_rounds", 4)))
    kpp_schedule = str(quant_cfg.get("kpp_schedule",
                                     cfg.get("kpp_schedule", "flat")))
    with span("vqvae.codebook.kmedoids", timings_s):
        medoids, assign_lcc, qe = fit_kmedoids(
            W_lcc, K=K, init=init, seed=seed, kpp_rounds=kpp_rounds,
            kpp_schedule=kpp_schedule, device=dev, assume_symmetric=True,
            mesh=mesh)
    print(f"[codebook] K-medoids: K={len(medoids)}, qe={qe:.6f} "
          f"({timings_s['kmedoids']:.3f}s)")

    assign_flat = np.full(z_flat.shape[0], -1, dtype=np.int32)
    assign_flat[mask_lcc] = assign_lcc
    codes = assign_flat.reshape(n, h, w)
    z_medoid = z_lcc[medoids]

    config_record = {
        "latents_path": str(cfg["latents_path"]),
        "out_dir": str(out_dir),
        "vae_ckpt_path": str(cfg["vae_ckpt_path"]),
        "k": k, "sym": sym, "K": K, "init": init, "seed": seed,
        "kpp_rounds": kpp_rounds, "kpp_schedule": kpp_schedule,
        "batch_size": batch_size,
        **{f"vae_{kk}": (list(v) if isinstance(v, tuple) else v)
           for kk, v in vae_cfg.items()},
        "device": str(dev),
        "world_size": mesh.world_size,
        "quantization_error": qe,
        "lcc_nodes": int(mask_lcc.sum()),
        "timings_s": {**timings_s, "total": time.perf_counter() - t_start},
    }
    if is_primary():
        with span("vqvae.codebook.artifacts"):
            save_codebook_artifacts(out_dir, medoids, z_medoid, codes,
                                    config_record)
    barrier(mesh)  # rank 0's writes are done before any rank goes on
    print(f"[codebook] Quantization error: {qe:.6f}")
    print(f"[codebook] Saved artifacts to: {out_dir} "
          f"(total {time.perf_counter() - t_start:.3f}s)")
    return out_dir


def save_codebook_artifacts(out_dir: Path, medoids: np.ndarray,
                            z_medoid: np.ndarray, codes: np.ndarray,
                            config_record: dict) -> None:
    np.savez_compressed(
        out_dir / "codebook.npz",
        medoid_indices=medoids.astype(np.int32),
        z_medoid=z_medoid.astype(np.float32),
        config_json=np.bytes_(json.dumps(config_record).encode()))
    np.save(out_dir / "codes.npy", codes)
    torch.save({
        "medoid_indices": torch.from_numpy(medoids.astype(np.int64)),
        "z_medoid": torch.from_numpy(z_medoid.astype(np.float32)),
        "config": config_record,
    }, out_dir / "codebook.pt")


def load_codebook(path: str | Path) -> dict:
    """Load a codebook from codebook.npz or codebook.pt (either package's,
    or the reference's)."""
    path = Path(path)
    if path.is_dir():
        path = path / ("codebook.npz" if (path / "codebook.npz").exists()
                       else "codebook.pt")
    if path.suffix == ".npz":
        with np.load(path) as f:
            return {
                "medoid_indices": f["medoid_indices"],
                "z_medoid": f["z_medoid"],
                "config": json.loads(bytes(f["config_json"]).decode()),
            }
    d = torch.load(path, map_location="cpu", weights_only=False)
    return {
        "medoid_indices": np.asarray(d["medoid_indices"]),
        "z_medoid": np.asarray(d["z_medoid"].float()),
        "config": d.get("config", {}),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Build a geodesic spatial codebook (PyTorch port).")
    parser.add_argument("--config", required=True,
                        help="codebook stage YAML (e.g. configs/fashionmnist/"
                             "spatial/geodesic/codebook.yaml)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    build_codebook_main(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
