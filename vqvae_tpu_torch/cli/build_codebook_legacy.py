"""Legacy flat-latent codebook builders (Euclidean and Riemannian) — the
port of ``vqvae_tpu/cli/build_codebook_legacy.py``.

Flat latents (z or mu, (N, D)) -> kNN graph per ``graph:`` (the exact
route, distance weights by default) -> LCC -> graph K-medoids -> codes
(N,) with -1 off the LCC. Writes ``knn_graph.npz`` (the whole graph),
then ``codebook.npz``, ``codebook.pt`` and ``codes.npy`` as the spatial
builder does.

With ``riemannian=True`` the LCC's edges are re-weighted first by decoder
JVP lengths: ``full`` mode measures every edge; ``subset`` mode measures a
stratified sample of ``max_edges`` (an equal share per decile of the
Euclidean length, drawn with numpy ``default_rng(seed)``, so both packages
pick the same edges) and keeps the rest Euclidean. A non-finite length
keeps the Euclidean weight, and the result is symmetrised by ``maximum``.
The re-weighted LCC graph is also written as ``knn_graph_riemannian.npz``.

Run: ``python -m vqvae_tpu_torch.cli.build_codebook_legacy --config
<yaml> [--riemannian] [--device cpu]`` (the preset's ``builder:`` key
selects the mode inside ``run_pipeline``).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
from scipy import sparse

from ..config import Config, load_config
from ..device import resolve_device
from ..ops.graph import build_knn_graph_auto, largest_connected_component
from ..ops.kmedoids import fit_kmedoids
from ..ops.riemannian import edge_lengths_riemannian, make_decoder_image_fn
from ..utils.checkpoint import load_vae_from_checkpoint
from ..utils.latents import load_latents
from .build_codebook import save_codebook_artifacts


def _load_flat_latents(cfg: Config) -> np.ndarray:
    """(N, D) float32 latents from ``latents_path`` (top level or under
    ``data:``); ``latents_key`` (or ``source``) picks z or mu, and a path
    ending in ``mu.pt`` / ``mu.npy`` forces mu."""
    path = cfg.get("latents_path") or cfg.get("data", Config({})).get(
        "latents_path")
    if path is None:
        raise KeyError("latents_path (top-level or under data:)")
    source = str(cfg.get("latents_key", cfg.get("source", "z")))
    p = str(path)
    if p.endswith("mu.pt") or p.endswith("mu.npy"):
        source = "mu"
    lat = load_latents(Path(p).parent if p.endswith(".pt") else p)
    z = lat.get(source, lat["z"])
    if z.ndim != 2:
        raise ValueError(
            f"legacy codebook build expects flat (N,D) latents, got {z.shape}")
    return np.asarray(z, np.float32)


def _reweight_graph_with_riemannian(W: sparse.csr_matrix, z: np.ndarray,
                                    decode_fn, mode: str = "subset",
                                    max_edges: int = 5000,
                                    batch_size: int = 512,
                                    seed: int = 42,
                                    device=None) -> sparse.csr_matrix:
    """Riemannian lengths on the upper triangle of ``W`` (all edges, or a
    decile-stratified ``subset`` of ``max_edges``), symmetrised by max."""
    coo = sparse.triu(W, k=1).tocoo()
    rows, cols, eu = coo.row, coo.col, coo.data
    n_edges = len(rows)
    if mode == "subset" and n_edges > max_edges:
        rng = np.random.default_rng(seed)
        qs = np.quantile(eu, np.linspace(0, 1, 11))
        sel_idx = []
        per_bin = max_edges // 10
        for b in range(10):
            in_bin = np.nonzero((eu >= qs[b]) & (eu <= qs[b + 1]))[0]
            if in_bin.size:
                take = min(per_bin, in_bin.size)
                sel_idx.append(rng.choice(in_bin, size=take, replace=False))
        sel = np.unique(np.concatenate(sel_idx))
    else:
        sel = np.arange(n_edges)

    lengths = edge_lengths_riemannian(decode_fn, z[rows[sel]], z[cols[sel]],
                                      batch_size=batch_size, device=device)
    new_w = eu.astype(np.float32).copy()
    finite = np.isfinite(lengths)
    new_w[sel[finite]] = lengths[finite]

    W_new = sparse.csr_matrix((new_w, (rows, cols)), shape=W.shape)
    return W_new.maximum(W_new.T)


def _load_decoder(cfg: Config, device):
    """The VAE named by ``vae_ckpt_path`` (or ``vae.ckpt_path``), its
    architecture from ``model:`` or ``vae:``, as a decode function."""
    vae_cfg = dict(cfg.get("model") or cfg.get("vae") or {})
    ckpt_path = (cfg.get("vae_ckpt_path")
                 or cfg.get("vae", Config({})).get("ckpt_path"))
    if ckpt_path is None:
        raise KeyError("vae_ckpt_path (top-level or vae.ckpt_path)")
    vae_cfg.pop("ckpt_path", None)
    vae_cfg.setdefault("topology", "flat")
    vae_cfg.setdefault("recon_loss", "mse")
    vae_cfg["mse_use_sigmoid"] = bool(vae_cfg.get("mse_use_sigmoid", True))
    model = load_vae_from_checkpoint(str(ckpt_path), vae_cfg, device=device)
    return make_decoder_image_fn(model, model.topology)


def build_codebook_legacy_main(cfg: Config, riemannian: bool = False,
                               device=None) -> Path:
    """Run the legacy builder for ``cfg`` on ``device`` (default the GPU;
    raises when CUDA is absent and no device is given). ``out_dir`` may sit
    at the top level or at ``out.dir``."""
    dev = resolve_device(device)
    out = cfg.get("out_dir") or cfg.get("out", Config({})).get("dir")
    if out is None:
        raise KeyError("out_dir (top-level or out.dir)")
    out_dir = Path(str(out))
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    z = _load_flat_latents(cfg)
    print(f"[codebook-legacy] latents: {z.shape} (device {dev})")

    graph_cfg = cfg.get("graph", Config({}))
    k = int(graph_cfg.get("k", 20))
    metric = str(graph_cfg.get("metric", "euclidean"))
    sym = str(graph_cfg.get("sym", "union"))
    mode = str(graph_cfg.get("mode", "distance"))
    W, _ = build_knn_graph_auto(z, k=k, metric=metric, mode=mode, sym=sym,
                                device=dev)
    t_knn = time.perf_counter() - t0
    print(f"[codebook-legacy] graph: {W.shape[0]} nodes, {W.nnz} edges "
          f"({t_knn:.3f}s)")
    sparse.save_npz(out_dir / "knn_graph.npz", W.tocsr())

    mask_lcc = largest_connected_component(W)
    W_lcc = W[mask_lcc][:, mask_lcc] if mask_lcc.sum() < W.shape[0] else W
    z_lcc = z[mask_lcc]

    t_riem = 0.0
    if riemannian:
        t1 = time.perf_counter()
        decode_fn = _load_decoder(cfg, dev)
        riem_cfg = cfg.get("riemannian", Config({}))
        W_lcc = _reweight_graph_with_riemannian(
            W_lcc, z_lcc, decode_fn,
            mode=str(riem_cfg.get("mode", "subset")),
            max_edges=int(riem_cfg.get("max_edges", 5000)),
            batch_size=int(riem_cfg.get("batch_size", 512)),
            seed=int(cfg.get("seed", 42)), device=dev)
        sparse.save_npz(out_dir / "knn_graph_riemannian.npz", W_lcc.tocsr())
        t_riem = time.perf_counter() - t1
        print(f"[codebook-legacy] Riemannian re-weighted graph saved "
              f"({t_riem:.3f}s)")

    quant_cfg = cfg.get("quantize", Config({}))
    K = int(quant_cfg.get("K", 512))
    init = str(quant_cfg.get("init", "kpp"))
    seed = int(quant_cfg.get("seed", cfg.get("seed", 42)))
    t1 = time.perf_counter()
    medoids, assign_lcc, qe = fit_kmedoids(W_lcc, K=K, init=init, seed=seed,
                                           device=dev)
    t_kmed = time.perf_counter() - t1

    codes = np.full(z.shape[0], -1, dtype=np.int32)
    codes[mask_lcc] = assign_lcc
    z_medoid = z_lcc[medoids]

    config_record = {"k": k, "metric": metric, "sym": sym, "mode": mode,
                     "K": K, "init": init, "seed": seed,
                     "riemannian": riemannian,
                     "total_s": round(time.perf_counter() - t0, 2),
                     "quantization_error": qe,
                     "lcc_nodes": int(mask_lcc.sum()),
                     "device": str(dev),
                     "timings_s": {"knn": t_knn, "riemannian": t_riem,
                                   "kmedoids": t_kmed,
                                   "total": time.perf_counter() - t0}}
    save_codebook_artifacts(out_dir, medoids, z_medoid, codes, config_record)
    print(f"[codebook-legacy] K={len(medoids)} qe={qe:.3f} "
          f"({time.perf_counter() - t0:.1f}s) -> {out_dir}")
    return out_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Build a legacy flat-latent codebook (PyTorch port).")
    parser.add_argument("--config", required=True,
                        help="codebook stage YAML (e.g. configs/fashionmnist/"
                             "vanilla/geodesic/codebook.yaml)")
    parser.add_argument("--riemannian", action="store_true",
                        help="re-weight the LCC's edges by decoder JVP "
                             "lengths (builder: legacy_riemannian)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    build_codebook_legacy_main(load_config(args.config),
                               riemannian=args.riemannian,
                               device=args.device)


if __name__ == "__main__":
    main()
