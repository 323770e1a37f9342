"""Codebook metrics of the EMA VQ-VAE baseline over one split — the port of
``scripts/eval_codebook_metrics.py``.

Runs the model from ``<out_dir>/checkpoints/best.pt`` over the train or
test split and reports loss, rec (L1), vq (commitment), q_mse, perplex,
usage and dead, plus the codebook's embedding-norm statistics; prints
each metric and appends one row to ``<out_dir>/codebook_eval_<split>.csv``
(header ``CSV_HEADER``). Per batch every metric is a sum over the valid
rows (the code histogram counts valid cells only); the batch sums stay on
the device, in float64, until the end.

Run: ``python -m vqvae_tpu_torch.cli.eval_codebook_metrics [--config
<yaml>] [--ckpt DIR] [--split train|test] [--batch_size N] [--device
cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..device import resolve_device
from ..models.vqvae_baseline import quantize
from ..utils.checkpoint import load_baseline_checkpoint
from .train_baseline_vqvae import DEFAULT_CONFIG, baseline_split_loader

CSV_HEADER = ["split", "loss", "rec", "vq", "q_mse", "perplex", "usage",
              "dead", "embed_norm_mean", "embed_norm_min", "embed_norm_max"]


@torch.no_grad()
def eval_codebook_metrics_main(cfg: Config, ckpt: Optional[str] = None,
                               split: str = "test",
                               batch_size: Optional[int] = None,
                               device=None) -> dict:
    """Metrics of the baseline of ``cfg`` over ``split`` on ``device``
    (default the GPU; raises when CUDA is absent and no device is given);
    appends the CSV row and returns the metrics."""
    dev = resolve_device(device)
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    base = Path(str(cfg.get("out_dir", "experiments/baseline_vqvae")))
    model, cb = load_baseline_checkpoint(
        Path(ckpt) if ckpt else base / "checkpoints", cfg["model"],
        device=dev)
    beta = float(cfg["model"].get("beta", 0.25))
    n_codes = cb.embed.shape[0]
    bs = batch_size or int(cfg["train"].get("batch_size", 128))
    loader = baseline_split_loader(cfg, bs, train=(split == "train"))

    totals = torch.zeros(5, dtype=torch.float64, device=dev)
    n_total = torch.zeros((), dtype=torch.float64, device=dev)
    for images, _, mask in loader.epoch(0):
        x01 = loader.split.denormalize(images).astype(np.float32)
        x = torch.from_numpy(x01 * 2.0 - 1.0).to(dev)
        w = torch.from_numpy(mask).to(dev)
        z_e = model.encode(x)
        z_q, idx = quantize(cb, z_e)
        x_rec = model.decode(z_q)
        n = w.sum()
        rec = (torch.abs(x_rec - x).mean(dim=(1, 2, 3)) * w).sum()
        sq = ((z_q - z_e) ** 2).mean(dim=(1, 2, 3))
        vq = beta * (sq * w).sum()
        q_mse = (sq * w).sum()
        weights = w[:, None, None].expand(idx.shape).reshape(-1)
        hist = torch.zeros(n_codes, device=dev).index_add_(
            0, idx.reshape(-1), weights)
        usage = (hist > 0).float().mean()
        p = hist / torch.clamp_min(hist.sum(), 1.0)
        perplex = torch.exp(-(p * torch.log(torch.clamp_min(p, 1e-12)))
                            .sum())
        totals += torch.stack([rec, vq, q_mse, perplex * n,
                               usage * n]).double()
        n_total += n.double()
    n_total = max(float(n_total), 1.0)
    rec, vq, q_mse, perplex, usage = (totals.cpu().numpy()
                                      / n_total).tolist()

    norms = torch.linalg.vector_norm(cb.embed, dim=1).cpu().numpy()
    metrics = {
        "loss": rec + vq, "rec": rec, "vq": vq, "q_mse": q_mse,
        "perplex": perplex, "usage": usage, "dead": 1.0 - usage,
        "embed_norm_mean": float(norms.mean()),
        "embed_norm_min": float(norms.min()),
        "embed_norm_max": float(norms.max()),
    }
    print(f"Split: {split}")
    for k, v in metrics.items():
        print(f"{k}: {v:.6f}")
    out_csv = base / f"codebook_eval_{split}.csv"
    base.mkdir(parents=True, exist_ok=True)
    write_header = not out_csv.is_file()
    with open(out_csv, "a") as f:
        if write_header:
            f.write(",".join(CSV_HEADER) + "\n")
        f.write(",".join([split] + [f"{metrics[k]}" for k in CSV_HEADER[1:]])
                + "\n")
    print(f"[eval] appended -> {out_csv}")
    return metrics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Codebook metrics of the EMA VQ-VAE baseline "
                    "(PyTorch port).")
    ap.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint dir (default <out_dir>/checkpoints)")
    ap.add_argument("--split", type=str, choices=["train", "test"],
                    default="test")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return eval_codebook_metrics_main(load_config(args.config),
                                      ckpt=args.ckpt, split=args.split,
                                      batch_size=args.batch_size,
                                      device=args.device)


if __name__ == "__main__":
    main()
