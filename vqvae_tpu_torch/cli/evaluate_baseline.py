"""Evaluate the EMA VQ-VAE baseline in the pipeline's format — the port
of ``scripts/evaluate_baseline_simple.py``.

From ``<out_dir>/checkpoints/best.pt``: reconstruction PSNR and SSIM
over the first ``max_samples`` validation images, codebook statistics
(entropy, used and dead codes) and the perplexity of their codes, an 8x8
grid decoded from uniformly random codes, and LPIPS when its weights are
found (null otherwise, with the reason printed). Writes the three files
``evaluation_results.json``, ``metrics.yaml`` and ``codebook_health.json``
under ``<out_dir>/evaluation``, with the JAX script's keys and health
thresholds. The random codes come from a ``torch.Generator`` seeded with
the config's ``seed``: another stream than JAX's.

Run: ``python -m vqvae_tpu_torch.cli.evaluate_baseline [--config <yaml>]
[--ckpt_dir DIR] [--out_dir DIR] [--max_samples N] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from ..config import Config, load_config
from ..device import resolve_device
from ..eval.lpips import lpips_distance
from ..eval.metrics import codebook_stats, psnr_np, ssim_simple_np
from ..models.vqvae_baseline import quantize
from ..utils.checkpoint import load_baseline_checkpoint
from ..utils.images import save_image_grid
from .train_baseline_vqvae import DEFAULT_CONFIG, baseline_split_loader


def health_assessment(entropy: float, usage_percent: float) -> str:
    if entropy > 4.5 and usage_percent > 80:
        return "EXCELLENT"
    if entropy > 3.5 and usage_percent > 60:
        return "GOOD"
    if entropy > 2.5 and usage_percent > 40:
        return "MODERATE"
    return "POOR"


@torch.no_grad()
def evaluate_baseline_main(cfg: Config, ckpt_dir: Optional[str] = None,
                           out_dir: Optional[str] = None,
                           max_samples: int = 1000, device=None) -> dict:
    """Evaluate the baseline of ``cfg`` on ``device`` (default the GPU;
    raises when CUDA is absent and no device is given); returns the
    ``evaluation_results.json`` record."""
    dev = resolve_device(device)
    base = Path(out_dir or cfg.get("out_dir", "experiments/baseline_vqvae"))
    ckpt = Path(ckpt_dir or (base / "checkpoints"))
    eval_dir = base / "evaluation"
    eval_dir.mkdir(parents=True, exist_ok=True)
    model, cb = load_baseline_checkpoint(ckpt, cfg["model"], device=dev)
    n_codes = cb.embed.shape[0]
    val_loader = baseline_split_loader(cfg, 128, train=False)

    xs, recs, codes = [], [], []
    seen = 0
    for images, _, mask in val_loader.epoch(0):
        x01 = val_loader.split.denormalize(images).astype(np.float32)
        x = torch.from_numpy(x01 * 2.0 - 1.0).to(dev)
        z_q, idx = quantize(cb, model.encode(x))
        x_rec = model.decode(z_q)
        valid = mask > 0
        xs.append(x01[valid])
        recs.append((x_rec.cpu().numpy()[valid] + 1.0) / 2.0)
        codes.append(idx.cpu().numpy()[valid])
        seen += int(valid.sum())
        if seen >= max_samples:
            break
    x_real = np.concatenate(xs)[:max_samples]
    x_rec = np.clip(np.concatenate(recs)[:max_samples], 0, 1)
    codes = np.concatenate(codes)[:max_samples]

    p = psnr_np(x_real, x_rec)
    s = ssim_simple_np(x_real, x_rec)
    stats = codebook_stats(codes, K=n_codes)
    hist = np.bincount(codes.reshape(-1), minlength=n_codes).astype(
        np.float64)
    pr = hist / max(hist.sum(), 1.0)
    perplexity = float(np.exp(-(pr * np.log(pr + 1e-12)).sum()))

    # decode uniformly random codes (an 8 x 8 grid)
    h = w = int(cfg["data"].get("img_size", 32)) // 4
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 42)))
    rand_idx = torch.randint(0, n_codes, (64 * h * w,), generator=gen)
    z_q = cb.embed[rand_idx.to(dev)].reshape(64, h, w, -1)
    gen01 = (model.decode(z_q).cpu().numpy() + 1.0) / 2.0
    save_image_grid(gen01, eval_dir / "generated_samples.png", nrow=8)

    def to3(v):
        return np.repeat(v, 3, -1) if v.shape[-1] == 1 else v

    try:
        lpips_val = lpips_distance(to3(x_rec[:256]), to3(x_real[:256]),
                                   device=dev)
    except FileNotFoundError as err:
        print(f"[evaluate-baseline] LPIPS: null — {err}")
        lpips_val = None

    results = {
        "recon_psnr": round(p, 4), "recon_ssim": round(s, 4),
        "lpips": round(lpips_val, 4) if lpips_val is not None else None,
        "entropy": round(stats["entropy"], 4),
        "used_codes": stats["used"], "dead_codes": stats["dead_codes"],
        "perplexity": round(perplexity, 2),
        "codebook_size": int(n_codes),
        "samples_evaluated": int(len(x_real)),
    }
    with open(eval_dir / "evaluation_results.json", "w") as f:
        json.dump(results, f, indent=2)
    with open(eval_dir / "metrics.yaml", "w") as f:
        yaml.safe_dump({"PSNR": f"{p:.4f}", "SSIM": f"{s:.4f}",
                        "LPIPS": (f"{lpips_val:.4f}" if lpips_val is not None
                                  else None)}, f)
    usage_percent = 100 * stats["used"] / n_codes
    health = health_assessment(stats["entropy"], usage_percent)
    with open(eval_dir / "codebook_health.json", "w") as f:
        json.dump({"entropy": stats["entropy"], "used_codes": stats["used"],
                   "dead_codes": stats["dead_codes"],
                   "usage_percent": usage_percent,
                   "health_assessment": health}, f, indent=2)
    print(f"PSNR {p:.2f} dB, SSIM {s:.4f}, entropy {stats['entropy']:.3f}, "
          f"usage {usage_percent:.1f}% -> {health}")
    print(f"Results saved to {eval_dir}")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Evaluate the EMA VQ-VAE baseline (PyTorch port).")
    ap.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    ap.add_argument("--ckpt_dir", type=str, default=None)
    ap.add_argument("--out_dir", type=str, default=None)
    ap.add_argument("--max_samples", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return evaluate_baseline_main(load_config(args.config),
                                  ckpt_dir=args.ckpt_dir,
                                  out_dir=args.out_dir,
                                  max_samples=args.max_samples,
                                  device=args.device)


if __name__ == "__main__":
    main()
