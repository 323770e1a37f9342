"""Quality-gate evaluators: VAE quality, quantization loss, codebook health —
the port of ``vqvae_tpu/cli/quality_checks.py``, with the same metric
definitions, tier thresholds and JSON outputs:

- ``evaluate_vae_quality_main`` — decode z and mu of the val latents,
  PSNR/SSIM of x(z) vs x(mu); tiers >20 excellent / >15 good / >10
  acceptable / else poor -> RETRAIN (exit code 1), capped at poor when the
  posterior collapsed (max per-dim var(mu) < 1e-2).
- ``evaluate_quantization_loss_main`` — real vs continuous vs quantized
  reconstructions, six PSNR/SSIM pairs, EXCELLENT/GOOD/MODERATE/HIGH on
  continuous-vs-quantized PSNR.
- ``evaluate_codebook_health_main`` — entropy/used/dead of the val
  nearest-medoid codes and continuous-vs-quantized PSNR/SSIM; EXCELLENT
  needs entropy > 4.5 and usage > 80 %.

The VAE is read from ``<experiment>/vae/**/checkpoints/best.pt`` with its
architecture detected from the weights. Decoding runs on the device in
batches; the nearest-medoid assignment is kernel K3 (``ops/assign.py``).

Run all three: ``python -m vqvae_tpu_torch.cli.quality_checks --config
<quality.yaml> [--device cpu]`` (or ``--experiment <dir> --dataset <ds>``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import load_config
from ..data.datasets import load_dataset
from ..device import resolve_device
from ..eval.metrics import codebook_stats, psnr_np, ssim_simple_np
from ..models.vae import VAE
from ..ops.assign import nearest_codes
from ..utils.checkpoint import load_vae_from_checkpoint
from ..utils.images import unnormalize_images
from ..utils.latents import load_latents
from .build_codebook import load_codebook


def nearest_medoid_assign(z: np.ndarray, z_medoid: np.ndarray,
                          device=None) -> np.ndarray:
    """Index (N,) int64 of the nearest medoid for each row of ``z`` (kernel
    K3 on CUDA, its plain version on the CPU)."""
    idx, _ = nearest_codes(np.asarray(z, np.float32),
                           np.asarray(z_medoid, np.float32), device=device)
    return idx.cpu().numpy()


@torch.no_grad()
def _decode_sweep(model: VAE, z: np.ndarray, dataset_name: str,
                  batch_size: int = 512) -> np.ndarray:
    dev = next(model.parameters()).device
    outs = []
    for i in range(0, len(z), batch_size):
        zb = torch.from_numpy(np.asarray(z[i:i + batch_size], np.float32))
        logits = model.decode(zb.to(dev)).cpu().numpy()
        outs.append(unnormalize_images(logits, dataset_name,
                                       model.apply_sigmoid))
    return np.concatenate(outs)


def _load_vae(experiment_dir: Path, device) -> Tuple[VAE, Path]:
    ckpt_dir = experiment_dir / "vae" / "checkpoints"
    if not ckpt_dir.exists():  # spatial slug layout
        hits = sorted((experiment_dir / "vae").glob("*/checkpoints"))
        if not hits:
            raise FileNotFoundError(
                f"no checkpoints under {experiment_dir / 'vae'}")
        ckpt_dir = hits[0]
    model = load_vae_from_checkpoint(ckpt_dir / "best.pt", None,
                                     device=device)
    return model, ckpt_dir.parent


def assess_quality(psnr_value: float, ssim_value: float) -> Tuple[str, bool]:
    if psnr_value > 20:
        return "excellent", True
    if psnr_value > 15:
        return "good", True
    if psnr_value > 10:
        return "acceptable", True
    return "poor", False


def evaluate_vae_quality_main(experiment: str | Path,
                              dataset: str = "fashionmnist",
                              max_samples: int = 1000,
                              batch_size: int = 512, device=None) -> int:
    dev = resolve_device(device)
    experiment_dir = Path(experiment)
    model, vae_dir = _load_vae(experiment_dir, dev)
    lat = load_latents(vae_dir / "latents_val")
    z, mu = lat["z"][:max_samples], lat["mu"][:max_samples]

    x_from_z = _decode_sweep(model, z, dataset, batch_size)
    x_from_mu = _decode_sweep(model, mu, dataset, batch_size)

    p = psnr_np(x_from_z, x_from_mu)
    s = ssim_simple_np(x_from_z, x_from_mu)
    quality, proceed = assess_quality(p, s)

    # Posterior-collapse detector: x(z) vs x(mu) measures latent-noise
    # sensitivity, so a decoder that ignores its latent scores a perfect
    # PSNR. A collapsed posterior has mu carrying no information: per-dim
    # variance of mu across samples ~ 0 everywhere.
    mu_flat = np.asarray(mu, np.float32).reshape(len(mu), -1)
    mu_var_max = float(mu_flat.var(axis=0).max()) if len(mu_flat) > 1 else 1.0
    collapsed = mu_var_max < 1e-2
    if collapsed:
        print(f"WARNING: posterior collapse suspected — max per-dim var(mu) "
              f"= {mu_var_max:.2e} (< 1e-2). The {p:.0f} dB x(z)-vs-x(mu) "
              f"PSNR only means the decoder ignores z; downstream geodesic "
              f"geometry will be vacuous. Rating capped at POOR.")
        quality, proceed = "poor", False

    print(f"PSNR: {p:.2f} dB, SSIM: {s:.4f}")
    print(f"Quality: {quality.upper()}")
    print(f"Recommendation: {'PROCEED' if proceed else 'RETRAIN'}")

    results = {
        "dataset": dataset, "psnr_db": float(p), "ssim": float(s),
        "quality_rating": quality,
        "recommendation": "proceed" if proceed else "retrain",
        "samples_evaluated": int(len(x_from_mu)),
        "mu_variance_max": mu_var_max,
        "posterior_collapse_suspected": bool(collapsed),
    }
    out = vae_dir / "vae_quality_assessment.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"Results saved to {out}")
    return 0 if proceed else 1


def _quantize(z_val: np.ndarray, z_medoid: np.ndarray, device
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, quantized latents): flat latents per row, spatial ones per
    grid cell."""
    if z_val.ndim == 2:
        codes = nearest_medoid_assign(z_val, z_medoid, device)
        return codes, z_medoid[codes]
    codes = nearest_medoid_assign(z_val.reshape(-1, z_val.shape[-1]),
                                  z_medoid, device)
    return codes, z_medoid[codes].reshape(z_val.shape)


def evaluate_quantization_loss_main(experiment: str | Path,
                                    dataset: str = "fashionmnist",
                                    batch_size: int = 512,
                                    max_samples: int = 1000,
                                    synthetic_size: Optional[int] = None,
                                    device=None) -> int:
    dev = resolve_device(device)
    experiment_dir = Path(experiment)
    model, vae_dir = _load_vae(experiment_dir, dev)
    lat = load_latents(vae_dir / "latents_val")
    z_val = lat["z"][:max_samples]

    cb = load_codebook(experiment_dir / "codebook")
    z_medoid = cb["z_medoid"].astype(np.float32)
    _, zq_val = _quantize(z_val, z_medoid, dev)

    split = load_dataset(dataset, train=False, synthetic_size=synthetic_size)
    x_real = split.denormalize(split.images[:len(z_val)])
    if x_real.shape[-1] != model.in_channels:
        if model.in_channels == 1:
            x_real = x_real.mean(-1, keepdims=True)
        else:
            x_real = np.repeat(x_real, 3, axis=-1)

    x_cont = _decode_sweep(model, z_val, dataset, batch_size)
    x_quant = _decode_sweep(model, zq_val, dataset, batch_size)
    n = min(len(x_real), len(x_cont))
    x_real, x_cont, x_quant = x_real[:n], x_cont[:n], x_quant[:n]

    metrics = {
        "dataset": dataset, "samples_evaluated": int(n),
        "codebook_size": int(z_medoid.shape[0]),
        "psnr_real_vs_continuous": round(psnr_np(x_real, x_cont), 6),
        "psnr_real_vs_quantized": round(psnr_np(x_real, x_quant), 6),
        "psnr_continuous_vs_quantized": round(psnr_np(x_cont, x_quant), 6),
        "ssim_real_vs_continuous": round(ssim_simple_np(x_real, x_cont), 6),
        "ssim_real_vs_quantized": round(ssim_simple_np(x_real, x_quant), 6),
        "ssim_continuous_vs_quantized": round(
            ssim_simple_np(x_cont, x_quant), 6),
    }
    cq = metrics["psnr_continuous_vs_quantized"]
    assessment = ("EXCELLENT" if cq > 25 else "GOOD" if cq > 20
                  else "MODERATE" if cq > 15 else "HIGH")
    print(f"Real vs Continuous: PSNR "
          f"{metrics['psnr_real_vs_continuous']:.2f} dB")
    print(f"Continuous vs Quantized: PSNR {cq:.2f} dB")
    print(f"Quantization loss: {assessment}")

    out_dir = experiment_dir / "evaluation"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "quantization_analysis.json", "w") as f:
        json.dump(metrics, f, indent=2)
    print(f"Results saved to {out_dir}/quantization_analysis.json")
    return 0


def evaluate_codebook_health_main(experiment: str | Path,
                                  dataset: str = "fashionmnist",
                                  batch_size: int = 512, device=None) -> int:
    dev = resolve_device(device)
    experiment_dir = Path(experiment)
    model, vae_dir = _load_vae(experiment_dir, dev)
    lat = load_latents(vae_dir / "latents_val")
    z_val = lat["z"]

    cb = load_codebook(experiment_dir / "codebook")
    z_medoid = cb["z_medoid"].astype(np.float32)
    codes, zq_val = _quantize(z_val, z_medoid, dev)

    x_cont = _decode_sweep(model, z_val, dataset, batch_size)
    x_quant = _decode_sweep(model, zq_val, dataset, batch_size)

    p = psnr_np(x_cont, x_quant)
    s = ssim_simple_np(x_cont, x_quant)
    stats = codebook_stats(codes, K=z_medoid.shape[0])
    usage_percent = 100 * stats["used"] / z_medoid.shape[0]
    health = ("EXCELLENT" if stats["entropy"] > 4.5 and usage_percent > 80
              else "GOOD" if stats["entropy"] > 3.5 and usage_percent > 60
              else "MODERATE" if stats["entropy"] > 2.5
              and usage_percent > 40
              else "POOR")
    print(f"PSNR: {p:.2f} dB, SSIM: {s:.4f}")
    print(f"Entropy: {stats['entropy']:.3f}, Usage: {usage_percent:.1f}%")
    print(f"Health: {health}")

    out_dir = experiment_dir / "evaluation"
    out_dir.mkdir(parents=True, exist_ok=True)
    results = {
        "dataset": dataset, "samples_evaluated": int(len(x_cont)),
        "codebook_size": int(z_medoid.shape[0]),
        "psnr_continuous_vs_quantized": round(float(p), 6),
        "ssim_continuous_vs_quantized": round(float(s), 6),
        "entropy": round(stats["entropy"], 6),
        "used_codes": stats["used"],
        "dead_codes": stats["dead_codes"],
        "usage_percent": round(usage_percent, 2),
        "health_assessment": health,
    }
    with open(out_dir / "codebook_health.json", "w") as f:
        json.dump(results, f, indent=2)
    print(f"Results saved to {out_dir}/codebook_health.json")
    return 0


def run_quality_stage(experiment: str | Path, dataset: str = "fashionmnist",
                      synthetic_size: Optional[int] = None,
                      device=None) -> int:
    """The pipeline's quality stage: the three evaluators in turn; returns
    the VAE gate's exit code (1 recommends retraining)."""
    rc = evaluate_vae_quality_main(experiment, dataset=dataset,
                                   device=device)
    evaluate_quantization_loss_main(experiment, dataset=dataset,
                                    synthetic_size=synthetic_size,
                                    device=device)
    evaluate_codebook_health_main(experiment, dataset=dataset, device=device)
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run the three quality evaluators (PyTorch port).")
    parser.add_argument("--config", help="quality stage YAML (experiment, "
                        "dataset, synthetic_size)")
    parser.add_argument("--experiment", help="experiment directory")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config) if args.config else {}
    experiment = args.experiment or cfg.get("experiment")
    if experiment is None:
        parser.error("give --config or --experiment")
    return run_quality_stage(
        experiment, dataset=args.dataset or cfg.get("dataset",
                                                    "fashionmnist"),
        synthetic_size=cfg.get("synthetic_size"), device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
