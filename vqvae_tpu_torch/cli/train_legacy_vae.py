"""Legacy-config VAE training: ``configs/vae.yaml`` (the architecture) and
``configs/data.yaml`` (the dataset) composed into one run.

The port of ``scripts/train_legacy_vae.py``: the same flags and the same
composed ``Config`` (seed 42, weight decay 1e-4, no early stop, latents
saved), trained through ``train_vae_main`` with the architecture's
topology (flat for ``configs/vae.yaml``: free bits and capacity
annealing). ``configs/data.yaml`` sets ``augment: true``, so the engine
takes its per-batch path with augmentation.

Run: ``python -m vqvae_tpu_torch.cli.train_legacy_vae [--vae-config
configs/vae.yaml] [--data-config configs/data.yaml] [--out-dir
experiments/vae_legacy] [--epochs 30] [--lr 3e-4] [--synthetic-size N]
[--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import yaml

from ..config import Config
from .train_vae import train_vae_main

REPO_ROOT = Path(__file__).resolve().parents[2]


def compose_config(vae_config, data_config, out_dir: str, epochs: int,
                   lr: float, synthetic_size: Optional[int] = None
                   ) -> Config:
    """The composed training config, as JAX's script builds it."""
    with open(vae_config) as f:
        model_cfg = yaml.safe_load(f)
    with open(data_config) as f:
        data_cfg = yaml.safe_load(f)
    if synthetic_size:
        data_cfg["synthetic_size"] = synthetic_size
    return Config({
        "seed": 42,
        "max_epochs": epochs,
        "lr": lr,
        "weight_decay": 1e-4,
        "early_stop": 0,
        "out_dir": out_dir,
        "save_latents": True,
        "data": data_cfg,
        "model": model_cfg,
    })


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vae-config", type=str,
                        default=str(REPO_ROOT / "configs" / "vae.yaml"))
    parser.add_argument("--data-config", type=str,
                        default=str(REPO_ROOT / "configs" / "data.yaml"))
    parser.add_argument("--out-dir", type=str,
                        default="experiments/vae_legacy")
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--synthetic-size", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    cfg = compose_config(args.vae_config, args.data_config, args.out_dir,
                         args.epochs, args.lr, args.synthetic_size)
    return train_vae_main(cfg, topology=cfg["model"].get("topology", "flat"),
                          device=args.device)


if __name__ == "__main__":
    main()
