"""Posterior-collapse probe for the CIFAR-10 spatial recipe.

The port of ``tools/check_cifar_collapse.py``: train the preset's VAE
(``configs/cifar10/spatial/geodesic/vae.yaml``, its widths and loss path)
on ``size`` synthetic CIFAR-10 images for ``epochs`` epochs, then report
the collapse diagnostics: the per-dimension std of the training latents
(every spatial cell a row) and the decoder-Jacobian scale, the Riemannian
length of 2,048 perturbed pairs (numpy ``default_rng(0)`` picks the cells
and draws the perturbation at the latents' mean std, as JAX), through the
endpoint form ``edge_lengths_riemannian``. ``collapsed`` is a mean std
under 1e-3 or a mean length under 1e-6.

``train_probe`` is the step shared with ``tools/ab_cifar_freebits``.

Run: ``python -m vqvae_tpu_torch.tools.check_cifar_collapse [--size 4096]
[--epochs 30] [--preset configs/cifar10/spatial/geodesic]
[--out_dir experiments/_cifar_collapse_probe] [--device cpu]``; prints
one JSON line.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..cli.train_vae import train_vae_main
from ..config import Config, load_config
from ..device import resolve_device
from ..ops import edge_lengths_riemannian
from ..ops.riemannian import make_decoder_image_fn
from ..utils.checkpoint import load_vae_from_checkpoint
from ..utils.latents import load_latents

PRESET = "configs/cifar10/spatial/geodesic"
VAE_KEYS = ("in_channels", "output_image_size", "latent_dim",
            "enc_channels", "dec_channels", "norm_type", "topology")


def train_probe(preset, size: int, epochs: int, out_dir,
                model: Optional[Mapping] = None,
                data: Optional[Mapping] = None,
                device=None) -> Tuple[Path, Config]:
    """Train the preset's VAE on ``size`` synthetic images for ``epochs``
    epochs (no early stop, the cosine schedule over them) into
    ``out_dir``, with ``model`` / ``data`` merged into its sections.
    Returns the run directory and the config."""
    overrides = {"max_epochs": epochs, "early_stop": 0,
                 "scheduler": {"t_max": epochs}, "out_dir": str(out_dir),
                 "data": {"synthetic_size": size, **(data or {})},
                 "model": dict(model or {})}
    cfg = load_config(Path(preset) / "vae.yaml", overrides)
    return train_vae_main(cfg, device=device), cfg


def load_probe_vae(run_dir, cfg: Config, device=None):
    """The run's best VAE with the config's architecture, in eval mode."""
    model_cfg = cfg["model"]
    vae_cfg = {k: model_cfg[k] for k in VAE_KEYS}
    vae_cfg["recon_loss"] = model_cfg.get("recon_loss", "mse")
    vae_cfg["mse_use_sigmoid"] = bool(model_cfg.get("mse_use_sigmoid", True))
    return load_vae_from_checkpoint(Path(run_dir) / "checkpoints" / "best",
                                    vae_cfg, device=device)


def cells(run_dir, key: str = "z") -> np.ndarray:
    """The training latents ``key`` as (cells, D) float32."""
    lat = load_latents(Path(run_dir) / "latents_train")[key]
    return lat.reshape(-1, lat.shape[-1]).astype(np.float32)


def measure(run_dir, cfg: Config, pairs: int = 2048,
            batch_size: int = 512, device=None) -> Dict:
    """The collapse diagnostics of a trained run (see the module notes)."""
    dev = resolve_device(device)
    z = cells(run_dir)
    per_dim_std = z.std(axis=0)
    decode_fn = make_decoder_image_fn(load_probe_vae(run_dir, cfg, dev),
                                      "spatial")
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(z), size=pairs)
    za = z[idx]
    zb = za + rng.normal(0, per_dim_std.mean() + 1e-8,
                         size=za.shape).astype(np.float32)
    lengths = edge_lengths_riemannian(decode_fn, za, zb,
                                      batch_size=batch_size, device=dev)
    return {
        "latent_std_mean": float(per_dim_std.mean()),
        "latent_std_min": float(per_dim_std.min()),
        "riem_length_mean": float(lengths.mean()),
        "riem_length_p90": float(np.quantile(lengths, 0.9)),
        "collapsed": bool(per_dim_std.mean() < 1e-3
                          or lengths.mean() < 1e-6),
    }


def run(preset=PRESET, size: int = 4096, epochs: int = 30,
        out_dir="experiments/_cifar_collapse_probe", device=None) -> Dict:
    """Train at the preset's widths on ``device`` (default the GPU), then
    ``measure``."""
    dev = resolve_device(device)
    run_dir, cfg = train_probe(preset, size, epochs, out_dir, device=dev)
    return measure(run_dir, cfg, device=dev)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--preset", default=PRESET)
    ap.add_argument("--out_dir", default="experiments/_cifar_collapse_probe")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = run(args.preset, args.size, args.epochs, args.out_dir,
              device=args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
