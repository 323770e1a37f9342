"""Riemannian-vs-Euclidean edge-length sanity check.

The port of ``experiments_geo/riemann_sanity_check.py``: on random latent
edges (numpy ``default_rng(seed)``, the JAX script's draws) through a
seeded flat VAE decoder (latent ``--latent_dim``, decoder 128/64/32, no
norm, mse), compare Euclidean edge lengths with decoder-pullback
Riemannian lengths (``ops.edge_lengths_riemannian``): the pullback metric
should stretch edges non-uniformly (ratio spread > 0) while staying
positively correlated with the Euclidean length. The decoder's weights
are drawn with flax's default distributions from a torch generator seeded
with ``seed`` (the JAX script draws its own from ``jax.random.key``), or
given as ``model``.

Run: ``python -m vqvae_tpu_torch.experiments_geo.riemann_sanity_check
[--n_edges 2000] [--latent_dim 16] [--seed 0] [--device cpu]``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models.vae import VAE, flax_init_
from ..ops import edge_lengths_riemannian
from ..ops.riemannian import make_decoder_image_fn


def run(n_edges: int = 2000, latent_dim: int = 16, seed: int = 0,
        device=None, model=None) -> dict:
    """Lengths and their statistics on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if model is None:  # flax-style weights, drawn on the CPU
        model = flax_init_(
            VAE(in_channels=1, latent_dim=latent_dim, topology="flat",
                output_image_size=28, norm_type="none", recon_loss="mse",
                enc_channels=(32, 64, 128), dec_channels=(128, 64, 32)),
            torch.Generator().manual_seed(seed))
    decode_fn = make_decoder_image_fn(model.to(dev), "flat")

    za = rng.normal(size=(n_edges, latent_dim)).astype(np.float32)
    zb = za + rng.normal(scale=0.1, size=za.shape).astype(np.float32)
    eu = np.linalg.norm(zb - za, axis=1)
    riem = edge_lengths_riemannian(decode_fn, za, zb, batch_size=512,
                                   device=dev)
    if (riem < 0).any():
        raise RuntimeError("negative Riemannian edge lengths")

    ratio = riem / np.maximum(eu, 1e-12)
    corr = float(np.corrcoef(eu, riem)[0, 1])
    ok = corr > 0 and ratio.std() > 1e-6
    print(f"edges={n_edges}")
    print(f"euclidean: mean={eu.mean():.4f}")
    print(f"riemannian: mean={riem.mean():.4f}")
    print(f"ratio: mean={ratio.mean():.4f} std={ratio.std():.4f} "
          f"min={ratio.min():.4f} max={ratio.max():.4f}")
    print(f"pearson corr(euclidean, riemannian) = {corr:.4f}")
    print("sanity: OK" if ok else
          "sanity: SUSPICIOUS (metric looks degenerate)")
    return {"euclidean": eu, "riemannian": riem, "corr": corr,
            "ratio_mean": float(ratio.mean()),
            "ratio_std": float(ratio.std()), "ok": bool(ok)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_edges", type=int, default=2000)
    ap.add_argument("--latent_dim", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(n_edges=args.n_edges, latent_dim=args.latent_dim,
               seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
