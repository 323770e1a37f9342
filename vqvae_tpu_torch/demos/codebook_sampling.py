"""Continuous-vs-quantized reconstruction grids.

The port of ``demos/codebook_sampling.py``: load an experiment's VAE and
codebook, draw ``n`` val latents (numpy ``default_rng(seed)``, as JAX),
snap each (each grid cell, for spatial latents) to its nearest medoid
(kernel K3 on the card, ``cli.quality_checks.nearest_medoid_assign``) and
decode both. Writes ``<experiment>/demo_cont_vs_quant.png`` (top row
continuous, bottom quantized) with the port's own PNG writer.

Run: ``python -m vqvae_tpu_torch.demos.codebook_sampling <experiment_dir>
[--n 16] [--seed 0] [--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..cli.build_codebook import load_codebook
from ..cli.quality_checks import _load_vae, nearest_medoid_assign
from ..device import resolve_device
from ..utils.images import save_image_grid
from ..utils.latents import load_latents


def run(experiment_dir, n: int = 16, seed: int = 0, device=None) -> dict:
    """Decode the draws both ways on ``device`` (default the GPU), save the
    grid; returns the pixel MSE between the two rows and the grid's path."""
    dev = resolve_device(device)
    exp = Path(experiment_dir)
    model, vae_dir = _load_vae(exp, dev)
    z = load_latents(vae_dir / "latents_val")["z"]
    rng = np.random.default_rng(seed)
    z = z[rng.choice(len(z), size=min(n, len(z)), replace=False)]

    z_medoid = load_codebook(exp / "codebook")["z_medoid"].astype(np.float32)
    spatial = z.ndim == 4
    cells = z.reshape(-1, z.shape[-1]) if spatial else z
    codes = nearest_medoid_assign(cells, z_medoid, device=dev)
    zq = z_medoid[codes].reshape(z.shape)

    @torch.no_grad()
    def decode(zz):
        logits = model.decode(torch.from_numpy(
            np.ascontiguousarray(zz, np.float32)).to(dev))
        return torch.sigmoid(logits).cpu().numpy()

    x_cont = decode(z)
    x_quant = decode(zq)
    out = exp / "demo_cont_vs_quant.png"
    save_image_grid(np.concatenate([x_cont, x_quant]), out, nrow=len(z))
    mse = float(np.mean((x_cont - x_quant) ** 2))
    print(f"[demo] {'spatial' if spatial else 'vanilla'} latents; "
          f"cont-vs-quant pixel MSE={mse:.6f}")
    print(f"[demo] saved {out} (top row: continuous, bottom: quantized)")
    return {"spatial": spatial, "n": int(len(z)), "pixel_mse": mse,
            "codes": codes, "png": str(out)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment_dir", type=str)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.experiment_dir, n=args.n, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()
