"""Class-conditional sample generation — the port of
``vqvae_tpu/cli/generate_samples.py``.

All classes sample in one batched, KV-cached call
(``train.transformer_engine.sample_autoregressive``) with temperature and
top-k. Spatial mode draws the first token uniformly over ``num_tokens``
(also when conditioned) and samples the remaining ``max_seq_len - 1``
cells; vanilla mode prompts with BOS = ``num_tokens - 1`` and keeps the
first generated code. Codes index the codebook's ``z_medoid``, the VAE
decodes them, and the display mapping applies the sigmoid only when the
loss saw it (bce or ``mse_use_sigmoid``); CIFAR models trained on raw
logits are denormalised instead. Writes one PNG grid with
``samples_per_class`` images per row.

Run: ``python -m vqvae_tpu_torch.cli.generate_samples --config <yaml>
[--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import Config, load_config
from ..device import resolve_device
from ..models.transformer import Transformer
from ..train.transformer_engine import sample_autoregressive
from ..utils.checkpoint import load_vae_from_checkpoint, read_checkpoint
from ..utils.images import save_image_grid, unnormalize_images
from .build_codebook import load_codebook


def load_transformer(path: str | Path, config, device) -> Transformer:
    """``models.Transformer`` of ``config`` with the weights of a ``.pt``
    checkpoint (``.../checkpoints/best`` reads ``best.pt``), in eval mode
    on ``device``."""
    model = Transformer(**dict(config))
    model.load_state_dict(read_checkpoint(path)["model_state_dict"])
    return model.to(device).eval()


def _clamped(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Codes as indices into ``table``, clamped to its rows as XLA clamps
    an out-of-range gather: a vanilla prior's vocabulary holds BOS
    (``num_tokens - 1``, one past the last code), and a sampled BOS
    decodes as the last code in the JAX package."""
    return codes.clamp(0, table.shape[0] - 1)


def generate_samples_main(cfg: Config, device=None) -> Path:
    """Sample and decode the grid of ``cfg`` on ``device`` (default the
    GPU; raises when CUDA is absent and no device is given). Returns the
    PNG's path."""
    dev = resolve_device(device)
    seed = int(cfg.get("seed", 42))
    gen = torch.Generator(device=dev).manual_seed(seed)

    tf_cfg = dict(cfg["transformer"])
    transformer = load_transformer(cfg["transformer_ckpt_path"], tf_cfg, dev)

    vae_cfg = dict(cfg["vae"])
    is_vanilla = bool(cfg.get("vanilla_vae", False))
    vae_cfg.setdefault("topology", "flat" if is_vanilla else "spatial")
    recon_loss = vae_cfg.setdefault("recon_loss", "mse")
    mse_use_sigmoid = bool(vae_cfg.setdefault("mse_use_sigmoid", True))
    vae = load_vae_from_checkpoint(cfg["vae_ckpt_path"], vae_cfg, device=dev)

    codebook = load_codebook(cfg["codebook_path"])
    codebook_vectors = torch.from_numpy(
        np.asarray(codebook["z_medoid"], np.float32)).to(dev)

    class_labels = cfg.get("class_labels", [None])
    samples_per_class = int(cfg.get("samples_per_class", 8))
    temperature = float(cfg.get("temperature", 1.0))
    top_k = cfg.get("top_k")
    top_k = int(top_k) if top_k is not None else None
    num_tokens = int(tf_cfg["num_tokens"])
    max_seq_len = int(tf_cfg["max_seq_len"])
    # the codebook, not the yaml, gives the latent width of a cell
    latent_dim = int(codebook_vectors.shape[-1])

    conditional = all(c is not None for c in class_labels)
    n_total = samples_per_class * len(class_labels)
    y = None
    if conditional and transformer.num_classes > 0:
        y = torch.from_numpy(np.repeat([int(c) for c in class_labels],
                                       samples_per_class)).long().to(dev)
    print(f"[generate] {n_total} samples "
          f"({len(class_labels)} classes x {samples_per_class}), one batch")

    if is_vanilla:
        first = torch.full((n_total, 1), num_tokens - 1, dtype=torch.long,
                           device=dev)
        codes = sample_autoregressive(
            transformer, first, steps=max_seq_len - 1, generator=gen,
            temperature=temperature, top_k=top_k, labels=y)[:, 1:]
        zq = codebook_vectors[_clamped(codes[:, 0], codebook_vectors)]
    else:
        first = torch.randint(0, num_tokens, (n_total, 1), generator=gen,
                              device=dev)
        codes = sample_autoregressive(
            transformer, first, steps=max_seq_len - 1, generator=gen,
            temperature=temperature, top_k=top_k, labels=y)
        zq = codebook_vectors[_clamped(codes, codebook_vectors)].reshape(
            n_total, 4, 4, latent_dim)

    apply_sigmoid = (recon_loss == "bce") or mse_use_sigmoid
    dataset_name = str(cfg.get("dataset_name", "fashionmnist"))
    with torch.no_grad():
        logits = vae.decode(zq).cpu().numpy()
    final = unnormalize_images(logits, dataset_name, apply_sigmoid)
    out_path = Path(cfg["output_dir"]) / str(
        cfg.get("output_filename", "generated_samples.png"))
    save_image_grid(final, out_path, nrow=samples_per_class, padding=2)
    print(f"[generate] Saved generated images to {out_path}")
    return out_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Sample the transformer prior and decode (PyTorch port).")
    parser.add_argument("--config", required=True,
                        help="generate stage YAML (e.g. configs/fashionmnist/"
                             "spatial/geodesic/generate.yaml)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    generate_samples_main(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
