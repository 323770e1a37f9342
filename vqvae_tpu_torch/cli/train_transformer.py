"""Transformer-prior training stage — the port of
``vqvae_tpu/cli/train_transformer.py``, with the same config schema (the
stage YAMLs ``configs/<ds>/<variant>/<distance>/transformer.yaml``).

Labels come from ``data.labels_path``: a latents directory (its
``latents.npz``, whose ``y`` is copied to ``<out>/labels_cache.npy``), a
``latents.npz``, or a labels ``.npy`` / ``.pt``. Writes
``<out>/checkpoints/best.pt`` and ``latest.pt``, ``metrics.csv``,
``metrics.jsonl`` and ``params.yaml``. With ``resume: true`` the run
starts from ``latest.pt``: the full state when it holds the optimizer,
the weights and step otherwise. ``model.dtype`` (``float32``,
``bfloat16`` or ``float16``) sets the compute dtype; the parameters and
checkpoints stay float32.

Run: ``python -m vqvae_tpu_torch.cli.train_transformer --config <yaml>
[--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import Config, load_config
from ..data.codes import get_code_loaders
from ..device import resolve_device
from ..models.cast import resolve_dtype
from ..models.transformer import Transformer
from ..parallel.mesh import barrier, init_distributed, is_primary
from ..train.transformer_engine import TransformerEngine
from ..utils.checkpoint import read_checkpoint
from ..utils.logging import MetricsLogger


def _resolve_labels_path(p) -> str | None:
    """A labels .pt/.npy, a latents.npz, or a latents dir (the labels live
    in its ``latents.npz``)."""
    if p is None:
        return None
    p = Path(p)
    if p.is_dir():
        if (p / "latents.npz").exists():
            return str(p / "latents.npz")
        if (p / "y.pt").exists():
            return str(p / "y.pt")
    return str(p)


def _load_labels_any(path: str | None):
    if path is None or Path(path).suffix != ".npz":
        return None  # .npy/.pt: the dataset reads them itself
    with np.load(path) as f:
        return f["y"].astype(np.int32)


def train_transformer_main(cfg: Config, device=None) -> Path:
    """Run the transformer stage for ``cfg`` on ``device`` (default the
    GPU; raises when CUDA is absent and no device is given). Returns the
    output directory. Under ``torchrun`` the ranks train data-parallel and
    rank 0 writes."""
    mesh = init_distributed(device=device)
    dev = resolve_device(device)
    data_cfg = cfg["data"]
    model_cfg = dict(cfg["model"])
    train_cfg = cfg["training"]
    seed = int(cfg.get("system", Config({})).get("seed", 42))
    # e.g. "bfloat16": bf16 compute with float32 parameters (raises on a
    # name that is not a floating dtype)
    model_cfg["dtype"] = str(model_cfg.get("dtype", "float32"))
    resolve_dtype(model_cfg["dtype"])

    out_dir = Path(cfg["out"]["dir"])
    labels_path = _resolve_labels_path(data_cfg.get("labels_path"))
    labels_arr = _load_labels_any(labels_path)
    if labels_arr is not None:
        # a .npy next to the outputs keeps the dataset's loader simple
        cache = out_dir / "labels_cache.npy"
        if is_primary():
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache, labels_arr)
        barrier(mesh)
        labels_path = str(cache)

    train_loader, val_loader = get_code_loaders(
        codes_path=str(data_cfg["codes_path"]),
        labels_path=labels_path,
        batch_size=int(data_cfg["batch_size"]),
        vanilla_vae=bool(data_cfg.get("vanilla_vae", False)),
        num_tokens=model_cfg.get("num_tokens"),
        seed=seed,
    )
    model = Transformer(**model_cfg)
    logger = MetricsLogger(out_dir, run_name=str(cfg.get("run_name",
                                                         "transformer")))
    logger.log_params({**model_cfg, "lr": train_cfg["lr"],
                       "weight_decay": train_cfg.get("weight_decay", 0.0),
                       "epochs": train_cfg["epochs"],
                       "label_smoothing": train_cfg.get("label_smoothing",
                                                        0.0),
                       "device": str(dev)})

    engine = TransformerEngine(
        model,
        lr=float(train_cfg["lr"]),
        weight_decay=float(train_cfg.get("weight_decay", 0.0)),
        grad_clip_max_norm=float(train_cfg.get("grad_clip_max_norm", 0.0)),
        cosine_t_max=int(train_cfg["epochs"]),
        steps_per_epoch=len(train_loader),
        label_smoothing=float(train_cfg.get("label_smoothing", 0.0)),
        seed=seed,
        device=dev,
        mesh=mesh,
    )
    engine.init_state()
    latest = out_dir / "checkpoints" / "latest.pt"
    if bool(cfg.get("resume", False)) and latest.exists():
        state = read_checkpoint(latest)
        # the saved keys decide: a finished stage keeps the optimizer, the
        # per-epoch writes hold the weights only
        full = "optimizer_state_dict" in state
        engine.model.load_state_dict(state["model_state_dict"])
        if full:
            engine.opt.load_state_dict(state["optimizer_state_dict"])
        engine.step = int(state["step"])
        print(f"[transformer] resumed from epoch {state['epoch']} "
              f"({'full state' if full else 'weights-only'})")
    engine.train(train_loader, val_loader,
                 num_epochs=int(train_cfg["epochs"]),
                 checkpoint_dir=out_dir / "checkpoints", logger=logger)
    logger.end()
    barrier(mesh)  # rank 0's writes are done before any rank goes on
    print("Done. Artifacts in:", out_dir)
    return out_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train the transformer prior (PyTorch port).")
    parser.add_argument("--config", required=True,
                        help="transformer stage YAML (e.g. configs/"
                             "fashionmnist/spatial/geodesic/transformer.yaml)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    train_transformer_main(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
