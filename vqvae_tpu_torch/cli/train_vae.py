"""VAE training stage (flat and spatial) — the port of
``vqvae_tpu/cli/train_vae.py``, with the same config schema (the stage
YAMLs ``configs/<ds>/<variant>/<distance>/vae.yaml``).

Spatial runs nest their outputs under ``<out_dir>/spatial_vae_<dataset>``.
As in the JAX package, a cosine scheduler anneals over ``max_epochs``, not
``scheduler.t_max``. Writes ``checkpoints/best.pt`` and ``latest.pt``,
``latents_train`` / ``latents_val``, ``recon_grid.png``, ``metrics.csv``,
``metrics.jsonl`` and ``params.yaml``. ``model.dtype`` (``float32``,
``bfloat16`` or ``float16``) sets the compute dtype; the parameters and
checkpoints stay float32. Under ``torchrun`` the ranks train data-parallel
(``parallel.init_distributed``) and rank 0 writes.

``model.arch`` picks the model: ``vae`` (the default, the conv ``VAE``) or
``autoencoder_kl`` (``models/autoencoder_kl.py``, FLUX.1's KL autoencoder,
float32 only), whose other ``model`` keys are its constructor's
(``block_out_channels``, ``layers_per_block``, ``latent_channels``,
``norm_num_groups``, ``in_channels``, ``out_channels``) and ``beta``, the
KL weight; its latents are spatial grids. Train it on ``data.name:
synthetic_rgb`` with ``data.image_size`` (e.g. 256) and
``data.synthetic_size`` (the images of the train split; the val split
takes a sixth, at least 32).

Run: ``python -m vqvae_tpu_torch.cli.train_vae --config <yaml>
[--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

from ..config import Config, load_config
from ..data import get_data_loaders
from ..device import resolve_device
from ..models import VAE, AutoencoderKL
from ..models.cast import resolve_dtype
from ..parallel.mesh import barrier, init_distributed
from ..train import VAEEngine
from ..utils.checkpoint import read_checkpoint
from ..utils.logging import MetricsLogger


def train_vae_main(cfg: Config, topology: Optional[str] = None,
                   device=None) -> Path:
    """Run the VAE stage for ``cfg`` on ``device`` (default the GPU;
    raises when CUDA is absent and no device is given). Returns the run's
    output directory. Under ``torchrun`` (``WORLD_SIZE``/``RANK`` set) it
    joins the process group and trains data-parallel; rank 0 writes."""
    mesh = init_distributed(device=device)
    dev = resolve_device(device)
    seed = int(cfg.get("seed", 42))
    model_cfg = dict(cfg["model"])
    arch = str(model_cfg.pop("arch", "vae"))
    if arch not in ("vae", "autoencoder_kl"):
        raise ValueError(f"model.arch {arch!r}: expected vae or "
                         "autoencoder_kl")
    beta = float(model_cfg.pop("beta", 1.0))
    topology = topology or model_cfg.pop(
        "topology", "spatial" if arch == "autoencoder_kl" else "flat")
    model_cfg.pop("topology", None)
    # e.g. "bfloat16": bf16 compute with float32 parameters (raises on a
    # name that is not a floating dtype)
    model_cfg["dtype"] = str(model_cfg.get("dtype", "float32"))
    resolve_dtype(model_cfg["dtype"])
    if arch == "autoencoder_kl" and model_cfg.pop("dtype") != "float32":
        raise ValueError("model.dtype: autoencoder_kl computes in float32")

    data_cfg = cfg["data"]
    train_loader, val_loader = get_data_loaders(
        name=str(data_cfg["name"]),
        root=str(data_cfg.get("root", "data")),
        batch_size=int(data_cfg["batch_size"]),
        augment=bool(data_cfg.get("augment", False)),
        seed=seed,
        synthetic_size=data_cfg.get("synthetic_size"),
        image_size=int(data_cfg.get("image_size", 256)),
    )
    if arch == "autoencoder_kl":
        model = AutoencoderKL(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in model_cfg.items()})
    else:
        model = VAE(topology=topology,
                    enc_channels=tuple(model_cfg.pop("enc_channels",
                                                     (32, 64, 128))),
                    dec_channels=tuple(model_cfg.pop("dec_channels",
                                                     (128, 64, 32))),
                    **model_cfg)

    out_dir = Path(cfg["out_dir"])
    if topology == "spatial":
        out_dir = out_dir / f"spatial_vae_{str(data_cfg['name']).lower()}"
    ckpt_dir = out_dir / "checkpoints"

    logger = MetricsLogger(out_dir,
                           run_name=str(cfg.get("run_name", "vae")),
                           experiment_name=str(cfg.get("experiment_name",
                                                       "vae")),
                           tracking_uri=cfg.get("mlflow_tracking_uri"))
    logger.log_params({
        "seed": seed, "max_epochs": cfg["max_epochs"], "lr": cfg["lr"],
        "weight_decay": cfg.get("weight_decay", 0.0),
        "latent_dim": model.latent_dim, "recon_loss": model.recon_loss,
        "topology": topology, "device": str(dev),
    })

    scheduler = cfg.get("scheduler")
    use_cosine = bool(scheduler) and (
        not isinstance(scheduler, (dict, Config))
        or scheduler.get("name") == "cosine")
    engine = VAEEngine(
        model,
        lr=float(cfg["lr"]),
        weight_decay=float(cfg.get("weight_decay", 0.0)),
        optimizer=str(cfg.get("optimizer", "adamw")),
        grad_clip_max_norm=float(cfg.get("grad_clip_max_norm", 0.0)),
        cosine_t_max=int(cfg["max_epochs"]) if use_cosine else None,
        steps_per_epoch=len(train_loader),
        seed=seed,
        device=dev,
        mesh=mesh,
    )
    engine.init_state()
    latest = ckpt_dir / "latest.pt"
    if bool(cfg.get("resume", False)) and latest.exists():
        state = read_checkpoint(latest)
        engine.model.load_state_dict(state["model_state_dict"])
        engine.opt.load_state_dict(state["optimizer_state_dict"])
        engine.step = int(state["step"])
        print(f"[vae] resumed from {latest} (epoch {state['epoch']}, "
              f"step {state['step']})")
    engine.train(
        train_loader, val_loader,
        num_epochs=int(cfg["max_epochs"]),
        early_stop=int(cfg.get("early_stop", 0)),
        checkpoint_dir=ckpt_dir,
        logger=logger,
        output_dir=out_dir,
        save_latents_flag=bool(cfg.get("save_latents", True)),
        kl_anneal_epochs=int(cfg.get("kl_anneal_epochs", 0)),
        beta=beta,
    )
    logger.end()
    barrier(mesh)  # rank 0's writes are done before any rank goes on
    print("Done. Artifacts in:", out_dir)
    return out_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train a VAE (PyTorch port).")
    parser.add_argument("--config", required=True,
                        help="VAE stage YAML (e.g. configs/fashionmnist/"
                             "spatial/geodesic/vae.yaml)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    train_vae_main(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
