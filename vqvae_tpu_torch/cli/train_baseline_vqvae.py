"""Train the end-to-end EMA VQ-VAE baseline — the port of
``scripts/train_baseline_vqvae.py`` (config + scalar overrides).

Reads ``configs/baseline_vqvae/config.yaml`` by default (CIFAR-10, 512
codes of width 128); without dataset files under ``data.root`` the split
is the synthetic CIFAR-10 stand-in (60,000 / 10,000 images, or
``data.synthetic_size``). Writes under ``out_dir``: ``checkpoints/best.pt``
and ``latest.pt`` (``{'model', 'optimizer', 'codebook', 'epoch'}``),
``recon_epoch<NNNN>.png`` every ``log.samples_every`` epochs,
``metrics.csv`` and ``metrics.jsonl``.

Run: ``python -m vqvae_tpu_torch.cli.train_baseline_vqvae [--config
<yaml>] [--epochs N] [--batch_size N] [--lr X] [--beta X] [--n_codes N]
[--ema_decay X] [--out_dir DIR] [--device cpu]``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..config import Config, load_config
from ..data.loader import get_data_loaders, get_split_loader
from ..device import resolve_device
from ..models.vqvae_baseline import VQVAE
from ..parallel.mesh import barrier, init_distributed
from ..train.vqvae_engine import VQVAEEngine
from ..utils.logging import MetricsLogger

DEFAULT_CONFIG = "configs/baseline_vqvae/config.yaml"


def baseline_model(model_cfg) -> VQVAE:
    """The ``VQVAE`` a config's ``model`` section describes."""
    return VQVAE(in_channels=int(model_cfg.get("in_channels", 3)),
                 z_channels=int(model_cfg.get("z_channels", 128)),
                 hidden=int(model_cfg.get("hidden", 256)),
                 n_res_blocks=int(model_cfg.get("n_res_blocks", 2)))


def _loader_args(cfg: Config, batch_size: int) -> dict:
    return {"name": str(cfg["data"].get("name", "CIFAR10")),
            "root": str(cfg["data"].get("root", "data")),
            "batch_size": batch_size, "seed": int(cfg.get("seed", 42)),
            "synthetic_size": cfg["data"].get("synthetic_size")}


def baseline_split_loader(cfg: Config, batch_size: int, train: bool):
    """One of the config's two loaders (synthetic without dataset files),
    the other split not built: the evaluators read one split."""
    return get_split_loader(train=train, **_loader_args(cfg, batch_size))


def train_baseline_main(cfg: Config, device=None) -> Path:
    """Train the baseline for ``cfg`` on ``device`` (default the GPU;
    raises when CUDA is absent and no device is given). Returns the
    output directory. Under ``torchrun`` the ranks train data-parallel and
    rank 0 writes."""
    mesh = init_distributed(device=device)
    dev = resolve_device(device)
    train_loader, val_loader = get_data_loaders(
        **_loader_args(cfg, int(cfg["train"]["batch_size"])))
    m = cfg["model"]
    engine = VQVAEEngine(
        baseline_model(m),
        n_codes=int(m.get("n_codes", 512)),
        beta=float(m.get("beta", 0.25)),
        ema_decay=float(m.get("ema_decay", 0.99)),
        ema_eps=float(m.get("ema_eps", 1e-5)),
        lr=float(cfg["train"]["lr"]),
        weight_decay=float(cfg["train"].get("weight_decay", 0.0)),
        grad_clip=float(cfg["train"].get("grad_clip", 1.0)),
        seed=int(cfg.get("seed", 42)),
        device=dev,
        mesh=mesh,
    )
    out_dir = Path(str(cfg.get("out_dir", "outputs/baseline_vqvae")))
    logger = MetricsLogger(out_dir, run_name="baseline_vqvae")
    cb, bank = engine.init_state()
    engine.train(cb, bank, train_loader, val_loader,
                 num_epochs=int(cfg["train"]["epochs"]),
                 checkpoint_dir=out_dir / "checkpoints",
                 logger=logger, output_dir=out_dir,
                 samples_every=int(cfg.get("log", {}).get("samples_every",
                                                          1)))
    logger.end()
    barrier(mesh)  # rank 0's writes are done before any rank goes on
    print("Done. Artifacts in:", out_dir)
    return out_dir


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(
        description="Train the EMA VQ-VAE baseline (PyTorch port).")
    ap.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--n_codes", type=int, default=None)
    ap.add_argument("--ema_decay", type=float, default=None)
    ap.add_argument("--out_dir", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    overrides: dict = {}
    for key, section in (("epochs", "train"), ("batch_size", "train"),
                         ("lr", "train"), ("beta", "model"),
                         ("n_codes", "model"), ("ema_decay", "model")):
        if getattr(args, key) is not None:
            overrides.setdefault(section, {})[key] = getattr(args, key)
    if args.out_dir is not None:
        overrides["out_dir"] = args.out_dir
    return train_baseline_main(load_config(args.config, overrides=overrides),
                               device=args.device)


if __name__ == "__main__":
    main()
