"""Does ``spatial_free_bits`` hold the CIFAR-10 spatial posterior open?

The port of ``tools/ab_cifar_freebits.py``: the preset's VAE with its
architecture shrunk (encoder 16/32/64, decoder 64/32/16, batch 64) and its
loss path kept (raw-logit MSE on normalized CIFAR targets, beta 1, no
anneal) trains twice on ``size`` synthetic images, ``spatial_free_bits``
None (control) and 0.1, through ``check_cifar_collapse.train_probe``. For
each arm: the per-dimension std of the training mu, the Riemannian length
of 1,024 unit latent perturbations (numpy ``default_rng(0)``, as JAX) and
the val KL trajectory from ``metrics.jsonl``; then the ratios and JAX's
verdict. Writes the record to ``--out``.

Run: ``python -m vqvae_tpu_torch.tools.ab_cifar_freebits [--size 1024]
[--epochs 20] [--out experiments/_freebits_ab/ab.json]
[--work experiments/_freebits_ab] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..device import resolve_device
from ..ops import edge_lengths_riemannian
from ..ops.riemannian import make_decoder_image_fn
from .check_cifar_collapse import PRESET, cells, load_probe_vae, train_probe

ARCH = {"enc_channels": [16, 32, 64], "dec_channels": [64, 32, 16]}


def run_arm(tag: str, free_bits: Optional[float], size: int, epochs: int,
            work="experiments/_freebits_ab", preset=PRESET,
            device=None) -> Dict:
    """One arm's training and diagnostics."""
    dev = resolve_device(device)
    out = Path(work) / tag
    if out.exists():
        shutil.rmtree(out)
    run_dir, cfg = train_probe(preset, size, epochs, out,
                               model={**ARCH, "spatial_free_bits": free_bits},
                               data={"batch_size": 64}, device=dev)
    mu = cells(run_dir, "mu")
    z = cells(run_dir, "z")
    mu_std = mu.std(axis=0)
    decode_fn = make_decoder_image_fn(load_probe_vae(run_dir, cfg, dev),
                                      "spatial")
    rng = np.random.default_rng(0)
    za = z[rng.integers(0, len(z), size=1024)]
    # unit perturbations: the Jacobian's scale, whatever the latent spread
    tangent = rng.normal(size=za.shape).astype(np.float32)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True) + 1e-12
    lengths = edge_lengths_riemannian(decode_fn, za, za + tangent,
                                      batch_size=256, device=dev)
    val_kl = []
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "val_kl" in rec:
            val_kl.append(round(float(rec["val_kl"]), 3))
    return {
        "free_bits": free_bits,
        "mu_std_mean": float(mu_std.mean()),
        "mu_std_min": float(mu_std.min()),
        "mu_std_max": float(mu_std.max()),
        "riem_unit_length_mean": float(lengths.mean()),
        "riem_unit_length_p10": float(np.quantile(lengths, 0.1)),
        "val_kl_first": val_kl[0] if val_kl else None,
        "val_kl_last": val_kl[-1] if val_kl else None,
        "val_kl_trajectory": val_kl,
    }


def verdict(control: Dict, fixed: Dict, size: int, epochs: int,
            platform: str) -> Dict:
    """JAX's summary of the two arms."""
    res = {
        "probe": {"synthetic_size": size, "epochs": epochs,
                  "arch": "enc 16/32/64, latent 32, raw-logit MSE, beta 1",
                  "platform": platform},
        "control": control,
        "freebits": fixed,
        "mu_std_ratio": fixed["mu_std_mean"] / max(control["mu_std_mean"],
                                                   1e-12),
        "jacobian_ratio": (fixed["riem_unit_length_mean"]
                           / max(control["riem_unit_length_mean"], 1e-12)),
        "kl_floor_nats": 0.1 * 4 * 4 * 32,
    }
    res["verdict"] = (
        "free-bits holds the posterior open"
        if res["mu_std_ratio"] > 2.0 and fixed["mu_std_mean"] > 1e-2
        else ("control did not collapse at probe scale — A/B inconclusive"
              if control["mu_std_mean"] > 1e-2
              else "free-bits arm ALSO collapsed — recipe insufficient"))
    return res


def run(size: int = 1024, epochs: int = 20,
        work="experiments/_freebits_ab", preset=PRESET,
        device=None) -> Dict:
    """Both arms on ``device`` (default the GPU) and the verdict."""
    dev = resolve_device(device)
    control = run_arm("control", None, size, epochs, work, preset, dev)
    print("[ab] control:", json.dumps(control), flush=True)
    fixed = run_arm("freebits", 0.1, size, epochs, work, preset, dev)
    print("[ab] freebits:", json.dumps(fixed), flush=True)
    return verdict(control, fixed, size, epochs, dev.type)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--work", default="experiments/_freebits_ab")
    ap.add_argument("--out", default="experiments/_freebits_ab/ab.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = run(args.size, args.epochs, args.work, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=2))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("control", "freebits")}, indent=2))
    return res


if __name__ == "__main__":
    main()
