"""Latent artifact IO — the port's copy of ``vqvae_tpu/utils/latents.py``.

The canonical artifact is one ``latents.npz`` in NHWC with a recorded
layout, interchangeable with the JAX package's. Loading also accepts a
directory of reference-style ``.pt`` tensors (z/mu/logvar/y, NCHW),
converted to NHWC.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch


def save_latents(out_dir: str | Path, z: np.ndarray, mu: np.ndarray,
                 logvar: np.ndarray, y: np.ndarray) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "latents.npz"
    np.savez_compressed(path, z=z, mu=mu, logvar=logvar, y=y,
                        layout=np.bytes_(b"NHWC"))
    return path


def load_latents(path: str | Path) -> Dict[str, np.ndarray]:
    """Load latents from latents.npz, a dir containing it, or a dir of
    reference-style .pt files (z.pt/mu.pt/logvar.pt/y.pt, NCHW)."""
    path = Path(path)
    if path.is_dir():
        if (path / "latents.npz").exists():
            path = path / "latents.npz"
        elif (path / "z.pt").exists():
            return _load_pt_dir(path)
        else:
            raise FileNotFoundError(f"no latents found under {path}")
    if path.suffix == ".npz":
        with np.load(path) as f:
            return {k: f[k] for k in ("z", "mu", "logvar", "y") if k in f}
    if path.suffix == ".pt":
        return _load_pt_dir(path.parent)
    raise ValueError(f"unsupported latents path {path}")


def _load_pt_dir(d: Path) -> Dict[str, np.ndarray]:
    out = {}
    for name in ("z", "mu", "logvar", "y"):
        p = d / f"{name}.pt"
        if p.exists():
            arr = torch.load(p, map_location="cpu", weights_only=True).numpy()
            if arr.ndim == 4:  # reference NCHW -> NHWC
                arr = arr.transpose(0, 2, 3, 1)
            out[name] = arr
    if "z" not in out:
        raise FileNotFoundError(f"no z.pt in {d}")
    return out


def flatten_spatial(z: np.ndarray) -> np.ndarray:
    """(N, H, W, C) -> (N*H*W, C), row-major over the grid — the node order
    of the graph build (the reference permutes NCHW to NHWC before
    reshaping, so orders match exactly)."""
    if z.ndim != 4:
        raise ValueError(f"expected (N,H,W,C), got {z.shape}")
    return np.ascontiguousarray(z.reshape(-1, z.shape[-1]))
