"""LPIPS (AlexNet) perceptual distance — the port of
``vqvae_tpu/eval/lpips.py``.

The metric is weight-gated: it is computed exactly when a weights file is
found, and the evaluator records null otherwise (a randomly initialised
LPIPS would be meaningless). The weights are not in the repository.

Weight sources, checked in order:
1. ``$LPIPS_WEIGHTS``, an ``.npz`` with the arrays named below,
2. ``data/lpips_alex.npz``,
3. a torch ``lpips`` package state dict (``.pt``/``.pth``), converted on
   load (when ``$LPIPS_WEIGHTS`` names one).

Arrays: AlexNet's conv kernels ``conv{0..4}/kernel`` (OIHW) and biases
``conv{0..4}/bias``, and the linear calibration weights ``lin{0..4}``
((C,) after squeezing).

Architecture (lpips, net='alex', version 0.1): inputs in [-1, 1], shifted
by (-0.030, -0.088, -0.188) and scaled by (0.458, 0.448, 0.450); five
conv stages with ReLU, a 3x3 stride-2 max-pool (no padding) before stages
2 and 3; each stage's channels unit-normalised (epsilon 1e-10 inside the
square root), squared difference, 1x1 linear head, spatial mean, sum over
stages. Images are first upscaled to 64 px bilinearly with half-pixel
centres.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet features: (out_ch, kernel, stride, pad, pool_before)
_ALEX = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


def _find_weights() -> Path:
    cands = []
    if os.environ.get("LPIPS_WEIGHTS"):
        cands.append(Path(os.environ["LPIPS_WEIGHTS"]))
    cands.append(Path("data/lpips_alex.npz"))
    for c in cands:
        if c.exists():
            return c
    raise FileNotFoundError(
        "LPIPS weights not found (set $LPIPS_WEIGHTS or place "
        "data/lpips_alex.npz); LPIPS will be reported as null")


def _load_weights(path: Path) -> Dict[str, np.ndarray]:
    if path.suffix == ".npz":
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    # a torch lpips state dict
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    conv_i = 0
    for k, v in sd.items():
        arr = v.numpy()
        if "net" in k and "weight" in k and arr.ndim == 4:
            out[f"conv{conv_i}/kernel"] = arr
        elif "net" in k and "bias" in k:
            out[f"conv{conv_i}/bias"] = arr
            conv_i += 1
        elif "lin" in k and "weight" in k:
            idx = int("".join(ch for ch in k.split(".")[0] if ch.isdigit()))
            out[f"lin{idx}"] = arr.squeeze()
    return out


def _feature_stack(x: torch.Tensor, w: Dict[str, torch.Tensor]
                   ) -> List[torch.Tensor]:
    """x (B, 3, H, W) in [-1, 1] -> the 5 unit-normalised feature maps."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    feats = []
    for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX):
        if pool_before:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
        h = F.relu(F.conv2d(h, w[f"conv{i}/kernel"], w[f"conv{i}/bias"],
                            stride=stride, padding=pad))
        norm = torch.sqrt((h * h).sum(1, keepdim=True) + 1e-10)
        feats.append(h / norm)
    return feats


@torch.no_grad()
def lpips_distance(generated: np.ndarray, real: np.ndarray,
                   target_size: int = 64,
                   weights_path: Optional[str | Path] = None,
                   device=None) -> float:
    """Mean LPIPS over a batch of (N, H, W, C) [0, 1] images (gray is
    repeated to 3 channels), upscaled to ``target_size`` and rescaled to
    [-1, 1], on ``device`` (default the GPU). Raises ``FileNotFoundError``
    without weights."""
    path = Path(weights_path) if weights_path else _find_weights()
    dev = resolve_device(device)
    w = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
         for k, v in _load_weights(path).items()}

    def prep(imgs):
        x = torch.from_numpy(np.asarray(imgs, np.float32)).to(dev)
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(target_size,
                                                       target_size),
                          mode="bilinear", align_corners=False)
        return x * 2.0 - 1.0

    fa = _feature_stack(prep(generated), w)
    fb = _feature_stack(prep(real), w)
    total = 0.0
    for i, (a, b) in enumerate(zip(fa, fb)):
        lin = w[f"lin{i}"].reshape(1, -1, 1, 1)
        total = total + ((a - b) ** 2 * lin).sum(1).mean(dim=(1, 2))
    return float(total.mean())
