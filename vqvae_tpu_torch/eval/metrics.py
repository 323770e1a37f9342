"""Image-quality and codebook-health metrics — the port of
``vqvae_tpu/eval/metrics.py``.

The definitions, and their quirks, are the reference's, because published
numbers depend on them:

- ``psnr``: 10 log10(max^2 / mse) over the whole batch, inputs in [0, 1];
  ``mask`` (B,) excludes padded rows from the MSE.
- ``ssim_simple``: a global-statistics SSIM (no sliding window) per image,
  then averaged. The batch branch's denominator is
  ``(mu_x^2 + mu_y^2 + C1) + (var_x + var_y + C2)`` — a ``+`` where the
  canonical formula, and the single-image branch, use ``*``.
- ``codebook_stats``: entropy / dead / used, ignoring -1 sentinel codes.

The tensor versions serve the training engine's eval step on any device;
the ``*_np`` twins (float64 numpy) serve the host-side quality stage.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch PSNR in dB; ``mask`` (B,) excludes padded rows from the MSE."""
    se = (x - y) ** 2
    if mask is not None:
        per = se.sum(tuple(range(1, x.ndim)))
        n_per = float(np.prod(x.shape[1:]))
        mse = (per * mask).sum() / torch.clamp_min(mask.sum() * n_per, 1.0)
    else:
        mse = se.mean()
    mse = torch.clamp_min(mse, 1e-12)
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _moments(x: torch.Tensor, y: torch.Tensor, axes):
    mu_x, mu_y = x.mean(axes, keepdim=True), y.mean(axes, keepdim=True)
    var_x = ((x - mu_x) ** 2).mean(axes)
    var_y = ((y - mu_y) ** 2).mean(axes)
    cov = ((x - mu_x) * (y - mu_y)).mean(axes)
    return mu_x.reshape(var_x.shape), mu_y.reshape(var_y.shape), var_x, \
        var_y, cov


def ssim_simple(x: torch.Tensor, y: torch.Tensor, C1: float = 0.01 ** 2,
                C2: float = 0.03 ** 2,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global-statistics SSIM, per image then averaged (the reference's
    batch branch, with its ``+`` denominator); a single image takes the
    ``*`` branch."""
    if x.ndim == 4:
        mu_x, mu_y, var_x, var_y, cov = _moments(x, y, (1, 2, 3))
        num = (2 * mu_x * mu_y + C1) * (2 * cov + C2)
        den = (mu_x ** 2 + mu_y ** 2 + C1) + (var_x + var_y + C2)
        per = torch.clamp(num / den, 0.0, 1.0)
        if mask is not None:
            return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return per.mean()
    mu_x, mu_y, var_x, var_y, cov = _moments(x, y, tuple(range(x.ndim)))
    num = (2 * mu_x * mu_y + C1) * (2 * cov + C2)
    den = (mu_x ** 2 + mu_y ** 2 + C1) * (var_x + var_y + C2)
    return torch.clamp(num / den, 0.0, 1.0)


def codebook_stats(codes: np.ndarray, K: int) -> Dict:
    """Entropy / dead / used over code assignments; -1 codes are ignored."""
    codes = np.asarray(codes).reshape(-1).astype(np.int64)
    valid = codes >= 0
    if valid.any():
        hist = np.bincount(codes[valid], minlength=K).astype(np.float64)
    else:
        hist = np.zeros(K, np.float64)
    p = np.maximum(hist / max(hist.sum(), 1e-12), 1e-12)
    entropy = float(-(p * np.log(p)).sum())
    return {
        "entropy": entropy,
        "dead_codes": int((hist == 0).sum()),
        "used": int((hist > 0).sum()),
    }


# ---- numpy twins for the host-side quality stage --------------------------

def psnr_np(x: np.ndarray, y: np.ndarray, max_val: float = 1.0) -> float:
    mse = max(float(np.mean((np.asarray(x, np.float64)
                             - np.asarray(y, np.float64)) ** 2)), 1e-12)
    return float(10.0 * np.log10(max_val ** 2 / mse))


def ssim_simple_np(x: np.ndarray, y: np.ndarray, C1: float = 0.01 ** 2,
                   C2: float = 0.03 ** 2) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.ndim == 4:
        vals = []
        for xi, yi in zip(x, y):
            mu_x, mu_y = xi.mean(), yi.mean()
            var_x, var_y = xi.var(), yi.var()
            cov = ((xi - mu_x) * (yi - mu_y)).mean()
            num = (2 * mu_x * mu_y + C1) * (2 * cov + C2)
            den = (mu_x ** 2 + mu_y ** 2 + C1) + (var_x + var_y + C2)
            vals.append(float(np.clip(num / den, 0, 1)))
        return float(np.mean(vals))
    mu_x, mu_y = x.mean(), y.mean()
    var_x, var_y = x.var(), y.var()
    cov = ((x - mu_x) * (y - mu_y)).mean()
    num = (2 * mu_x * mu_y + C1) * (2 * cov + C2)
    den = (mu_x ** 2 + mu_y ** 2 + C1) * (var_x + var_y + C2)
    return float(np.clip(num / den, 0, 1))
