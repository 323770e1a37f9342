"""Euclidean K-means: Lloyd iterations on the device.

The port of ``vqvae_tpu/ops/kmeans_euclidean.py`` (the Euclidean codebook
of ``demos/codebook_comparison.py``), with its contract and its quirks:

- k-means++ initial centres drawn on the host with numpy
  ``default_rng(seed)``, so both packages start from the same centres;
- assignment by the fast form ``|z|^2 - 2 z.c + |c|^2`` and ``argmin``
  (the first index on ties); the inertia is that form's value at the
  labels, summed and clamped at 0 as a whole;
- the update is a segment sum; an empty cluster keeps its centre;
- exactly ``max_iter`` iterations, then a final assignment: ``tol`` is
  accepted and ignored, as the JAX loop's condition ignores it.

The products are plain ``torch.matmul`` (no kernel: the JAX side is XLA
inside ``jit``), in full f32 (``resolve_device`` turns TF32 off).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device


def assign_fast_form(z: torch.Tensor, z_sq: torch.Tensor,
                     centers: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, d2): the nearest centre of each row by the fast form, and
    the (N, K) fast-form values."""
    c_sq = (centers * centers).sum(1)
    d2 = z_sq[:, None] - 2.0 * (z @ centers.T) + c_sq[None, :]
    return torch.argmin(d2, dim=1), d2


def lloyd_update(z: torch.Tensor, labels: torch.Tensor,
                 centers: torch.Tensor) -> torch.Tensor:
    """Each centre moved to the mean of its rows; an empty one stays."""
    k = centers.shape[0]
    sums = torch.zeros_like(centers).index_add_(0, labels, z)
    counts = torch.zeros(k, dtype=z.dtype, device=z.device).index_add_(
        0, labels, torch.ones_like(z[:, 0]))
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp(counts[:, None], min=1.0), centers)


def _assign(z: torch.Tensor, z_sq: torch.Tensor, centers: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    labels, d2 = assign_fast_form(z, z_sq, centers)
    inertia = torch.gather(d2, 1, labels[:, None]).sum()
    return labels, torch.clamp(inertia, min=0.0)


def _lloyd(z: torch.Tensor, init_centers: torch.Tensor, max_iter: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``max_iter`` Lloyd iterations from ``init_centers``, then a final
    assignment: (centres, labels, inertia), all on ``z``'s device."""
    z_sq = (z * z).sum(1)
    centers = init_centers
    for _ in range(max_iter):
        labels, _ = assign_fast_form(z, z_sq, centers)
        centers = lloyd_update(z, labels, centers)
    labels, inertia = _assign(z, z_sq, centers)
    return centers, labels, inertia


def kmeans_plus_plus_init(z: np.ndarray, n_clusters: int, seed: int = 42
                          ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = z.shape[0]
    centers = [int(rng.integers(0, n))]
    d_min = np.full(n, np.inf, np.float64)
    for _ in range(1, n_clusters):
        diff = z - z[centers[-1]]
        d_min = np.minimum(d_min, (diff * diff).sum(1))
        probs = d_min.copy()
        probs[centers] = 0.0
        s = probs.sum()
        if s <= 0:
            pool = np.setdiff1d(np.arange(n), centers)
            centers.append(int(rng.choice(pool)))
        else:
            centers.append(int(rng.choice(n, p=probs / s)))
    return z[np.asarray(centers)].astype(np.float32)


def fit_kmeans(z: np.ndarray, n_clusters: int, seed: int = 42,
               max_iter: int = 100, tol: float = 1e-4, device=None
               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centers (K, D) float32, labels (N,) int64, inertia) on ``device``
    (default the GPU; raises when CUDA is absent and no device is given).
    ``tol`` is ignored, as in the JAX package: the loop runs ``max_iter``
    iterations."""
    dev = resolve_device(device)
    z = np.asarray(z, np.float32)
    init = kmeans_plus_plus_init(z, n_clusters, seed)
    centers, labels, inertia = _lloyd(torch.from_numpy(z).to(dev),
                                      torch.from_numpy(init).to(dev),
                                      max_iter)
    return (centers.cpu().numpy(), labels.cpu().numpy().astype(np.int64),
            float(inertia))
