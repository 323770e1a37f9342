"""Plain float32 optimizer arithmetic of the stages' training: optax's
``clip_by_global_norm`` and ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decay on
every parameter from its pre-step value) under the per-epoch cosine
schedule with eta_min 0. Imports nothing of the program."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8

Tensors = Dict[str, torch.Tensor]


def cosine_lr(base: float, t_max: Optional[int], steps_per_epoch: int,
              count: int) -> float:
    """The learning rate of update ``count`` (from 0): constant within an
    epoch, cosine over ``t_max`` epochs (none: constant)."""
    if not t_max:
        return base
    epoch = min(count // max(1, steps_per_epoch), t_max)
    return base * 0.5 * (1.0 + math.cos(math.pi * epoch / t_max))


def clip_global(grads: Tensors, max_norm: float) -> Tensors:
    """Every gradient scaled by ``max_norm / norm`` when the global norm is
    not below ``max_norm``; unchanged when ``max_norm`` is 0."""
    if max_norm <= 0:
        return grads
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return {k: g * scale for k, g in grads.items()}


def adamw(params: Tensors, grads: Tensors, m: Tensors, v: Tensors,
          steps: Dict[str, int], lr: float, weight_decay: float
          ) -> Tuple[Tensors, Tensors, Tensors]:
    """One AdamW update of every leaf: (params, m, v) after it. ``steps``
    holds each leaf's updates so far (0 for a fresh state, where ``m`` and
    ``v`` may be absent)."""
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        t = steps.get(k, 0) + 1
        mk = B1 * m[k] + (1 - B1) * g if k in m else (1 - B1) * g
        vk = B2 * v[k] + (1 - B2) * g * g if k in v else (1 - B2) * g * g
        m_hat = mk / (1 - B1 ** t)
        v_hat = vk / (1 - B2 ** t)
        new_p[k] = p - lr * (m_hat / (torch.sqrt(v_hat) + EPS)
                             + weight_decay * p)
        new_m[k], new_v[k] = mk, vk
    return new_p, new_m, new_v
