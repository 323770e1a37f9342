"""Optimizer construction — the port of ``vqvae_tpu/train/state.py``.

The reference's choices (AdamW by default, optional Adam, per-epoch
CosineAnnealingLR with eta_min 0, global-norm gradient clipping before the
update) with optax's arithmetic: ``optax.adamw`` decays every parameter and
computes ``m_hat / (sqrt(v_hat) + eps) + wd * p`` from the pre-step
parameter, which is ``torch.optim.AdamW`` with one parameter group (no
group excludes biases or norms); ``optax.clip_by_global_norm`` scales
every gradient by ``max_norm / norm`` when the norm is not below
``max_norm`` (``clip_grad_norm_`` would add 1e-6 to the norm).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch


def cosine_per_epoch_schedule(base_lr: float, t_max_epochs: int,
                              steps_per_epoch: int) -> Callable[[int], float]:
    """torch CosineAnnealingLR stepped per epoch: within an epoch the LR is
    constant; eta_min = 0."""
    def schedule(step: int) -> float:
        epoch = min(step // max(1, steps_per_epoch), t_max_epochs)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch
                                               / max(1, t_max_epochs)))

    return schedule


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place on ``.grad``; returns the
    norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


@dataclass
class Optimizer:
    """A torch optimizer with the JAX package's schedule and clipping:
    ``step()`` clips, sets the learning rate of update number ``count``
    (optax's schedule counter, from 0) and applies the update."""

    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_max_norm: float = 0.0
    count: int = 0

    def step(self) -> None:
        if self.grad_clip_max_norm > 0:
            clip_by_global_norm_(
                (p for g in self.opt.param_groups for p in g["params"]),
                self.grad_clip_max_norm)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    weight_decay: float = 0.0,
    optimizer: str = "adamw",
    grad_clip_max_norm: float = 0.0,
    cosine_t_max: Optional[int] = None,
    steps_per_epoch: int = 1,
) -> Optimizer:
    if cosine_t_max:
        schedule = cosine_per_epoch_schedule(lr, cosine_t_max,
                                             steps_per_epoch)
    else:
        def schedule(step: int) -> float:
            return lr
    params = list(params)
    # optax's defaults: b1 0.9, b2 0.999, eps 1e-8
    if optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {optimizer}")
    return Optimizer(opt, schedule, float(grad_clip_max_norm or 0.0))
