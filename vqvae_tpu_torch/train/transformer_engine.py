"""Transformer-prior training engine and sampler — the port of
``vqvae_tpu/train/transformer_engine.py``.

Training keeps the semantics of the JAX engine's ``train``: AdamW with the
per-epoch cosine schedule (``train.state.make_optimizer``, which decays
every parameter as ``optax.adamw`` does), next-token cross entropy with
label smoothing and the padded rows masked out. The dataset lives on the
device, padded to whole batches (``n_pad`` rows); each epoch takes a
permutation over all ``n_pad`` rows, so masked rows land in any batch.
The epoch loss is the mean of the per-batch masked means; the "val" loss
runs on the same arrays, unshuffled, in evaluation mode. The best epoch's
weights and optimizer state are kept as a copy on the device.
``latest.pt`` (weights only) is written after an epoch at the rate the
writes allow (every epoch while one write costs less than an epoch), and
``best.pt`` and ``latest.pt`` with the optimizer state when the stage
ends.

Randomness comes from ``torch.Generator``s on the engine's device:
epoch ``e``'s permutation from ``(seed + 1, e, 0)``, its dropout from
``(seed + 1, e, 1)``; the initial weights from a CPU generator seeded with
``seed``. The JAX engine's streams cannot be reproduced, so training
agrees with it statistically.

Data parallelism (``mesh`` with a process group): each rank takes its
``shard_range`` of every global batch of the same permutation, the masked
cross entropy divides by the global token count, and the gradients are
summed over ranks; rank 0 alone writes checkpoints. Dropout draws on a
rank follow that rank's generator (equal on every rank, applied to its
own rows), so they differ from one process's draws; parity runs set
dropout to 0.

``sample_autoregressive`` is the KV-cached sampler: prompts are primed
one token at a time, logits divided by the temperature, the top-k filter
keeps ties at the k-th value, and each token is a categorical draw.
"""
from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import (Transformer, cross_entropy_loss,
                                  transformer_init_)
from ..parallel.mesh import get_mesh, shard_slice, sum_gradients
from ..utils.checkpoint import cpu_state_dict, save_checkpoint
from .loop import WriteCadence, padded_split, seeded_generator, to_device
from .state import make_optimizer


class TransformerEngine:
    def __init__(
        self,
        model: Transformer,
        lr: float,
        weight_decay: float = 0.0,
        grad_clip_max_norm: float = 0.0,
        cosine_t_max: Optional[int] = None,
        steps_per_epoch: int = 1,
        label_smoothing: float = 0.0,
        seed: int = 0,
        device=None,
        mesh=None,
    ):
        """``device`` None means CUDA (raises without it). ``mesh``
        defaults to ``get_mesh()``: data parallel over the process group
        when one is up."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.seed = seed
        self.mesh = mesh if mesh is not None else get_mesh()
        self.label_smoothing = float(label_smoothing)
        self.opt = make_optimizer(self.model.parameters(), lr, weight_decay,
                                  "adamw", grad_clip_max_norm, cosine_t_max,
                                  steps_per_epoch)
        self.step = 0  # optimizer updates so far

    def init_state(self) -> None:
        """flax-style initial weights drawn from ``seed``."""
        transformer_init_(self.model, seeded_generator("cpu", self.seed))

    def loss(self, x: torch.Tensor, targets: torch.Tensor,
             labels: torch.Tensor, mask: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Masked cross entropy of one batch; ``generator`` turns dropout
        on."""
        y = labels if self.model.num_classes > 0 else None
        logits = self.model(x, y=y, generator=generator)
        return cross_entropy_loss(logits, targets, mask=mask,
                                  label_smoothing=self.label_smoothing,
                                  mesh=self.mesh)

    def train_step(self, x, targets, labels, mask,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        self.model.train()
        loss = self.loss(x, targets, labels, mask, generator)
        self.opt.zero_grad()
        loss.backward()
        sum_gradients(self.model.parameters(), self.mesh)
        self.opt.step()
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, x, targets, labels, mask) -> torch.Tensor:
        self.model.eval()
        return self.loss(x, targets, labels, mask)

    def run_epoch(self, loader, train: bool, epoch: int) -> float:
        """One epoch over the loader's host batches (``loader.epoch``), as
        the JAX engine's per-batch ``run_epoch``: each batch moves to the
        device, training draws its dropout from a generator of its own,
        ``(seed + 1, epoch, 2, batch)``; the mean batch loss is summed on
        the device and read once."""
        total = None
        n = 0
        for i, batch in enumerate(loader.epoch(epoch)):
            mine = shard_slice(len(batch[0]), self.mesh)
            x, y, lab, mask = (to_device(np.asarray(a)[mine], self.device)
                               for a in batch)
            x, y, lab = x.long(), y.long(), lab.long()
            if train:
                loss = self.train_step(x, y, lab, mask, seeded_generator(
                    self.device, self.seed + 1, epoch, 2, i))
            else:
                loss = self.eval_step(x, y, lab, mask)
            total = loss if total is None else total + loss
            n += 1
        return float(total) / max(n, 1) if total is not None else 0.0

    def device_dataset(self, loader):
        """The loader's arrays on the device, padded to whole batches:
        (x, y, labels, mask, n_steps, n_pad)."""
        lab = (loader.labels if loader.labels is not None
               else np.zeros(len(loader.x), np.int32))
        tensors, mask, n_steps, n_pad = padded_split(
            [np.asarray(a, np.int64) for a in (loader.x, loader.y, lab)],
            loader.batch_size, self.device)
        return (*tensors, mask, n_steps, n_pad)

    def train(
        self,
        train_loader,
        val_loader,
        num_epochs: int,
        checkpoint_dir: Optional[Path] = None,
        logger=None,
    ) -> Transformer:
        """Train for ``num_epochs``; returns the model with the last
        epoch's weights (``best.pt`` holds the best epoch's). ``val_loader``
        is not read: as in the JAX engine, the validation loss runs on the
        training arrays, unshuffled."""
        ckpt = Path(checkpoint_dir) if checkpoint_dir is not None else None
        best_val = float("inf")
        best = None
        best_epoch = best_step = 0
        bs = train_loader.batch_size
        x, y, lab, mask, n_steps, n_pad = self.device_dataset(train_loader)
        mine = shard_slice(bs, self.mesh)
        eval_idx = torch.arange(n_steps * bs, device=self.device).view(
            n_steps, bs)[:, mine]

        cadence, last_write = WriteCadence(), 0
        for epoch in range(1, num_epochs + 1):
            t_ep = time.perf_counter()
            perm = torch.randperm(
                n_pad, generator=seeded_generator(self.device, self.seed + 1,
                                                  epoch, 0),
                device=self.device)
            drop_gen = seeded_generator(self.device, self.seed + 1, epoch, 1)
            losses = [self.train_step(x[ib], y[ib], lab[ib], mask[ib],
                                      drop_gen)
                      for ib in perm[:n_steps * bs].view(n_steps, bs)[:, mine]]
            tr_loss = float(torch.stack(losses).mean())
            t_train = time.perf_counter() - t_ep
            va_loss = float(torch.stack(
                [self.eval_step(x[ib], y[ib], lab[ib], mask[ib])
                 for ib in eval_idx]).mean())
            print(f"[transformer] epoch {epoch}/{num_epochs} "
                  f"train={tr_loss:.4f} val={va_loss:.4f} "
                  f"({time.perf_counter() - t_ep:.1f}s; {n_steps} steps in "
                  f"{t_train:.3f}s on {self.device})")
            if logger is not None:
                logger.log_metrics({"train_loss": tr_loss,
                                    "val_loss": va_loss,
                                    "train_steps": n_steps,
                                    "train_seconds": t_train}, step=epoch)
            if va_loss < best_val:
                best_val = va_loss
                best = ({k: v.clone() for k, v in
                         self.model.state_dict().items()},
                        copy.deepcopy(self.opt.state_dict()))
                best_epoch, best_step = epoch, self.step
            # weights-only latest.pt at the rate one write sustains
            dt_epoch = time.perf_counter() - t_ep
            if ckpt is not None and (epoch - last_write >= cadence.stride
                                     or epoch == num_epochs):
                t_ck = time.perf_counter()
                save_checkpoint(ckpt / "latest.pt", {
                    "model_state_dict": cpu_state_dict(self.model),
                    "step": self.step, "epoch": epoch})
                last_write = epoch
                cadence.record(time.perf_counter() - t_ck, dt_epoch)
        if ckpt is not None and best is not None:
            save_checkpoint(ckpt / "best.pt", {
                "model_state_dict": {k: v.cpu() for k, v in best[0].items()},
                "optimizer_state_dict": best[1],
                "step": best_step, "epoch": best_epoch})
        if ckpt is not None:
            save_checkpoint(ckpt / "latest.pt", {
                "model_state_dict": cpu_state_dict(self.model),
                "optimizer_state_dict": self.opt.state_dict(),
                "step": self.step, "epoch": num_epochs})
        return self.model


def top_k_filter(scaled: torch.Tensor, k: int) -> torch.Tensor:
    """-inf below the k-th largest value of each row; ties at the k-th
    value are kept (``where(scaled < kth, -inf, scaled)``)."""
    kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
    return torch.where(scaled < kth,
                       torch.full((), float("-inf"), device=scaled.device),
                       scaled)


def sample_next(logits: torch.Tensor, generator: torch.Generator,
                temperature: float = 1.0,
                top_k: Optional[int] = None) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (B, V) / ``temperature``,
    restricted to the top k; returns (B, 1) token ids."""
    scaled = logits / temperature
    if top_k is not None:
        scaled = top_k_filter(scaled, int(top_k))
    return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                             generator=generator)


@torch.no_grad()
def sample_autoregressive(
    model: Transformer,
    first_tokens: torch.Tensor,
    steps: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    labels: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KV-cached sampling of ``steps`` tokens after the prompt
    ``first_tokens`` (B, T0); returns (B, T0 + steps). Draws come from
    ``generator`` (on the model's device)."""
    model.eval()
    first_tokens = first_tokens.long()
    b, t0 = first_tokens.shape
    cache = model.init_cache(b)
    for i in range(t0):  # prime the cache one token at a time
        logits = model(first_tokens[:, i:i + 1], y=labels, cache=cache)[:, 0]
    toks = []
    for i in range(steps):
        tok = sample_next(logits, generator, temperature, top_k)
        toks.append(tok)
        if i + 1 < steps:
            logits = model(tok, y=labels, cache=cache)[:, 0]
    return torch.cat([first_tokens] + toks, dim=1)
