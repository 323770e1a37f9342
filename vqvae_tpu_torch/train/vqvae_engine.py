"""End-to-end EMA VQ-VAE baseline trainer — the port of
``vqvae_tpu/train/vqvae_engine.py``.

One step (``train_step``): encode, quantize, straight-through, decode; the
loss is the L1 reconstruction averaged over the batch's valid rows plus
``beta * mse(sg(z_q), z_e)``; then one Adam step (weight decay ignored, as
JAX's positional ``make_optimizer(lr, weight_decay, "adam", grad_clip)``
makes it, grads clipped by global norm), then the EMA codebook update on
that forward's ``z_e`` and codes, then the latent bank rolls by 256 random
latents of the batch (drawn without replacement). Metrics: loss, rec, vq,
q_mse, perplex, usage and dead from the batch's code histogram.

The NaN guard is JAX's, without a host sync: when the loss is not finite
the gradients are replaced by zeros and the optimizer still steps (Adam's
moments and count advance, as in optax), and the codebook is kept.

``train`` takes JAX's device-resident epoch path (``train()`` there takes
it whenever ``augment`` is off, which it always is for this model): the
split is mapped to [-1, 1] once, padded with zero rows to a whole number
of steps and masked; each epoch draws one permutation over the *padded*
set; metrics are weighted by each step's ``mask.sum()``; validation runs
unshuffled. As in JAX only ``rec`` is masked, so padding rows enter vq,
q_mse, the perplexity, the EMA update and the bank. After each epoch:
dead codes (EMA count under 5) are reseeded from the bank, the embed-norm
statistics and the reseed count join the logged row, a reconstruction
grid is written every ``samples_every`` epochs, ``best.pt`` follows the
validation loss and ``latest.pt`` is written at an adaptive cadence (the
rate one write sustains).

Randomness comes from ``torch.Generator``s on the engine's device seeded
from ``(seed + 1, epoch, ...)``: the permutation, the bank draws and the
reseed picks follow other streams than JAX's.

Data parallelism (``mesh`` with a process group): each rank takes its
``shard_range`` of every global batch of the same permutation. Every batch
statistic is the global batch's, as JAX computes it under its mesh: the
masked L1 denominator, the commitment loss and ``q_mse``, the EMA counts
and sums, the code histogram (usage, perplexity). The bank's 256 rows are
drawn over the global flattened batch from a generator every rank shares;
each rank fills the rows it holds into a zero block and one all-reduce
completes it. Gradients are summed over ranks; the dead-code picks are
the same on every rank. Rank 0 alone writes checkpoints and grids.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.vae import flax_init_
from ..models.vqvae_baseline import (VQVAE, CodebookState, ema_update,
                                     quantize, reseed_dead_codes,
                                     straight_through)
from ..parallel.mesh import (all_reduce_sum, get_mesh, global_value,
                             is_primary, shard_range, sum_gradients)
from ..utils.checkpoint import save_baseline_checkpoint
from ..utils.images import save_image_grid
from .state import make_optimizer
from .vae_engine import seeded_generator, to_device

METRIC_KEYS = ("loss", "rec", "vq", "q_mse", "perplex", "usage", "dead")


class VQVAEEngine:
    def __init__(
        self,
        model: VQVAE,
        n_codes: int = 512,
        beta: float = 0.25,
        ema_decay: float = 0.99,
        ema_eps: float = 1e-5,
        lr: float = 2e-4,
        weight_decay: float = 0.0,
        grad_clip: float = 1.0,
        bank_size: int = 8192,
        seed: int = 0,
        device=None,
        mesh=None,
    ):
        """``device`` None means CUDA (raises without it). ``weight_decay``
        is accepted and ignored: the optimizer is Adam. ``mesh`` defaults
        to ``get_mesh()``: data parallel over the process group when one
        is up."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh if mesh is not None else get_mesh()
        self.n_codes = n_codes
        self.beta = beta
        self.ema_decay = ema_decay
        self.ema_eps = ema_eps
        self.bank_size = bank_size
        self.seed = seed
        self.opt = make_optimizer(self.model.parameters(), lr, weight_decay,
                                  "adam", grad_clip)

    def init_state(self) -> Tuple[CodebookState, torch.Tensor]:
        """Flax-default weights and a standard-normal codebook drawn from
        ``seed`` on the CPU (every device starts from the same state), and
        an empty latent bank. Returns (codebook, bank)."""
        flax_init_(self.model, seeded_generator("cpu", self.seed))
        cb = CodebookState.create(seeded_generator("cpu", self.seed, 1),
                                  self.n_codes, self.model.z_channels,
                                  device=self.device)
        bank = torch.zeros((self.bank_size, self.model.z_channels),
                           device=self.device)
        return cb, bank

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        return slice(*shard_range(n, self.mesh))

    # -- steps ---------------------------------------------------------------
    def _forward(self, cb: CodebookState, x: torch.Tensor,
                 mask: torch.Tensor):
        """(loss, rec, vq, z_e, z_q, idx, global valid rows); the loss
        terms are the global batch's (at world size 1, this batch's)."""
        z_e = self.model.encode(x)
        with torch.no_grad():
            z_q, idx = quantize(cb, z_e)
        x_rec = self.model.decode(straight_through(z_e, z_q))
        per = torch.abs(x_rec - x).mean(dim=(1, 2, 3))
        # commitment_loss's beta * mse(sg(z_q), z_e) over the global batch
        sq = ((z_q.detach() - z_e.float()) ** 2).sum()
        sums = global_value(torch.stack([
            (per * mask).sum(), mask.sum(), sq,
            torch.full_like(sq, float(z_e.numel()))]), self.mesh)
        rec = sums[0] / torch.clamp_min(sums[1], 1.0)
        vq = self.beta * (sums[2] / sums[3])
        return rec + vq, rec, vq, z_e, z_q, idx, sums[1].detach()

    def _metrics(self, loss, rec, vq, z_e, z_q, idx, n
                 ) -> Dict[str, torch.Tensor]:
        """The step's metrics over the global batch; ``n`` (the global
        valid rows) rides along for the epoch's weighting."""
        with torch.no_grad():
            hist = torch.bincount(idx.reshape(-1),
                                  minlength=self.n_codes).float()
            both = all_reduce_sum(torch.cat([
                hist, ((z_q - z_e) ** 2).sum()[None],
                hist.new_full((1,), float(z_e.numel()))]), self.mesh)
            hist, q_mse = both[:-2], both[-2] / both[-1]
            usage = (hist > 0).float().mean()
            p = hist / torch.clamp_min(hist.sum(), 1.0)
            perplex = torch.exp(-(p * torch.log(p + 1e-12)).sum())
            return {"loss": loss.detach(), "rec": rec.detach(),
                    "vq": vq.detach(), "q_mse": q_mse, "perplex": perplex,
                    "usage": usage, "dead": 1.0 - usage, "n": n}

    def train_step(self, cb: CodebookState, bank: torch.Tensor,
                   x: torch.Tensor, mask: torch.Tensor,
                   generator: torch.Generator, rows=None
                   ) -> Tuple[CodebookState, torch.Tensor,
                              Dict[str, torch.Tensor]]:
        """One step on images ``x`` in [-1, 1] (B, H, W, C) with row mask
        ``mask`` (B,); ``generator`` draws the bank's latents on its own
        device. ``rows`` (start, global rows): ``x`` holds rows
        ``start:start + B`` of a global batch, as under data parallelism,
        where it must be given (``local_rows``); None means ``x`` is the
        whole batch. Returns (codebook, bank, metrics)."""
        if rows is None:
            if self.mesh.world_size > 1:
                raise ValueError(
                    "train_step under data parallelism needs rows=(start, "
                    "global batch rows) of this rank's block")
            rows = (0, x.shape[0])
        self.model.train()
        out = self._forward(cb, x, mask)
        loss, z_e, idx = out[0], out[3], out[5]
        self.opt.zero_grad()
        loss.backward()
        sum_gradients(self.model.parameters(), self.mesh)
        metrics = self._metrics(*out)
        finite = torch.isfinite(loss.detach())
        with torch.no_grad():
            for p in self.model.parameters():
                # real zeros: torch's Adam skips a parameter without .grad
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = torch.where(finite, g, torch.zeros_like(g))
        self.opt.step()

        with torch.no_grad():
            z_e = z_e.detach()
            new = ema_update(cb, z_e, idx, self.ema_decay, self.ema_eps,
                             mesh=self.mesh)
            cb = CodebookState(**{
                k: torch.where(finite, v, getattr(cb, k))
                for k, v in new.as_dict().items()})
            new = self._bank_rows(z_e, rows, generator)
            bank = torch.cat([bank[new.shape[0]:], new])
        return cb, bank, metrics

    def _bank_rows(self, z_e: torch.Tensor, rows,
                   generator: torch.Generator) -> torch.Tensor:
        """The latents that roll into the bank: min(256, latents, bank
        size) rows of the global flattened batch drawn without
        replacement; each rank fills the rows it holds into a zero block
        and one all-reduce completes it (exact: one nonzero term per
        row)."""
        flat = z_e.reshape(-1, z_e.shape[-1])
        per_image = z_e.shape[1] * z_e.shape[2]
        n = rows[1] * per_image
        take = min(256, n, self.bank_size)
        sel = torch.randperm(n, generator=generator,
                             device=generator.device)[:take].to(flat.device)
        lo = rows[0] * per_image
        mine = (sel >= lo) & (sel < lo + flat.shape[0])
        out = torch.zeros((take, flat.shape[1]), dtype=flat.dtype,
                          device=flat.device)
        out[mine] = flat[sel[mine] - lo]
        return all_reduce_sum(out, self.mesh)

    @torch.no_grad()
    def eval_step(self, cb: CodebookState, x: torch.Tensor,
                  mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self._metrics(*self._forward(cb, x, mask))

    # -- device-resident epochs ----------------------------------------------
    def device_dataset(self, loader, batch_size: int):
        """The split mapped to [-1, 1] once, zero-padded to a whole number
        of steps, on the device: (images, mask, steps, padded rows)."""
        x = loader.split.denormalize(loader.split.images).astype(np.float32)
        x = x * 2.0 - 1.0
        n = x.shape[0]
        n_steps = max(1, (n + batch_size - 1) // batch_size)
        n_pad = n_steps * batch_size
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0
        if n_pad > n:
            x = np.concatenate([x, np.zeros((n_pad - n, *x.shape[1:]),
                                            np.float32)])
        return (to_device(x, self.device), to_device(mask, self.device),
                n_steps, n_pad)

    def train_epoch(self, cb, bank, data, mask_all, n_steps: int,
                    batch_size: int, epoch: int):
        """One epoch over a permutation of the padded set; returns
        (codebook, bank, metric sums weighted by each step's valid rows,
        with the row count last)."""
        gen = seeded_generator(self.device, self.seed + 1, epoch, 0)
        perm = torch.randperm(n_steps * batch_size, generator=gen,
                              device=self.device)
        sums = torch.zeros(len(METRIC_KEYS) + 1, device=self.device)
        mine = self.local_rows(batch_size)
        rows = (mine.start, batch_size)
        for i in range(n_steps):
            ib = perm[i * batch_size:(i + 1) * batch_size][mine]
            cb, bank, m = self.train_step(cb, bank, data[ib], mask_all[ib],
                                          gen, rows)
            sums += self._weighted(m)
        return cb, bank, sums

    @torch.no_grad()
    def eval_epoch(self, cb, data, mask_all, n_steps: int,
                   batch_size: int) -> torch.Tensor:
        sums = torch.zeros(len(METRIC_KEYS) + 1, device=self.device)
        mine = self.local_rows(batch_size)
        for i in range(n_steps):
            sl = slice(i * batch_size + mine.start,
                       i * batch_size + mine.stop)
            sums += self._weighted(self.eval_step(cb, data[sl],
                                                  mask_all[sl]))
        return sums

    @staticmethod
    def _weighted(m: Dict[str, torch.Tensor]):
        """The step's metrics times its (global) valid rows, then the
        rows."""
        bs = m["n"]
        return torch.cat([torch.stack([m[k] for k in METRIC_KEYS]) * bs,
                          bs[None]])

    @staticmethod
    def metrics_from_sums(sums: torch.Tensor) -> Dict[str, float]:
        vals = sums.tolist()
        n = max(vals[-1], 1.0)
        return {k: v / n for k, v in zip(METRIC_KEYS, vals[:-1])}

    def train(
        self,
        cb: CodebookState,
        bank: torch.Tensor,
        train_loader,
        val_loader,
        num_epochs: int,
        checkpoint_dir: Optional[Path] = None,
        logger=None,
        output_dir: Optional[Path] = None,
        samples_every: int = 1,
        reseed_min_count: float = 5.0,
    ) -> Tuple[CodebookState, torch.Tensor]:
        """Train ``num_epochs``; returns (codebook, bank). The model keeps
        the last epoch's weights."""
        bs = train_loader.batch_size
        tr_data, tr_mask, tr_steps, _ = self.device_dataset(train_loader, bs)
        va_data, va_mask, va_steps, _ = self.device_dataset(val_loader, bs)
        best_loss = float("inf")
        save_stride, write_est = 1, 0.0
        for ep in range(1, num_epochs + 1):
            t_ep = time.perf_counter()
            cb, bank, tr_sums = self.train_epoch(cb, bank, tr_data, tr_mask,
                                                 tr_steps, bs, ep)
            tr = self.metrics_from_sums(tr_sums)
            t_train = time.perf_counter() - t_ep
            te = self.metrics_from_sums(self.eval_epoch(
                cb, va_data, va_mask, va_steps, bs))
            cb, n_reseeded = reseed_dead_codes(
                seeded_generator(self.device, self.seed + 1, ep, 999), cb,
                bank, reseed_min_count)
            norms = torch.linalg.vector_norm(cb.embed, dim=1).cpu().numpy()
            print(f"[vqvae] epoch {ep}/{num_epochs} train={tr['loss']:.4f} "
                  f"val={te['loss']:.4f} ppl={te['perplex']:.1f} "
                  f"usage={te['usage']:.2f} reseeded={n_reseeded} "
                  f"({time.perf_counter() - t_ep:.1f}s; {tr_steps} steps "
                  f"in {t_train:.3f}s on {self.device})")
            if logger is not None:
                row = {f"train_{k}": v for k, v in tr.items()}
                row.update({f"val_{k}": v for k, v in te.items()})
                row.update({"embed_norm_mean": float(norms.mean()),
                            "embed_norm_min": float(norms.min()),
                            "embed_norm_max": float(norms.max()),
                            "reseeded": n_reseeded,
                            "train_steps": tr_steps,
                            "train_seconds": t_train})
                logger.log_metrics(row, step=ep)
            if (output_dir is not None and ep % samples_every == 0
                    and is_primary()):
                self.save_recons(cb, val_loader, Path(output_dir), ep)
            dt_epoch = time.perf_counter() - t_ep
            if checkpoint_dir is not None and (ep % save_stride == 0
                                               or ep == num_epochs):
                t_ck = time.perf_counter()
                save_baseline_checkpoint(Path(checkpoint_dir) / "latest.pt",
                                         self.model, self.opt, cb, ep)
                write_est = max(time.perf_counter() - t_ck, 0.7 * write_est)
                save_stride = max(1, min(
                    25, int(write_est / max(dt_epoch, 1e-3))))
            if checkpoint_dir is not None and te["loss"] < best_loss:
                best_loss = te["loss"]
                save_baseline_checkpoint(Path(checkpoint_dir) / "best.pt",
                                         self.model, self.opt, cb, ep)
        return cb, bank

    @torch.no_grad()
    def save_recons(self, cb: CodebookState, loader, outdir: Path,
                    epoch: int) -> Path:
        """Reconstructions of the first 32 images of the unshuffled split,
        as ``recon_epoch<NNNN>.png`` (8 a row)."""
        self.model.eval()
        images, _, _ = next(iter(loader.epoch(0)))
        x01 = loader.split.denormalize(images[:32]).astype(np.float32)
        z_e = self.model.encode(to_device(x01 * 2.0 - 1.0, self.device))
        z_q, _ = quantize(cb, z_e)
        img = ((self.model.decode(z_q) + 1.0) / 2.0).cpu().numpy()
        return save_image_grid(img, outdir / f"recon_epoch{epoch:04d}.png",
                               nrow=8)
