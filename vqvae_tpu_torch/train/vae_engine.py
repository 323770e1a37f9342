"""VAE training engine (flat and spatial topologies) — the port of
``vqvae_tpu/train/vae_engine.py``.

``train`` takes JAX's two paths, chosen as JAX chooses them:

- without augmentation (every preset), the device-resident epoch path:
  each split is padded with zero rows to a whole number of batches and
  kept on the engine's device with a validity mask (``device_dataset``);
  a training epoch draws one permutation over the *padded* rows, so the
  padding rows can land in any batch and enter its BatchNorm statistics;
  each step gathers its batch by index, and when the loss is not finite
  its gradients are replaced by zeros on the device (no host sync) before
  the optimizer steps, as JAX's NaN/Inf guard does; the epoch's metrics
  are the mean of the per-step (loss, recon, kl). Evaluation walks the
  padded rows in order and sums loss, recon, kl, PSNR * n, SSIM * n and
  n; the host divides by the step count and the split's size. Both
  epochs' numbers come back in one host read.
- with augmentation, the per-batch path (``run_epoch``) over the loader's
  host batches, without the guard, as JAX's ``run_epoch``.

Semantics kept from the JAX package: one optimizer step per padded, masked
batch; BatchNorm statistics replaced on every step; the loss uses a
reparameterized z in training and in evaluation; linear beta warm-up over
``kl_anneal_epochs``; early stop on the validation loss; the best state
kept as a copy on the device and ``best.pt`` written at the rate one write
sustains (every epoch while a write costs less than an epoch); ``best.pt``
+ ``latest.pt`` at the end; epoch metrics under the reference's names;
then, from the best weights, the latent dump of both splits in dataset
order (mu, logvar and z sampled from ``seed + 2``) and a reconstruction
grid.

Randomness comes from ``torch.Generator``s derived from the seed: the
initial weights from a CPU generator, so every device starts from the same
weights; the noise from generators on the engine's device, so a step
draws it where it is used: training from ``(seed + 1, epoch, 0)`` (the
epoch path's permutation first, then the noise), evaluation noise from
``(seed + 1, epoch, 1)``. (The card's and the CPU's generators give
different streams from one seed, and both differ from JAX's.)

Data parallelism (``mesh``, a ``parallel.Mesh`` with a process group): as
JAX shards each batch over its mesh, each rank takes its ``shard_range``
of every global batch of the same permutation (drawn from a generator
seeded alike on every rank) and the noise of the whole batch, taking its
rows, so the ranks together draw what one process would. BatchNorm
statistics, the loss's denominators and its capacity term are global
(``models.vae``), the gradients are summed over ranks, and the NaN guard
decides on the global loss, so every rank takes the same update. The
evaluation's PSNR and SSIM are the global batch's. Latents are encoded
sharded and gathered. Rank 0 alone writes checkpoints, latents, the
reconstruction grid and metrics.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DataLoader
from ..device import resolve_device
from ..eval.metrics import ssim_simple
from ..models.vae import VAE, flax_init_, reparameterize, set_batchnorm_mesh
from ..parallel.mesh import (all_gather_rows, all_reduce_sum, get_mesh,
                             is_primary, shard_range, sum_gradients)
from ..utils.checkpoint import cpu_state_dict, save_checkpoint
from ..utils.images import save_image_grid
from ..utils.latents import save_latents
from .state import make_optimizer


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` (through pinned memory, without waiting
    for the device, on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _device_copy(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``model.state_dict()`` where the model lives."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.to("cpu", copy=True) for k, v in sd.items()}


class _EpochTimer:
    """Seconds of a span of work: CUDA events on the card (read after the
    epoch's one host read, so timing adds no sync), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = self.t1 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            return self.start.elapsed_time(self.end) / 1e3
        return self.t1 - self.t0


class VAEEngine:
    def __init__(
        self,
        model: VAE,
        lr: float,
        weight_decay: float = 0.0,
        optimizer: str = "adamw",
        grad_clip_max_norm: float = 0.0,
        cosine_t_max: Optional[int] = None,
        steps_per_epoch: int = 1,
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
        set_batchnorm_mesh(self.model, self.mesh)
        self.opt = make_optimizer(self.model.parameters(), lr, weight_decay,
                                  optimizer, grad_clip_max_norm,
                                  cosine_t_max, steps_per_epoch)
        self.step = 0  # optimizer updates so far (the loss's capacity step)

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        return slice(*shard_range(n, self.mesh))

    def _noise_rows(self, n: int) -> Tuple[int, int]:
        return self.local_rows(n).start, n

    def _rows_of(self, images: torch.Tensor, noise_rows, generator):
        """``noise_rows``, or the whole batch at world size 1; a rank of a
        data-parallel group that draws noise must say where its rows
        lie."""
        if noise_rows is not None:
            return noise_rows
        if generator is not None and self.mesh.world_size > 1:
            raise ValueError("a data-parallel step with noise needs "
                             "noise_rows=(start, global batch rows) of this "
                             "rank's block")
        return 0, images.shape[0]

    def init_state(self) -> None:
        """Flax-default weights drawn from ``seed``."""
        flax_init_(self.model, seeded_generator("cpu", self.seed))

    # -- steps ---------------------------------------------------------------
    def train_step(self, images: torch.Tensor, mask: torch.Tensor,
                   beta: float, generator: torch.Generator,
                   nan_guard: bool = False,
                   noise_rows=None) -> Dict[str, torch.Tensor]:
        """One optimizer step. ``nan_guard``: when the loss is not finite
        the gradients become zeros (decided on the device) and the
        optimizer still steps, as the JAX epoch path does. Under data
        parallelism ``images`` are this rank's rows of the global batch
        and ``noise_rows`` their (start, global rows)."""
        self.model.train()
        x_logits, mu, logvar, _ = self.model(
            images, generator, self._rows_of(images, noise_rows, generator))
        total, recon, kl = self.model.loss(
            images, x_logits, mu, logvar, beta=beta, mask=mask,
            step=self.step, mesh=self.mesh)
        self.opt.zero_grad()
        total.backward()
        sum_gradients(self.model.parameters(), self.mesh)
        if nan_guard:
            finite = torch.isfinite(total.detach())
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad = torch.where(finite, p.grad,
                                             torch.zeros_like(p.grad))
        self.opt.step()
        self.step += 1
        return {"loss": total.detach(), "recon": recon.detach(),
                "kl": kl.detach()}

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, mask: torch.Tensor,
                  beta: float, generator: torch.Generator,
                  noise_rows=None) -> Dict[str, torch.Tensor]:
        self.model.eval()
        x_logits, mu, logvar, _ = self.model(
            images, generator, self._rows_of(images, noise_rows, generator))
        total, recon, kl = self.model.loss(images, x_logits, mu, logvar,
                                           beta=beta, mask=mask,
                                           step=self.step, mesh=self.mesh)
        x_rec = torch.sigmoid(x_logits) if self.model.apply_sigmoid \
            else x_logits
        x_rec = torch.clamp(x_rec, 0.0, 1.0)
        # the global batch's PSNR and SSIM (``psnr`` and ``ssim_simple``
        # with ``mask``) from summed squared errors, summed per-image SSIM
        # and the valid rows
        n_loc = mask.sum()
        se = (((x_rec - images) ** 2).sum(tuple(range(1, images.ndim)))
              * mask).sum()
        ss = ssim_simple(x_rec, images, mask=mask) * torch.clamp_min(n_loc,
                                                                     1.0)
        se, ss, n = all_reduce_sum(torch.stack([se, ss, n_loc]), self.mesh)
        n_per = float(np.prod(images.shape[1:]))
        mse = torch.clamp_min(se / torch.clamp_min(n * n_per, 1.0), 1e-12)
        return {"loss": total, "recon": recon, "kl": kl,
                "psnr": 10.0 * torch.log10(1.0 / mse),
                "ssim": ss / torch.clamp_min(n, 1.0), "n": n}

    # -- device-resident epoch path -----------------------------------------
    def device_dataset(self, loader: DataLoader, batch_size: int):
        """The split zero-padded to a whole number of batches, on the
        device: (images, mask, steps, padded rows)."""
        images = loader.split.images
        n = images.shape[0]
        n_steps = max(1, (n + batch_size - 1) // batch_size)
        n_pad = n_steps * batch_size
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0
        if n_pad > n:
            images = np.concatenate(
                [images, np.zeros((n_pad - n, *images.shape[1:]),
                                  images.dtype)])
        return (to_device(images, self.device), to_device(mask, self.device),
                n_steps, n_pad)

    def train_epoch(self, data: torch.Tensor, mask_all: torch.Tensor,
                    perm: torch.Tensor, beta: float, n_steps: int,
                    batch_size: int, generator: torch.Generator
                    ) -> torch.Tensor:
        """Steps over ``perm`` (indices into the padded rows), guarded;
        returns the mean per-step (loss, recon, kl) on the device. Under
        data parallelism each step takes this rank's rows of the batch."""
        sums = torch.zeros(3, device=self.device)
        mine = self.local_rows(batch_size)
        for i in range(n_steps):
            ib = perm[i * batch_size:(i + 1) * batch_size][mine]
            m = self.train_step(data[ib], mask_all[ib], beta, generator,
                                nan_guard=True,
                                noise_rows=self._noise_rows(batch_size))
            sums += torch.stack([m["loss"], m["recon"], m["kl"]])
        return sums / n_steps

    @torch.no_grad()
    def eval_epoch(self, data: torch.Tensor, mask_all: torch.Tensor,
                   beta: float, n_steps: int, batch_size: int,
                   generator: torch.Generator) -> torch.Tensor:
        """The padded rows in order; returns the device sums of (loss,
        recon, kl, PSNR * n, SSIM * n, n), n the batch's real rows."""
        sums = torch.zeros(6, device=self.device)
        mine = self.local_rows(batch_size)
        for i in range(n_steps):
            sl = slice(i * batch_size + mine.start, i * batch_size + mine.stop)
            m = self.eval_step(data[sl], mask_all[sl], beta, generator,
                               self._noise_rows(batch_size))
            sums += torch.stack([m["loss"], m["recon"], m["kl"],
                                 m["psnr"] * m["n"], m["ssim"] * m["n"],
                                 m["n"]])
        return sums

    # -- loops ---------------------------------------------------------------
    def run_epoch(self, loader: DataLoader, train: bool, epoch: int,
                  beta: float) -> Dict[str, float]:
        """One epoch; sums stay on the device until its end. Loss, recon
        and kl are means over batches; eval PSNR/SSIM are weighted by the
        real rows of each batch."""
        gen = seeded_generator(self.device, self.seed + 1, epoch,
                               0 if train else 1)
        acc: Optional[Dict[str, torch.Tensor]] = None
        n_batches = 0
        for images, _, mask in loader.epoch(epoch):
            mine, rows = self.local_rows(len(mask)), \
                self._noise_rows(len(mask))
            x = to_device(images[mine], self.device)
            m = to_device(mask[mine], self.device)
            if train:
                out = self.train_step(x, m, beta, gen, noise_rows=rows)
            else:
                out = self.eval_step(x, m, beta, gen, noise_rows=rows)
                out["psnr"] = out["psnr"] * out["n"]
                out["ssim"] = out["ssim"] * out["n"]
            n_batches += 1
            acc = out if acc is None else {k: acc[k] + out[k] for k in acc}
        if acc is None:
            return {}
        keys = list(acc)
        vals = dict(zip(keys, torch.stack([acc[k] for k in keys]).tolist()))
        res = {k: vals[k] / max(n_batches, 1) for k in ("loss", "recon", "kl")}
        if not train and vals.get("n", 0.0) > 0:
            res["psnr"] = vals["psnr"] / vals["n"]
            res["ssim"] = vals["ssim"] / vals["n"]
        res["steps"] = n_batches
        return res

    def train(
        self,
        train_loader: DataLoader,
        val_loader: DataLoader,
        num_epochs: int,
        early_stop: int = 0,
        checkpoint_dir: Optional[Path] = None,
        logger=None,
        output_dir: Optional[Path] = None,
        save_latents_flag: bool = True,
        kl_anneal_epochs: int = 0,
        beta: float = 1.0,
    ) -> VAE:
        """Train; returns the model, holding the best epoch's weights (the
        ones ``best.pt`` and the latent dumps carry). The epoch path runs
        unless the training loader augments."""
        if output_dir is not None:
            Path(output_dir).mkdir(parents=True, exist_ok=True)
        best_val = float("inf")
        no_improve = 0
        num_pixels = int(np.prod(train_loader.split.image_shape))
        best_sd = _device_copy(self.model)
        best_epoch = 0
        save_stride, write_est, last_best_write = 1, 0.0, 0
        fast = not train_loader.augment
        if fast:
            bs = train_loader.batch_size
            tr_data, tr_mask, tr_steps, tr_pad = self.device_dataset(
                train_loader, bs)
            va_data, va_mask, va_steps, _ = self.device_dataset(val_loader,
                                                                bs)
            va_n = float(val_loader.num_examples)
        for epoch in range(1, num_epochs + 1):
            t_ep = time.perf_counter()
            cur_beta = (beta * min(1.0, epoch / kl_anneal_epochs)
                        if kl_anneal_epochs > 0 else beta)
            if fast:
                timer = _EpochTimer(self.device)
                gen = seeded_generator(self.device, self.seed + 1, epoch, 0)
                perm = torch.randperm(tr_pad, generator=gen,
                                      device=self.device)
                tr_m = self.train_epoch(tr_data, tr_mask, perm, cur_beta,
                                        tr_steps, bs, gen)
                timer.stop()
                va_sums = self.eval_epoch(
                    va_data, va_mask, cur_beta, va_steps, bs,
                    seeded_generator(self.device, self.seed + 1, epoch, 1))
                vals = torch.cat([tr_m, va_sums]).tolist()  # one host read
                t_train = timer.seconds()
                tr = {"loss": vals[0], "recon": vals[1], "kl": vals[2],
                      "steps": tr_steps}
                va = {"loss": vals[3] / va_steps,
                      "recon": vals[4] / va_steps,
                      "kl": vals[5] / va_steps,
                      "psnr": vals[6] / max(va_n, 1.0),
                      "ssim": vals[7] / max(va_n, 1.0)}
            else:
                tr = self.run_epoch(train_loader, True, epoch, cur_beta)
                t_train = time.perf_counter() - t_ep
                va = self.run_epoch(val_loader, False, epoch, cur_beta)
            if logger is not None:
                logger.log_metrics({
                    "train_loss": tr["loss"], "train_recon": tr["recon"],
                    "train_kl": tr["kl"], "val_loss": va["loss"],
                    "val_recon": va["recon"], "val_kl": va["kl"],
                    "beta": cur_beta,
                    "val_psnr": va.get("psnr", 0.0),
                    "val_ssim": va.get("ssim", 0.0),
                    "train_recon_per_pixel": tr["recon"] / num_pixels,
                    "val_recon_per_pixel": va["recon"] / num_pixels,
                    "train_steps": tr["steps"], "train_seconds": t_train,
                }, step=epoch)
            print(f"[vae] epoch {epoch}/{num_epochs} beta={cur_beta:.4f} "
                  f"train={tr['loss']:.4f} val={va['loss']:.4f} "
                  f"psnr={va.get('psnr', 0.0):.2f} "
                  f"ssim={va.get('ssim', 0.0):.4f} "
                  f"({time.perf_counter() - t_ep:.1f}s; {tr['steps']} steps "
                  f"in {t_train:.3f}s on {self.device})")

            dt_epoch = time.perf_counter() - t_ep
            if va["loss"] < best_val:
                best_val = va["loss"]
                no_improve = 0
                best_sd = _device_copy(self.model)
                best_epoch = epoch
                # weights-only best.pt at the rate one write sustains,
                # gated on epochs since the last write, as JAX's cadence
                if checkpoint_dir is not None and is_primary() and (
                        epoch - last_best_write >= save_stride
                        or epoch == num_epochs):
                    t_ck = time.perf_counter()
                    save_checkpoint(Path(checkpoint_dir) / "best.pt",
                                    {"model_state_dict": _cpu(best_sd),
                                     "epoch": epoch})
                    last_best_write = epoch
                    write_est = max(time.perf_counter() - t_ck,
                                    0.7 * write_est)
                    save_stride = max(1, min(
                        25, int(write_est / max(dt_epoch, 1e-3))))
            else:
                no_improve += 1
                if early_stop and no_improve >= early_stop:
                    print(f"[vae] early stopping at epoch {epoch}")
                    break

        if checkpoint_dir is not None and is_primary():
            ckpt = Path(checkpoint_dir)
            save_checkpoint(ckpt / "best.pt", {"model_state_dict":
                                               _cpu(best_sd),
                                               "epoch": best_epoch})
            save_checkpoint(ckpt / "latest.pt", {
                "model_state_dict": cpu_state_dict(self.model),
                "optimizer_state_dict": self.opt.state_dict(),
                "step": self.step, "epoch": num_epochs})
        self.model.load_state_dict(best_sd)
        if save_latents_flag and output_dir is not None:
            self.dump_latents(train_loader, Path(output_dir) / "latents_train")
            self.dump_latents(val_loader, Path(output_dir) / "latents_val")
        if output_dir is not None and is_primary():
            self._save_recon_grid(val_loader, Path(output_dir), logger)
        return self.model

    # -- artifact dumps ------------------------------------------------------
    @torch.no_grad()
    def dump_latents(self, loader: DataLoader, out_dir: Path) -> Path:
        """Encode the whole split in dataset order (so latents align with
        labels and codes downstream); z is sampled from ``seed + 2``.
        Under data parallelism each rank encodes its rows of each batch
        and the rows are gathered; rank 0 writes."""
        self.model.eval()
        gen = seeded_generator(self.device, self.seed + 2)
        images = loader.split.images
        bs = loader.batch_size
        zs, mus, lvs = [], [], []
        for s in range(0, images.shape[0], bs):
            b = min(bs, images.shape[0] - s)
            mine = self.local_rows(b)
            x = to_device(images[s + mine.start:s + mine.stop], self.device)
            mu, logvar = self.model.encode(x)
            z = reparameterize(mu, logvar, gen, rows=(mine.start, b))
            z, mu, logvar = (all_gather_rows(t, b, self.mesh)
                             for t in (z, mu, logvar))
            zs.append(z.cpu())
            mus.append(mu.cpu())
            lvs.append(logvar.cpu())
        out_dir = Path(out_dir)
        if not is_primary():
            return out_dir / "latents.npz"
        return save_latents(out_dir, torch.cat(zs).numpy(),
                            torch.cat(mus).numpy(), torch.cat(lvs).numpy(),
                            loader.split.labels)

    @torch.no_grad()
    def _save_recon_grid(self, val_loader: DataLoader, output_dir: Path,
                         logger=None) -> None:
        self.model.eval()
        images, _, _ = next(iter(val_loader.epoch(0)))
        x_logits, _, _, _ = self.model(to_device(images, self.device),
                                       seeded_generator(self.device, 0))
        # display space is [0, 1]: sigmoid outputs are already there, while
        # non-sigmoid reconstructions live in the dataset's normalized space
        if self.model.apply_sigmoid:
            x_rec = torch.sigmoid(x_logits).cpu().numpy()
        else:
            x_rec = val_loader.split.denormalize(x_logits.cpu().numpy())
        x = val_loader.split.denormalize(images)
        grid = np.concatenate([np.clip(x[:8], 0, 1),
                               np.clip(x_rec[:8], 0, 1)])
        path = save_image_grid(grid, output_dir / "recon_grid.png", nrow=8)
        if logger is not None:
            logger.log_artifact(path)
