"""Traffic kind ``kl_vae_epochs``: the VAE stage's device-resident epoch
path training FLUX.1's KL autoencoder (``models/autoencoder_kl.py``).

As ``vae_epochs`` (whose padding, end-to-end metric and release it takes),
with the configuration's published widths: set-up makes the train and
eval splits on the device (3 x side x side images in [-1, 1], the seeded
banded blobs of ``inputs.images`` mapped from [0, 1]) and the weights
(PyTorch's module defaults from the seed, ``reference/autoencoder_kl.py``),
builds the program's ``VAEEngine`` with a constant learning rate, drives it
through ``held_steps`` steps with the window's own call and copies its
state around each (``trainheld``), then one eval pass. The window runs
whole epochs: a fresh device permutation, ``train_epoch`` over every
batch, ``eval_epoch`` over the eval split, one host read an epoch.

The check holds the held steps against the plain reference on the run's
device, from the program's state before each step, after the program's
state is released: ``loss_gap``, ``grad_gap``, ``change_gap`` and
``start_gap`` (GroupNorm keeps no running statistics, so no
``stats_gap``). The reference takes the batch ``REF_CHUNK`` images at a
time to stay within the card's memory.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from .. import inputs, tracing, trainheld, yardstick_kl
from ..reference import autoencoder_kl as ref_kl
from .vae_epochs import _pad, end_to_end, release  # noqa: F401

REF_CHUNK = 4
MODEL_KEYS = ("in_channels", "out_channels", "block_out_channels",
              "layers_per_block", "latent_channels", "norm_num_groups")


def _signed_images(n: int, shape, seed: int, tag: int, dev):
    x, _ = inputs.images(n, shape, False, seed, tag, dev)
    return x * 2.0 - 1.0


def setup(cell) -> Dict:
    from vqvae_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from vqvae_tpu_torch.train.vae_engine import VAEEngine

    cfg, dev, seed = cell.config, cell.device, cell.seed
    d, t = cfg["data"], cfg["vae_train"]
    bs = t["batch_size"]
    n_tr, n_va = d["train_size"], d["eval_size"]
    tr_steps, va_steps = -(-n_tr // bs), -(-n_va // bs)
    if cell.traffic["held_steps"] > tr_steps:
        raise ValueError("the held steps need as many whole batches")
    tr, tr_mask = _pad(_signed_images(n_tr, d["image_shape"], seed, 1, dev),
                       tr_steps * bs)
    va, va_mask = _pad(_signed_images(n_va, d["image_shape"], seed, 2, dev),
                       va_steps * bs)
    init = ref_kl.initial_state(cfg, seed, 3, dev)
    model = AutoencoderKL(**{k: (tuple(cfg[k]) if isinstance(cfg[k], list)
                                 else cfg[k]) for k in MODEL_KEYS})
    model.load_state_dict({k: x.clone() for k, x in init.items()})
    engine = VAEEngine(model, lr=t["lr"], weight_decay=t["weight_decay"],
                       optimizer=t["optimizer"],
                       grad_clip_max_norm=t["grad_clip_max_norm"],
                       cosine_t_max=None, steps_per_epoch=tr_steps,
                       seed=seed % 2 ** 31, device=dev)
    beta = float(t["kl_weight"])
    rec = trainheld.HeldRecord(
        initial={k: x.detach().cpu() for k, x in init.items()})
    del init
    gen = inputs.generator(dev, seed, 4)
    perm = torch.randperm(tr.shape[0], generator=gen, device=dev)
    for i in range(cell.traffic["held_steps"]):
        rows = perm[i * bs:(i + 1) * bs]
        rec.states.append(trainheld.snapshot(engine))
        rec.feeds.append({"x": tr[rows].cpu(), "mask": tr_mask[rows].cpu(),
                          "gen_state": gen.get_state()})
        m = engine.train_epoch(tr, tr_mask, rows, beta, 1, bs, gen)
        rec.losses.append(float(m[0]))
    rec.states.append(trainheld.snapshot(engine))
    sums = engine.eval_epoch(va, va_mask, beta, va_steps, bs,
                             inputs.generator(dev, seed, 5))
    torch.cat([m, sums]).tolist()
    return {"cell": cell, "engine": engine, "tr": tr, "tr_mask": tr_mask,
            "va": va, "va_mask": va_mask, "tr_steps": tr_steps,
            "va_steps": va_steps, "bs": bs, "beta": beta, "record": rec,
            "n_tr": n_tr}


def window(st: Dict, seconds: float) -> Dict:
    eng, cell = st["engine"], st["cell"]
    dev, seed, bs = cell.device, cell.seed, st["bs"]
    traced = st.get("trace_window", False)
    t0 = time.perf_counter()
    epochs = failed = ops = 0
    busy = 0.0
    ends, cpu = [t0], [time.thread_time()]
    while True:
        with (tracing.Window(True, dev) if traced
              else contextlib.nullcontext()) as w:
            gen = inputs.generator(dev, seed, 100, epochs)
            perm = torch.randperm(st["tr"].shape[0], generator=gen,
                                  device=dev)
            tr_m = eng.train_epoch(st["tr"], st["tr_mask"], perm,
                                   st["beta"], st["tr_steps"], bs, gen)
            va = eng.eval_epoch(st["va"], st["va_mask"], st["beta"],
                                st["va_steps"], bs,
                                inputs.generator(dev, seed, 101, epochs))
            vals = torch.cat([tr_m, va]).tolist()  # the epoch's host read
        if traced:
            busy += w.trace.busy_s
            ops += len(w.trace.dev_name)
        epochs += 1
        failed += 0 if all(np.isfinite(vals)) else st["tr_steps"]
        ends.append(time.perf_counter())
        cpu.append(time.thread_time())
        if ends[-1] - t0 >= seconds:
            break
    st["notes"] = {"epoch_s": [round(b - a, 4)
                               for a, b in zip(ends, ends[1:])],
                   "epoch_thread_cpu_s": [round(b - a, 4)
                                          for a, b in zip(cpu, cpu[1:])]}
    fwd = yardstick_kl.forward_flops(cell.config)
    steps = epochs * st["tr_steps"]
    out = {"epochs": epochs, "attempted": steps, "failed": failed,
           "train_steps": steps, "eval_steps": epochs * st["va_steps"],
           "images": epochs * st["n_tr"],
           "flops": bs * fwd * (3 * steps + epochs * st["va_steps"])}
    if traced:
        out.update(device_busy_s=busy, device_ops=ops)
    return out


def reference_steps(st: Dict, tf32: bool = False):
    """The reference's held steps from the record (on the run's device)."""
    cell = st["cell"]
    cfg, dev = cell.config, cell.device
    t = cfg["vae_train"]
    grid = yardstick_kl.latent_grid(cfg)
    names = list(st["record"].states[0]["params"])

    def step(s, feed):
        x, mask = feed["x"].to(dev), feed["mask"].to(dev)
        params = {k: s[k].clone().requires_grad_() for k in names}
        g = torch.Generator(device=dev)
        g.set_state(feed["gen_state"])
        eps = torch.randn((x.shape[0], grid, grid, cfg["latent_channels"]),
                          generator=g, device=dev)
        loss, grads = ref_kl.gradients(cfg, params, x, mask, eps, REF_CHUNK,
                                       tf32)
        ok = bool(torch.isfinite(loss))
        grads = {k: (gr if ok else torch.zeros_like(gr))
                 for k, gr in grads.items()}
        return loss, grads, {}

    hyper = {"lr": t["lr"], "weight_decay": t["weight_decay"],
             "clip": t["grad_clip_max_norm"], "t_max": None,
             "steps_per_epoch": st["tr_steps"]}
    return trainheld.held_steps(st["record"], step, hyper, dev)


def check(st: Dict, control: bool = False) -> Dict[str, float]:
    return trainheld.readings(st["record"],
                              lambda tf32: reference_steps(st, tf32), control,
                              st.setdefault("notes", {}))


def info(st: Dict, counters: Dict) -> Dict:
    return {"stage": "vae_train", **counters}
