"""Traffic kind ``vae_epochs``: the VAE stage's device-resident epoch path.

Set-up makes the configuration's train and eval splits on the device,
padded with zero rows to whole batches (the mask marks the real rows), and
the weights; builds the program's ``VAEEngine`` with the preset's
optimizer; drives it through ``held_steps`` steps with the window's own
call (``train_epoch``, one step each, on the first batches of a
permutation) and copies its state around each (``trainheld``); then one
eval pass, so every shape the window runs has run.

The window runs whole epochs as the stage's ``train`` does on this path:
a permutation over the padded rows drawn on the device, ``train_epoch``
over every batch, ``eval_epoch`` over the eval split, and one host read of
both epochs' sums. The images trained are the real rows of each epoch.
The host's dispatch paces the loop, so the window's rate follows the
host's speed; the end-to-end metric is the device's busy time an epoch,
for which the run that reports it traces each epoch of its window (the
device's activity alone, read after the epoch's host read, inside the
window), and the rate is a per-layer metric.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import numpy as np
import torch

from .. import inputs, tracing, trainheld, yardstick
from ..reference import precision
from ..reference import vae as ref_vae


def _pad(x: torch.Tensor, n_pad: int):
    n = x.shape[0]
    mask = torch.zeros(n_pad, device=x.device)
    mask[:n] = 1.0
    if n_pad > n:
        x = torch.cat([x, x.new_zeros((n_pad - n, *x.shape[1:]))])
    return x.contiguous(), mask


def setup(cell) -> Dict:
    from vqvae_tpu_torch.models.vae import VAE
    from vqvae_tpu_torch.train.vae_engine import VAEEngine

    cfg, dev, seed = cell.config, cell.device, cell.seed
    v, d, t = cfg["vae"], cfg["data"], cfg["vae_train"]
    bs = t["batch_size"]
    shape = d["image_shape"]
    n_tr, n_va = d["train_size"], d["eval_size"]
    x_tr, _ = inputs.images(n_tr, shape, d["normalized"], seed, 1, dev)
    x_va, _ = inputs.images(n_va, shape, d["normalized"], seed, 2, dev)
    tr_steps, va_steps = math.ceil(n_tr / bs), math.ceil(n_va / bs)
    tr, tr_mask = _pad(x_tr, tr_steps * bs)
    va, va_mask = _pad(x_va, va_steps * bs)
    del x_tr, x_va
    init = ref_vae.initial_state(cfg, seed, 3, dev)

    model = VAE(in_channels=v["in_channels"],
                enc_channels=tuple(v["enc_channels"]),
                dec_channels=tuple(v["dec_channels"]),
                latent_dim=v["latent_dim"], recon_loss=v["recon_loss"],
                output_image_size=v["image_size"],
                norm_type=v["norm_type"],
                mse_use_sigmoid=v["mse_use_sigmoid"],
                topology=v["topology"],
                spatial_free_bits=v.get("spatial_free_bits"))
    model.load_state_dict({k: x.clone() for k, x in init.items()})
    engine = VAEEngine(model, lr=t["lr"], weight_decay=t["weight_decay"],
                       optimizer=t["optimizer"],
                       grad_clip_max_norm=t["grad_clip_max_norm"],
                       cosine_t_max=t["max_epochs"],
                       steps_per_epoch=tr_steps, seed=seed % 2 ** 31,
                       device=dev)
    beta = float(v.get("beta", 1.0))
    if cell.traffic["held_steps"] > tr_steps:
        raise ValueError("the held steps need as many whole batches")
    rec = trainheld.HeldRecord(
        initial={k: x.detach().cpu() for k, x in init.items()})
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
    cfg = cell.config
    fwd = yardstick.vae_forward_flops(cfg)
    steps = epochs * st["tr_steps"]
    out = {"epochs": epochs, "attempted": steps, "failed": failed,
           "train_steps": steps,
           "images": epochs * st["n_tr"],
           "flops": bs * fwd * (3 * steps + epochs * st["va_steps"])}
    if traced:
        out.update(device_busy_s=busy, device_ops=ops)
    return out


def end_to_end(st: Dict, counters: Dict, window_s: float) -> Dict:
    """The device's busy seconds an epoch: the union of kernel, copy and
    set intervals of each epoch's trace, summed over the window's epochs
    and shared among them; nothing where no device op ran."""
    busy = counters.get("device_busy_s", 0.0)
    if busy <= 0 or not counters["epochs"]:
        return {}
    st.setdefault("notes", {})["window_device_ops_an_epoch"] = (
        counters["device_ops"] / counters["epochs"])
    return {"vae_train_epoch_device_s": busy / counters["epochs"]}


def release(st: Dict) -> None:
    for k in ("engine", "tr", "tr_mask", "va", "va_mask"):
        st.pop(k, None)


def reference_steps(st: Dict, tf32: bool = False):
    """The reference's held steps from the record (on the run's device)."""
    cell = st["cell"]
    cfg, dev = cell.config, cell.device
    t, v = cfg["vae_train"], cfg["vae"]
    grid = v["image_size"]
    for _ in cfg["vae"]["enc_channels"]:
        grid = yardstick.conv_out(grid, 3, 2, 1)

    def step(s, feed):
        x, mask = feed["x"].to(dev), feed["mask"].to(dev)
        params = {k: s[k].clone().requires_grad_() for k in
                  st["record"].states[0]["params"]}
        full = {**s, **params}
        g = torch.Generator(device=dev)
        g.set_state(feed["gen_state"])
        eps = torch.randn((x.shape[0], grid, grid, v["latent_dim"]),
                          generator=g, device=dev)
        loss, stats = ref_vae.train_loss(cfg, full, x, mask, eps)
        grads = torch.autograd.grad(loss, list(params.values()))
        ok = bool(torch.isfinite(loss))
        grads = {k: (gr if ok else torch.zeros_like(gr))
                 for k, gr in zip(params, grads)}
        return loss.detach(), grads, stats

    hyper = {"lr": t["lr"], "weight_decay": t["weight_decay"],
             "clip": t["grad_clip_max_norm"], "t_max": t["max_epochs"],
             "steps_per_epoch": st["tr_steps"]}
    with precision(tf32):
        return trainheld.held_steps(st["record"], step, hyper, dev)


def check(st: Dict, control: bool = False) -> Dict[str, float]:
    return trainheld.readings(st["record"],
                              lambda tf32: reference_steps(st, tf32), control,
                              st.setdefault("notes", {}))


def info(st: Dict, counters: Dict) -> Dict:
    return {"stage": "vae_train", **counters}
