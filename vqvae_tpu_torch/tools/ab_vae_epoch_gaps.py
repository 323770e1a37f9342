"""Card-vs-CPU gaps of the VAE's epoch check over seeds, between source
trees.

``chip_smoke.py`` phases 13 and 17c run one epoch of the VAE's
device-resident path (600 images padded to 3 batches of 256, three Adam
steps) at seed 42 and hold each step on the card from the CPU's state
before it: the step's (loss, recon, kl) gap relative to the largest, and
the largest gradient difference as a share of its tensor's norm (phase
7's measure), within ``HELD_LIMITS``, with a TF32 control that must lie
past them at every step. This tool runs that check's own code
(``chip_smoke.vae_cpu_epoch``, ``vae_held_gaps`` and
``held_step_verdict`` of this checkout) at seeds 0-7 and 42 for both
presets (``configs/fashionmnist/spatial/geodesic`` and
``configs/cifar10/spatial/geodesic`` at full width) and prints per seed
the held steps' gaps [loss, grad] in f32 and in the TF32 control, the
check's verdict, the free-running epoch's mean (loss, recon, kl) gap in
f32 and TF32 (``epoch_loss_gap``: logged by the check, not gated), and
the first step's gradient elements whose sign differs card vs CPU with
each device's own noisy latents and with the CPU's latents given to the
card (the conv biases that feed a BatchNorm left out: their true
gradient is 0); then per preset and measure the largest f32 gap, the
smallest TF32 gap and the medians over the seeds, so each limit can be
read against both ranges.

Each tree given (a checkout of the repository, e.g. an unpacked
``git archive`` of the parent commit beside the working tree) runs in its
own process with its own ``vqvae_tpu_torch`` (``ab_knn_select.run_trees``).
Run from the repository root on one GPU:
``python -m vqvae_tpu_torch.tools.ab_vae_epoch_gaps build/parent .``.
Prints the card's name and power limit, then one JSON line per tree.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from .ab_knn_select import run_trees

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"

_CHILD = r"""
import importlib.util, json, sys
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree))
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", %(smoke)r)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.vae import reparameterize
from vqvae_tpu_torch.train.vae_engine import seeded_generator

SEEDS = [*range(8), 42]


def step_grads(runs, seed, dev, z_cpu=None):
    # the epoch's first step without the optimizer: its batch, noise and
    # loss; z_cpu replaces the value of this device's noisy latents with
    # the CPU's, their gradient path unchanged
    n = runs.n_steps * runs.bs
    images = np.zeros((n, *runs.split.images.shape[1:]), np.float32)
    images[:cs.EPOCH_IMAGES] = runs.split.images
    mask = (torch.arange(n) < cs.EPOCH_IMAGES).float()
    ib = runs.perm[:runs.bs]
    x, m = torch.from_numpy(images)[ib].to(dev), mask[ib].to(dev)
    resolve_device(dev)
    model = runs.engine(dev).model.train()
    mu, logvar = model.encoder(x)
    z = reparameterize(mu, logvar, seeded_generator("cpu", seed, 1),
                       rows=(0, runs.bs))
    if z_cpu is not None:
        z = z + (z_cpu.to(dev) - z.detach())
    total, _, _ = model.loss(x, model.decoder(z), mu, logvar, beta=1.0,
                             mask=m, step=0)
    total.backward()
    return ({k: p.grad.cpu() for k, p in model.named_parameters()},
            z.detach().cpu())


def flips(a, b, skip):
    return sum(int((torch.sign(a[k]) != torch.sign(b[k])).sum())
               for k in a if k not in skip)


def spread(values):
    return {"max": float(np.max(values)), "min": float(np.min(values)),
            "median": float(np.median(values))}


out = {"tree": str(tree), "limits": cs.HELD_LIMITS}
for preset, dataset in ((cs.PRESET, "fashionmnist"), (cs.CIFAR, "cifar10")):
    rows = {}
    for seed in SEEDS:
        runs = cs.vae_epoch_runs(seed, preset, dataset)
        images = runs.split.images
        cpu, states, results = cs.vae_cpu_epoch(runs)
        held = cs.vae_held_gaps(runs, states, results)
        control = cs.vae_held_gaps(runs, states, results, tf32=True)
        passed, why = cs.held_step_verdict(held, control,
                                           cs.HELD_LIMITS[dataset])
        card = runs.epoch("cuda", images)
        tf32 = runs.epoch("cuda", images, tf32=True)
        skip = cs._pre_norm_biases(runs.model)
        g_cpu, z_cpu = step_grads(runs, seed, "cpu")
        g_own, _ = step_grads(runs, seed, "cuda")
        g_same, _ = step_grads(runs, seed, "cuda", z_cpu)
        rows[seed] = {
            "held": [[g["loss"], g["grad"]] for g in held],
            "control": [[g["loss"], g["grad"]] for g in control],
            "passed": passed, "why": why,
            "epoch": [cs.epoch_loss_gap(card, cpu),
                      cs.epoch_loss_gap(tf32, cpu)],
            "flips": [flips(g_own, g_cpu, skip), flips(g_same, g_cpu, skip)]}
    summary = {}
    for m, name in enumerate(("loss", "grad")):
        f32 = [st[m] for r in rows.values() for st in r["held"]]
        ctl = [st[m] for r in rows.values() for st in r["control"]]
        summary[name] = {
            "f32": spread(f32), "tf32": spread(ctl),
            "seed_medians_f32": spread([np.median([st[m] for st in r["held"]])
                                        for r in rows.values()]),
            "seed_medians_tf32": spread([np.median([st[m] for st in
                                                    r["control"]])
                                         for r in rows.values()])}
    out[dataset] = {"seeds": rows, "summary": summary,
                    "all_passed": all(r["passed"] for r in rows.values())}
print("AB " + json.dumps(out), flush=True)
"""


def main(argv: Optional[List[str]] = None) -> None:
    trees = list(sys.argv[1:] if argv is None else argv)
    if not trees:
        raise SystemExit("usage: ab_vae_epoch_gaps TREE [TREE ...]")
    run_trees(_CHILD % {"smoke": str(SMOKE)}, trees)


if __name__ == "__main__":
    main()
