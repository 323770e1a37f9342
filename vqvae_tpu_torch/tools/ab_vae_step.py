"""Same-card A/B of the VAE training step between source trees.

Each tree given (a checkout of the repository, e.g. an unpacked
``git archive`` of the parent commit beside the working tree) runs in its
own process, in the order given (parent, change, change, parent is the
rule), with that tree's own ``chip_smoke.py`` helpers and
``vqvae_tpu_torch`` (``ab_knn_select.run_trees``). At the full width of
``configs/fashionmnist/spatial/geodesic`` (batch 256, flax's
initialization from seed 42, TF32 off) it measures
- one ``train_step`` on the card against the CPU (``chip_smoke.py``
  phase 7's batch: 256 synthetic images, the last 16 padding, the noise
  of one CPU generator): the loss gap (relative) and the largest gradient
  gap as a share of its tensor's norm, the conv biases that feed a
  BatchNorm left out (their true gradient is 0);
- that step on the card: the wall time (20 calls after a warm-up, to a
  sync), the device time summed over its kernels (``torch.profiler``, 5
  calls) and the kernels' count;
- the epoch path (``train_epoch``, phase 13's 60,000-image epoch of 235
  steps, after a 4-step warm-up): steps/s of each of ``EPOCHS`` epochs,
  and the device time a step over a 40-step epoch with its largest
  kernels.

Run from the repository root on one GPU:
``python -m vqvae_tpu_torch.tools.ab_vae_step build/parent . . build/parent``.
Prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .ab_knn_select import run_trees

_CHILD = r"""
import copy, json, sys, time
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree))
import torch
import chip_smoke as cs
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.data import get_data_loaders, load_dataset
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models import VAE, BatchNorm, flax_init_
from vqvae_tpu_torch.train import VAEEngine
from vqvae_tpu_torch.train.vae_engine import seeded_generator

EPOCHS, SEED = 3, 42
resolve_device("cuda")
cfg = load_config(tree / cs.PRESET / "vae.yaml")
arch = dict(cfg["model"])
arch.pop("beta")
bs, lr = int(cfg["data"]["batch_size"]), float(cfg["lr"])
model = flax_init_(VAE(**arch), seeded_generator("cpu", SEED))
pre_norm = set()
for name, mod in model.named_modules():
    if isinstance(mod, BatchNorm):
        parent, i = name.rsplit(".", 1)
        pre_norm.add(f"{parent}.{int(i) - 1}.bias")


def engine(dev, steps=235):
    return VAEEngine(copy.deepcopy(model), lr=lr,
                     weight_decay=float(cfg["weight_decay"]),
                     grad_clip_max_norm=float(cfg["grad_clip_max_norm"]),
                     cosine_t_max=int(cfg["max_epochs"]),
                     steps_per_epoch=steps, seed=SEED, device=dev)


split = load_dataset("fashionmnist", root="no-such-dir", train=True,
                     synthetic_size=bs, seed=SEED)
images = torch.from_numpy(split.images)
mask = torch.ones(bs)
mask[-16:], images[-16:] = 0.0, 0.0


def one_step(dev):
    eng = engine(dev)
    out = eng.train_step(images.to(dev), mask.to(dev), 1.0,
                         seeded_generator("cpu", SEED, 1))
    return float(out["loss"]), {k: p.grad.detach().cpu()
                                for k, p in eng.model.named_parameters()}


loss_g, grad_g = one_step("cuda")
loss_c, grad_c = one_step("cpu")
grad_gap = max(float((grad_g[k] - g).norm() / g.norm())
               for k, g in grad_c.items() if k not in pre_norm)

eng = engine("cuda")
batch = (images.cuda(), mask.cuda(), 1.0, seeded_generator("cuda", SEED, 1))
step = lambda: eng.train_step(*batch)
step()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(20):
    step()
torch.cuda.synchronize()
wall_ms = (time.perf_counter() - t0) / 20 * 1e3
parts = cs.kernel_times(step, 5)

loader, _ = get_data_loaders("fashionmnist", root="no-such-dir",
                             batch_size=bs, seed=SEED)
eng = engine("cuda")
data, m, steps, n_pad = eng.device_dataset(loader, bs)
gen = seeded_generator("cuda", SEED, 3)
perm = lambda: torch.randperm(n_pad, device="cuda", generator=gen)
eng.train_epoch(data, m, perm(), 1.0, 4, bs, gen)  # warm-up
rates = []
for _ in range(EPOCHS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(eng.train_epoch(data, m, perm(), 1.0, steps, bs, gen)[0])
    rates.append(steps / (time.perf_counter() - t0))
p = perm()
epoch_parts = cs.kernel_times(
    lambda: eng.train_epoch(data, m, p, 1.0, 40, bs, gen))
print("AB " + json.dumps({
    "tree": str(tree), "step_loss_gap": abs(loss_g - loss_c) / abs(loss_c),
    "step_grad_gap": grad_gap, "step_wall_ms": wall_ms,
    "step_device_ms": sum(ms for _, ms in parts),
    "step_kernel_kinds": len(parts), "epoch_steps": steps,
    "epoch_steps_per_s": rates,
    "epoch_device_ms_per_step": sum(ms for _, ms in epoch_parts) / 40,
    "epoch_top_kernels_ms_per_step": [(k[:60], ms / 40)
                                      for k, ms in epoch_parts[:12]]}),
    flush=True)
"""


def main(argv: Optional[List[str]] = None) -> None:
    trees = list(sys.argv[1:] if argv is None else argv)
    if not trees:
        raise SystemExit("usage: ab_vae_step TREE [TREE ...]")
    run_trees(_CHILD, trees)


if __name__ == "__main__":
    main()
