"""Same-card A/B of kernels K3 (nearest-code assignment) and K4
(gather-min) between source trees.

Each tree given (a checkout of the repository, e.g. an unpacked
``git archive`` of the parent commit beside the working tree) runs in its
own process, in the order given (parent, change, change, parent is the
rule), with that tree's own ``chip_smoke.py`` helpers and
``vqvae_tpu_torch`` (``ab_knn_select.run_trees``): it builds the tree's
K3 and K4, then times
- K3 at the quality stage's 160,000 x 16 rows against 512 codes
  (``chip_smoke.py`` phase 3's latents, seed 1), at the vanilla presets'
  width D = 128 (1,000, 10,000 and 60,000 rows: phase 3's seed-2
  latents) and at CIFAR's D = 32 (16,000 and 160,000 rows, clustered
  latents of seed 3), with the wrapper's host time per call (enqueue
  only) at 1,000 x 128;
- K4 at the gather-min tool's shapes (2^20 indices into 196,608 x K,
  K in 256, 512, 1024; ``chip_smoke.py``'s generator, seed 0) and at
  4,096 indices into 196,608 x 1024, without the wrapper's index check;
each as the event loop (CUDA events, mean of 20 calls after a warm-up)
and the device time of one call summed over its kernels and memsets
(``torch.profiler``, 10 calls).

Run from the repository root on one GPU:
``python -m vqvae_tpu_torch.tools.ab_assign_gather build/parent . . build/parent``.
Prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .ab_knn_select import run_trees

_CHILD = r"""
import json, sys, time
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree))
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops import assign
from vqvae_tpu_torch.ops import gather_min as gm

def device_ms(fn, calls=10):
    # a session that records no device time is taken again, twice at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.device_time_total for ev in prof.key_averages()
                    if ev.device_time_total > 0)
        if total > 0:
            return total / 1e3 / calls
    raise SystemExit("torch.profiler recorded no device time")

resolve_device("cuda")
t0 = time.perf_counter()
assign.build()
gm.build()
res = {"tree": sys.argv[1], "build_s": time.perf_counter() - t0}
z = cs.make_latents(cs.K3_ROWS + cs.K3_CODES, cs.D, seed=1)
zd = torch.from_numpy(z[:cs.K3_ROWS]).cuda()
cb = torch.from_numpy(z[cs.K3_ROWS:]).cuda()
res["K3_ms"] = cs.cuda_ms(lambda: assign.nearest_codes(zd, cb), 20)
res["K3_device_ms"] = device_ms(lambda: assign.nearest_codes(zd, cb))
del zd, cb
for width, rows_list, seed in ((128, (1_000, 10_000, 60_000), 2),
                               (32, (16_000, 160_000), 3)):
    z = cs.make_latents(rows_list[-1] + cs.K3_CODES, width, seed=seed)
    cb = torch.from_numpy(z[rows_list[-1]:]).cuda()
    for rows in rows_list:
        zd = torch.from_numpy(z[:rows]).cuda()
        name = f"K3_d{width}_r{rows}"
        res[name + "_ms"] = cs.cuda_ms(
            lambda: assign.nearest_codes(zd, cb), 20)
        res[name + "_device_ms"] = device_ms(
            lambda: assign.nearest_codes(zd, cb))
        if width == 128 and rows == rows_list[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()  # enqueue only: the card runs behind
            for _ in range(200):
                assign.nearest_codes(zd, cb)
            res[name + "_host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
            torch.cuda.synchronize()
    del zd, cb
gen = torch.Generator(device="cuda").manual_seed(0)
for k, rows in [(k, cs.K4_ROWS) for k in cs.K4_WIDTHS] + [(1024, 4096)]:
    d = torch.rand((cs.K4_N, k), generator=gen, device="cuda")
    idx = torch.randint(0, cs.K4_N, (rows,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if not torch.equal(gm.gather_min(d, idx), gm.gather_min_reference(d, idx)):
        raise SystemExit(f"K4 differs from its plain version at K={k}")
    name = f"K4_{k}" if rows == cs.K4_ROWS else f"K4_{k}_r{rows}"
    res[name + "_ms"] = cs.cuda_ms(lambda: gm.launch_gather_min(d, idx), 20)
    res[name + "_device_ms"] = device_ms(lambda: gm.launch_gather_min(d, idx))
    del d, idx
    torch.cuda.empty_cache()
print("AB " + json.dumps(res), flush=True)
"""


def main(argv: Optional[List[str]] = None) -> None:
    trees = list(sys.argv[1:] if argv is None else argv)
    if not trees:
        raise SystemExit("usage: ab_assign_gather TREE [TREE ...]")
    run_trees(_CHILD, trees)


if __name__ == "__main__":
    main()
