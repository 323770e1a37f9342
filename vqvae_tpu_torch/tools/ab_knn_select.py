"""Same-card A/B of the kNN selection kernels K1/K2 between source trees.

Each tree given (a checkout of the repository, e.g. an unpacked
``git archive`` of the parent commit beside the working tree) runs in its
own process, in the order given (parent, change, change, parent is the
rule), with that tree's own ``chip_smoke.py`` helpers and
``vqvae_tpu_torch``: it builds the tree's kernels, then times on the
``chip_smoke.py`` latents (983,040 x 16, seed 0, 16,384 query rows,
k_sel 29) K1 packed at bins 1024 and K2 unpacked at bins 768 (CUDA events,
mean of 5 calls after a warm-up), K1 against the first 262,144 rows (a
database that fits in the 50 MB L2), K1 and K2 at CIFAR's width on the
codebook stage's one launch there (65,536 x 65,536 clustered latents at
D = 32, seed 0; K1 at bins 1024 with one call's device time by kernel,
``torch.profiler``; K2 unpacked at bins 1024, the same walk: 65,536 rows
admit no other bins), and one codebook main run at full
width (``chip_smoke.py`` phase 4) for its ``timings_s``.

Run from the repository root on one GPU:
``python -m vqvae_tpu_torch.tools.ab_knn_select build/parent . . build/parent``.
Prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import subprocess
import sys
from typing import List, Optional

_CHILD = r"""
import json, shutil, sys, time
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree))
import torch
import chip_smoke as cs
from vqvae_tpu_torch.cli import load_codebook
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops import knn_select as ks

resolve_device("cuda")
t0 = time.perf_counter()
ks.build()
res = {"tree": sys.argv[1], "build_s": time.perf_counter() - t0}
z = cs.make_latents(cs.N_NODES, cs.D, seed=0)
zd = torch.from_numpy(z).cuda()
zq = zd[:cs.Q_ROWS].contiguous()
for name, bins, packed in (("K1", 1024, True), ("K2", 768, False)):
    res[name + "_ms"] = cs.cuda_ms(lambda: ks.fused_select(
        zq, zd, cs.N_NODES, metric="euclidean", bins=bins, k_sel=cs.K_SEL,
        packed=packed), 5)
zl2 = zd[:262_144].contiguous()
res["K1_l2_ms"] = cs.cuda_ms(lambda: ks.fused_select(
    zq, zl2, 262_144, metric="euclidean", bins=1024, k_sel=cs.K_SEL,
    packed=True), 5)
del zd, zq, zl2
torch.cuda.empty_cache()
# CIFAR's width: the codebook stage's one launch, all against all
z32 = torch.from_numpy(cs.make_latents(65_536, 32, seed=0)).cuda()
for name, bins, packed in (("K1_d32", 1024, True), ("K2_d32", 1024, False)):
    call = lambda: ks.fused_select(z32, z32, 65_536, metric="euclidean",
                                   bins=bins, k_sel=cs.K_SEL, packed=packed)
    res[name + "_ms"] = cs.cuda_ms(call, 3)
    if packed:
        res[name + "_by_kernel"] = {key[:48]: t for key, t
                                    in cs.kernel_times(call)}
del z32
torch.cuda.empty_cache()
work = tree / "build" / "ab_knn_select"
shutil.rmtree(work, ignore_errors=True)
try:
    cfg = cs.stage_config(work, z, cs.N_NODES // 16, "main")
    out, launches, _, secs = cs.run_stage(cfg, "cuda", True)
    res["stage_s"] = secs
    res["k1_launches"] = launches
    res["timings_s"] = load_codebook(out)["config"]["timings_s"]
finally:
    shutil.rmtree(work, ignore_errors=True)
print("AB " + json.dumps(res), flush=True)
"""


def run_trees(child: str, trees: List[str]) -> None:
    """Print the card's name and power limit, then run ``child`` (Python
    source; argv[1] is the tree) once per tree, in the order given, each
    in its own process, and print the JSON of its last ``AB `` line."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", child, tree],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            raise SystemExit(f"run on {tree} failed:\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
        print(lines[-1][3:], flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    trees = list(sys.argv[1:] if argv is None else argv)
    if not trees:
        raise SystemExit("usage: ab_knn_select TREE [TREE ...]")
    run_trees(_CHILD, trees)


if __name__ == "__main__":
    main()
