"""Tuning probe for kernel K3 (nearest-code assignment) on one card.

Each variant is ``csrc/assign.cu`` with its tuning constants replaced. The
rows path (D <= 16): warps a block (``kWarps``), rows a lane at D <= 16
(the ``launch_rows<16, R>`` dispatch), codes unrolled in the code loop, and
the launch bounds' blocks an SM. The tiled path (D >= 32): the split
model's costs (``kStageCost``, and ``kMergeCost``: at 1e9 the codes are
never split into slices). Two diagnostic variants keep the
shipped shape but replace the rows path's running (best, index) update:
"min only" keeps the running minimum without its index, "FMA only" adds
every d2 into it; both give wrong indices at D <= 16 and show what the
product loop alone costs. Each variant is built with the package's nvcc
flags into ``vqvae_tpu_torch/_build/tune_assign/``, run against 512 codes
at the quality stages' shapes (``chip_smoke.py`` phase 3's latents:
160,000 x 16, seed 1; 16,000 and 160,000 x 32 and 1,000, 10,000 and
60,000 x 128, seed 2), compared with the plain version (rows whose index
differs) and timed per kernel by ``torch.profiler`` (mean of 20 calls).

Run from the repository root on one GPU:
``python -m vqvae_tpu_torch.tools.tune_assign``. Prints the card's name and
power limit, then one line per variant and shape.
"""
from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, nvcc_path
from ..device import resolve_device
from ..ops.assign import nearest_codes_reference

# name -> (warps a block, rows a lane, codes unrolled, blocks an SM, update,
#          the split model's staging and merge costs in chunk-times)
VARIANTS: Dict[str, Tuple[int, int, int, int, Optional[str], str, str]] = {
    "shipped": (4, 4, 2, 3, None, "0.1f", "0.5f"),
    "staging cost 0.5": (4, 4, 2, 3, None, "0.5f", "0.5f"),
    "codes never split": (4, 4, 2, 3, None, "0.1f", "1e9f"),
    "8 warps": (8, 4, 2, 2, None, "0.1f", "0.5f"),
    "min only": (4, 4, 2, 3, "fminf(best[r], d2)", "0.1f", "0.5f"),
    "FMA only": (4, 4, 2, 3, "best[r] + d2", "0.1f", "0.5f"),
}
# (rows, width, latents' seed) of each timed shape
SHAPES = ((160_000, 16, 1), (16_000, 32, 2), (160_000, 32, 2),
          (1_000, 128, 2), (10_000, 128, 2), (60_000, 128, 2))
_UPDATE = """          if (d2 < best[r]) {
            best[r] = d2;
            arg[r] = k0 + c;
          }"""
_ANCHORS = {
    "warps": "constexpr int kWarps = 4;",
    "rows": "err = launch_rows<16, 4>(",
    "unroll": "#pragma unroll 2\n      for (int c = c0",
    "blocks": "__launch_bounds__(kThreads, 3)",
    "update": _UPDATE,
    "stage": "constexpr float kStageCost = 0.1f;",
    "merge": "constexpr float kMergeCost = 0.5f;",
}


def variant_source(src: str, warps: int, rows: int, unroll: int,
                   blocks: int, update: Optional[str], stage: str,
                   merge: str) -> str:
    """``src`` with one variant's constants; raises if an anchor is gone
    (the shipped source changed)."""
    for name, anchor in _ANCHORS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/assign.cu: the {name} anchor "
                               f"{anchor!r} is not found once")
    src = src.replace(_ANCHORS["warps"], f"constexpr int kWarps = {warps};")
    src = src.replace(_ANCHORS["rows"], f"err = launch_rows<16, {rows}>(")
    src = src.replace(_ANCHORS["unroll"],
                      f"#pragma unroll {unroll}\n      for (int c = c0")
    src = src.replace(_ANCHORS["blocks"],
                      f"__launch_bounds__(kThreads, {blocks})")
    src = src.replace(_ANCHORS["stage"],
                      f"constexpr float kStageCost = {stage};")
    src = src.replace(_ANCHORS["merge"],
                      f"constexpr float kMergeCost = {merge};")
    if update is not None:
        src = src.replace(_UPDATE, f"          best[r] = {update};")
    return src


def _build(name: str, source: str, out_dir: Path) -> Tuple[Path, str]:
    stem = "".join(ch if ch.isalnum() else "_" for ch in name)
    src = out_dir / f"assign_{stem}.cu"
    src.write_text(source)
    lib = out_dir / f"libassign_{stem}.so"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r} failed to build:\n"
                           f"{proc.stderr[-3000:]}")
    lines = (proc.stdout + proc.stderr).splitlines()
    notes = []
    for kernel in ("assign_rowsILi16ELi", "assign_tiledILi128E"):
        at = next(i for i, ln in enumerate(lines) if kernel in ln)
        notes.append(" ".join(ln.split(":", 1)[-1].strip()
                              for ln in lines[at + 2:at + 4]))
    return lib, "; ".join(notes)


def main() -> None:
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = BUILD_DIR / "tune_assign"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (CSRC_DIR / "assign.cu").read_text()
    with ThreadPoolExecutor() as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: _build(kv[0], variant_source(src, *kv[1]), out_dir),
            VARIANTS.items())))

    inputs = []
    for rows, width, seed in SHAPES:
        z = cs.make_latents(rows + cs.K3_CODES, width, seed=seed)
        zd = torch.from_numpy(z[:rows]).cuda()
        cb = torch.from_numpy(z[rows:]).cuda()
        inputs.append((zd, cb, nearest_codes_reference(zd, cb)[0]))
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (path, ptxas) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.assign_launch.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.assign_launch.restype = ci
        lib.assign_work_bytes.argtypes = [ci, ci, ci]
        lib.assign_work_bytes.restype = ci
        print(f"{name}: {VARIANTS[name]}; {ptxas}", flush=True)
        for zd, cb, ref_idx in inputs:
            n, d, k = zd.shape[0], zd.shape[1], cb.shape[0]
            idx = torch.empty(n, dtype=torch.int64, device="cuda")
            dist = torch.empty(n, dtype=torch.float32, device="cuda")
            work = torch.empty(max(lib.assign_work_bytes(n, d, k), 8),
                               dtype=torch.uint8, device="cuda")

            def call():
                rc = lib.assign_launch(
                    zd.data_ptr(), cb.data_ptr(), n, d, k, work.data_ptr(),
                    idx.data_ptr(), dist.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(
                        f"variant {name!r}: launch failed ({rc})")

            call()
            torch.cuda.synchronize()
            differ = int((idx != ref_idx).sum())
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            ms = {ev.key.replace("void ", "").replace(
                      "(anonymous namespace)::", "").split("(")[0]:
                  ev.device_time_total / 1e3 / 20
                  for ev in prof.key_averages() if ev.device_time_total > 0}
            print(f"  {n} x {d}: rows differ {differ}; device "
                  f"{sum(ms.values()):.4f} ms ("
                  + "; ".join(f"{key[:28]} {t:.4f}" for key, t in ms.items())
                  + ")", flush=True)


if __name__ == "__main__":
    main()
