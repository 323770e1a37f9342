"""Tuning probe for kernel K3 (nearest-code assignment) on one card.

Each variant is ``csrc/assign.cu`` with its tuning constants replaced:
warps a block (``kWarps``), rows a lane at D <= 16 (the ``launch<16, R>``
dispatch), codes unrolled in the code loop, and the launch bounds' blocks
an SM. Two diagnostic variants keep the shipped shape but replace the
running (best, index) update: "min only" keeps the running minimum without
its index, "FMA only" adds every d2 into it; both give wrong indices and
show what the product loop alone costs. Each variant is built with the
package's nvcc flags into ``vqvae_tpu_torch/_build/tune_assign/``, run at
the quality stage's 160,000 x 16 rows against 512 codes
(``chip_smoke.py`` phase 3's latents), compared with the plain version
(rows whose index differs) and timed per kernel by ``torch.profiler``
(mean of 20 calls).

Run from the repository root on one GPU:
``python -m vqvae_tpu_torch.tools.tune_assign``. Prints the card's name and
power limit, then one line per variant.
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

# name -> (warps a block, rows a lane, codes unrolled, blocks an SM, update)
VARIANTS: Dict[str, Tuple[int, int, int, int, Optional[str]]] = {
    "shipped": (4, 4, 2, 3, None),
    "8 warps": (8, 4, 2, 2, None),
    "8 warps, 1 block an SM": (8, 4, 2, 1, None),
    "4 blocks an SM": (4, 4, 2, 4, None),
    "2 rows a lane": (4, 2, 2, 6, None),
    "no unroll": (4, 4, 1, 3, None),
    "4 codes unrolled": (4, 4, 4, 3, None),
    "min only": (4, 4, 2, 3, "fminf(best[r], d2)"),
    "FMA only": (4, 4, 2, 3, "best[r] + d2"),
}
_UPDATE = """          if (d2 < best[r]) {
            best[r] = d2;
            arg[r] = k0 + c;
          }"""
_ANCHORS = {
    "warps": "constexpr int kWarps = 4;",
    "rows": "err = launch<16, 4>(",
    "unroll": "#pragma unroll 2\n      for (int c = c0",
    "blocks": "DT * R <= 64 ? 3 : 1",
    "update": _UPDATE,
}


def variant_source(src: str, warps: int, rows: int, unroll: int,
                   blocks: int, update: Optional[str]) -> str:
    """``src`` with one variant's constants; raises if an anchor is gone
    (the shipped source changed)."""
    for name, anchor in _ANCHORS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/assign.cu: the {name} anchor "
                               f"{anchor!r} is not found once")
    src = src.replace(_ANCHORS["warps"], f"constexpr int kWarps = {warps};")
    src = src.replace(_ANCHORS["rows"], f"err = launch<16, {rows}>(")
    src = src.replace(_ANCHORS["unroll"],
                      f"#pragma unroll {unroll}\n      for (int c = c0")
    src = src.replace(_ANCHORS["blocks"], f"DT * R <= 64 ? {blocks} : 1")
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
    at = next(i for i, ln in enumerate(lines) if "assign_kernelILi16E" in ln)
    return lib, " ".join(ln.split(":", 1)[-1].strip()
                         for ln in lines[at + 1:at + 3])


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

    z = cs.make_latents(cs.K3_ROWS + cs.K3_CODES, cs.D, seed=1)
    zd = torch.from_numpy(z[:cs.K3_ROWS]).cuda()
    cb = torch.from_numpy(z[cs.K3_ROWS:]).cuda()
    n, d, k = zd.shape[0], zd.shape[1], cb.shape[0]
    ref_idx, _ = nearest_codes_reference(zd, cb)
    idx = torch.empty(n, dtype=torch.int64, device="cuda")
    buf = torch.empty(17 * k + n, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (path, ptxas) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.assign_launch.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp]
        lib.assign_launch.restype = ci

        def call():
            rc = lib.assign_launch(
                zd.data_ptr(), cb.data_ptr(), n, d, k, buf.data_ptr(),
                buf[16 * k:].data_ptr(), idx.data_ptr(),
                buf[17 * k:].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"variant {name!r}: launch failed ({rc})")

        call()
        torch.cuda.synchronize()
        differ = int((idx != ref_idx).sum())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        ms = {ev.key.replace("void ", "").replace("(anonymous namespace)::",
                                                  "").split("(")[0]:
              ev.device_time_total / 1e3 / 20
              for ev in prof.key_averages() if ev.device_time_total > 0}
        main_ms = sum(t for key, t in ms.items() if "assign_kernel" in key)
        prep_ms = sum(t for key, t in ms.items() if "assign_prep" in key)
        print(f"{name}: warps {VARIANTS[name][0]}, rows a lane "
              f"{VARIANTS[name][1]}, unroll {VARIANTS[name][2]}, blocks an "
              f"SM {VARIANTS[name][3]}; rows differ {differ}; main "
              f"{main_ms:.4f} ms, prep {prep_ms:.4f} ms; {ptxas}",
              flush=True)


if __name__ == "__main__":
    main()
