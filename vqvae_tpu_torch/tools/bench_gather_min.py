"""Gather-min benchmark — the port of ``tools/bench_pallas_gather.py``.

The ELL relaxation's hot operation is a random-row gather-reduce,
``acc = min_j d[idx_j]`` with idx random and rows of K f32. For each row
width this runs that access pattern two ways on the same data (numpy
``default_rng(0)``, as the JAX tool draws it): kernel K4 (``ops/
gather_min.py``) and, as the yardstick, one PyTorch call
``d[idx].amin(0)``. It checks that both agree bitwise, then reports the
best of 3 timings as GB/s of gathered rows and Mrows/s. On the card
times come from CUDA events; on the CPU (``--device cpu``) the kernel's
plain version runs and times are host-clock times of the CPU.

The JAX tool's ``--slots`` (the depth of its TPU DMA ring) has no
counterpart: the kernel keeps several rows in flight per thread instead.

Run: ``python -m vqvae_tpu_torch.tools.bench_gather_min [--rows 1048576]
[--n 196608] [--widths 256,512,1024] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather_min import gather_min, launch_gather_min


def _seconds(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn`` (after it has run once)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_width(n: int, k: int, rows: int, device: torch.device,
                reps: int = 3) -> Dict[str, Dict[str, float]]:
    """Best-of-``reps`` times of K4 and ``d[idx].amin(0)`` on data drawn
    as the JAX tool draws it; raises if the two disagree."""
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.random((n, k), dtype=np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32)).to(
        device)
    rows_long = idx.long()

    def kernel():
        # the inputs were checked by the first call; time the launches alone
        if device.type == "cuda":
            return launch_gather_min(d, idx)
        return gather_min(d, idx)

    def library():
        return d[rows_long].amin(dim=0, keepdim=True)

    ours, ref = gather_min(d, idx), library()
    if not torch.equal(ours, ref):
        raise AssertionError(
            f"K={k}: gather_min differs from d[idx].amin(0) by "
            f"{float((ours - ref).abs().max())}")
    out = {}
    for name, fn in (("library", library), ("kernel", kernel)):
        best = min(_seconds(fn, device) for _ in range(reps))
        out[name] = {"seconds": best,
                     "gbps": rows * k * 4 / best / 1e9,
                     "mrows_s": rows / best / 1e6}
    return out


def main(argv: Optional[List[str]] = None) -> Dict[int, dict]:
    ap = argparse.ArgumentParser(
        description="Gather-min: kernel K4 against d[idx].amin(0).")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--n", type=int, default=196608)
    ap.add_argument("--widths", default="256,512,1024")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (the plain version; host-clock times)")
    print(f"device={name} rows={args.rows} n={args.n}")
    results = {}
    for k in (int(w) for w in args.widths.split(",")):
        res = bench_width(args.n, k, args.rows, dev)
        results[k] = res
        print(f"K={k:5d} ({k * 4}B rows): "
              f"d[idx].amin {res['library']['gbps']:7.1f} GB/s "
              f"({res['library']['mrows_s']:.1f} Mrows/s) | "
              f"K4 {res['kernel']['gbps']:7.1f} GB/s "
              f"({res['kernel']['mrows_s']:.1f} Mrows/s)")
    return results


if __name__ == "__main__":
    main()
