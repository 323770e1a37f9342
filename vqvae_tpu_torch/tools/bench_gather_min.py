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

``--crossover R1,R2,...`` (card only) times instead both of K4's routes,
forced, for each of those index counts and each width at ``--n`` rows, and
prints the route ``gather_min_route`` picks beside the faster one: the
measurement behind the route rule.

Run: ``python -m vqvae_tpu_torch.tools.bench_gather_min [--rows 1048576]
[--n 196608] [--widths 256,512,1024] [--device cpu] [--crossover ...]``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import gather_min as gather_min_ops
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

    launches = gather_min.launches
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
    out["launches"] = gather_min.launches - launches
    return out


def route_crossover(n: int, k: int, rows: int, device: torch.device,
                    reps: int = 20) -> Dict[str, Dict[str, float]]:
    """Per route of K4, forced, on ``rows`` random indices into ``n`` x
    ``k``: the device time of one call summed over its kernels and memsets
    (``torch.profiler``, ``reps`` calls) and the event loop's ms per call
    (CUDA events, ``reps`` calls after a warm-up; it includes the host's
    launch work where that is longer); raises unless both routes equal the
    plain version."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.random((n, k), dtype=np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32)).to(
        device)
    ref = gather_min_ops.gather_min_reference(d, idx)
    out = {}
    for route in gather_min_ops.ROUTES:
        if not torch.equal(gather_min_ops._launch(d, idx, route), ref):
            raise AssertionError(f"{route} route differs at n={n} k={k} "
                                 f"rows={rows}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            gather_min_ops._launch(d, idx, route)
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                gather_min_ops._launch(d, idx, route)
            torch.cuda.synchronize()
        device_ms = sum(ev.device_time_total for ev in prof.key_averages()
                        if ev.device_time_total > 0) / 1e3 / reps
        out[route] = {"device_ms": device_ms,
                      "event_ms": start.elapsed_time(end) / reps}
    return out


def main(argv: Optional[List[str]] = None) -> Dict[int, dict]:
    ap = argparse.ArgumentParser(
        description="Gather-min: kernel K4 against d[idx].amin(0).")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--n", type=int, default=196608)
    ap.add_argument("--widths", default="256,512,1024")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--crossover", default=None,
                    help="comma-separated index counts: time both routes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.crossover:
        if dev.type != "cuda":
            raise SystemExit("--crossover times the kernel's routes on the "
                             "card")
        results = {}
        for k in (int(w) for w in args.widths.split(",")):
            for r in (int(x) for x in args.crossover.split(",")):
                res = route_crossover(args.n, k, r, dev)
                results[(k, r)] = res
                faster = min(res, key=lambda rt: res[rt]["device_ms"])
                print(f"crossover n={args.n} K={k} R={r}: device ms gather "
                      f"{res['gather']['device_ms']:.4f}, scan "
                      f"{res['scan']['device_ms']:.4f} (event loop "
                      f"{res['gather']['event_ms']:.4f}, "
                      f"{res['scan']['event_ms']:.4f}); faster {faster}, "
                      f"rule picks "
                      f"{gather_min_ops.gather_min_route(r, args.n, k)}",
                      flush=True)
        return results
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
