"""Device-to-host pull of the kNN stage's (N, k) results, timed alone.

The port of ``tools/probe_pull.py``: an (N, k) float32 array and an
(N, k) int32 array made on ``--device``, a ``torch.cuda.synchronize``,
then ``.cpu().numpy()`` timed; the best of ``--runs`` per dtype, with the
megabytes and the rate.

Run: ``python -m vqvae_tpu_torch.tools.probe_pull [--rows 983040]
[--k 11] [--runs 3] [--device cpu]``; prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from ..device import resolve_device


def _arrays(rows: int, k: int, seed: int, dev: torch.device):
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = torch.rand((rows, k), generator=gen, device=dev)
    # a cheap int payload: argsorts of a few rows, tiled
    i = torch.argsort(d[:k * 4, :k], dim=1).to(torch.int32)
    return d, i.repeat(rows // (k * 4) + 1, 1)[:rows].contiguous()


def run(rows: int = 983040, k: int = 11, runs: int = 3,
        device=None) -> Dict:
    """The pull times on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    results = {}
    for name, idx in (("f32", 0), ("i32", 1)):
        times = []
        for r in range(runs):
            arr = _arrays(rows, k, r, dev)[idx]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host = arr.cpu().numpy()
            times.append(time.perf_counter() - t0)
            del host, arr
        mb = rows * k * 4 / 1e6
        best = min(times)
        results[name] = {"mb": mb, "seconds": best, "mb_per_s": mb / best,
                         "all": times}
    return {"rows": rows, "k": k, "device": dev.type, "results": results}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=983040)
    ap.add_argument("--k", type=int, default=11)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.rows, args.k, args.runs, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
