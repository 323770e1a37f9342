"""N pipeline runs of a preset in one process: the median and the band.

The port of ``tools/run_fullscale_median.py``: ``run_pipeline`` on
``--preset`` ``--runs`` times in one process (run 0 carries the kernel
builds), each run's seconds by stage and total, then the median total and
the band (min, max), written to ``--out``.

Run: ``python -m vqvae_tpu_torch.tools.run_fullscale_median [--runs 3]
[--preset configs/fullscale-fashion]
[--out experiments/fullscale-fashion-timings.json] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import Dict, Optional

from ..cli.pipeline import run_pipeline
from ..device import resolve_device


def run(preset="configs/fullscale-fashion", runs: int = 3,
        out="experiments/fullscale-fashion-timings.json",
        overrides: Optional[Dict] = None, root=".", device=None) -> Dict:
    """``runs`` pipeline runs on ``device`` (default the GPU), rooted at
    ``root`` with ``overrides``; writes and returns the record."""
    dev = resolve_device(device)
    Path(root).mkdir(parents=True, exist_ok=True)
    recs = []
    for r in range(runs):
        t0 = time.perf_counter()
        timings = run_pipeline(preset, overrides=overrides, root_dir=root,
                               device=dev)
        total = time.perf_counter() - t0
        recs.append({"run": r, "total_seconds": total, "stages": timings})
        print(f"[median-run {r}] total={total:.1f}s stages={timings}",
              flush=True)
    totals = [r["total_seconds"] for r in recs]
    record = {
        "protocol": f"{runs} full pipeline runs in one process (run 0 "
                    f"carries the kernel builds)",
        "runs": recs,
        "median_total_seconds": statistics.median(totals),
        "band_seconds": [min(totals), max(totals)],
    }
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--preset", default="configs/fullscale-fashion")
    ap.add_argument("--out",
                    default="experiments/fullscale-fashion-timings.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    record = run(args.preset, args.runs, args.out, device=args.device)
    print(json.dumps({"median_total_seconds":
                      record["median_total_seconds"],
                      "band_seconds": record["band_seconds"]}))
    return record


if __name__ == "__main__":
    main()
