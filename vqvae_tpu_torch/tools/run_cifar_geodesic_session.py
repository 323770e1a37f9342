"""One-process CIFAR-10 spatial-geodesic session.

The port of ``tools/run_cifar_geodesic_session.py``, in one process:

1. the posterior-collapse probe (``check_cifar_collapse``) at a reduced
   scale; on ``collapsed`` the session stops with exit code 2;
2. the full ``configs/cifar10/spatial/geodesic`` pipeline through
   ``run_pipeline``, its per-stage seconds written to ``--timings-out``;
3. the path-dilation experiment (``experiments_geo.run_riemann_experiments``)
   on the pipeline's experiment directory.

One deliberate difference: JAX runs step 3 in a subprocess pinned to the
CPU; here it runs in process, on the session's device.

Run: ``python -m vqvae_tpu_torch.tools.run_cifar_geodesic_session
[--probe-size 8192] [--probe-epochs 30] [--skip-probe] [--skip-pipeline]
[--root .] [--timings-out <json>] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from ..cli.pipeline import run_pipeline
from ..config import load_config
from ..device import resolve_device
from ..experiments_geo import run_riemann_experiments
from . import check_cifar_collapse

PRESET = Path(__file__).resolve().parents[2] / check_cifar_collapse.PRESET


def run(probe_size: int = 8192, probe_epochs: int = 30,
        skip_probe: bool = False, skip_pipeline: bool = False,
        preset=PRESET, root=".", overrides: Optional[Dict] = None,
        timings_out: Optional[str] = None, device=None) -> Dict:
    """The session on ``device`` (default the GPU), rooted at ``root``
    (the preset's relative ``experiments/...`` paths land under it;
    ``overrides`` go to ``run_pipeline``). Returns the probe, the
    timings and the dilation record; ``collapsed`` set means the probe
    stopped it."""
    dev = resolve_device(device)
    preset, root = Path(preset).resolve(), Path(root)
    out: Dict = {"collapsed": False}
    if not skip_probe:
        out["probe"] = check_cifar_collapse.run(
            preset, probe_size, probe_epochs,
            root / "experiments/_cifar_collapse_probe", device=dev)
        print("[session] probe:", json.dumps(out["probe"]), flush=True)
        if out["probe"]["collapsed"]:
            print("[session] recipe still collapses — NOT running the "
                  "full pipeline", flush=True)
            out["collapsed"] = True
            return out
    if not skip_pipeline:
        timings = run_pipeline(preset, overrides=overrides, root_dir=root,
                               device=dev)
        out["timings"] = timings
        path = Path(timings_out or
                    root / "experiments/cifar10-spatial-geodesic-timings.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(timings, indent=2))
        print("[session] pipeline timings:", json.dumps(timings), flush=True)
    exp = root / load_config(preset / "quality.yaml")["experiment"]
    out["dilation"] = run_riemann_experiments.run(exp, device=dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe-size", type=int, default=8192)
    ap.add_argument("--probe-epochs", type=int, default=30)
    ap.add_argument("--skip-probe", action="store_true")
    ap.add_argument("--skip-pipeline", action="store_true")
    ap.add_argument("--root", default=".")
    ap.add_argument("--timings-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.probe_size, args.probe_epochs, args.skip_probe,
              args.skip_pipeline, root=args.root,
              timings_out=args.timings_out, device=args.device)
    print(f"[session] total {time.perf_counter() - t0:.1f}s", flush=True)
    return 2 if out["collapsed"] else 0


if __name__ == "__main__":
    sys.exit(main())
