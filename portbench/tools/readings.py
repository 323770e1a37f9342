"""The compared numbers of a cell over many seeds, the program's and its
low-precision control's, in one process: the readings its limits are set
from (the benchmark's own runs never run the control).

    python3 portbench/tools/readings.py --workload <name> \
        --seeds 1,2,3 [--control 1] [--out <file.jsonl>]

For each seed: set-up as a run does it (the training cells' held steps),
one build for the codebook cell (the training cells need no window), then the
program's numbers and, with ``--control 1``, the control's (the reference
in TF32 in the program's place). One JSON line per seed on standard output
and, with ``--out``, appended to that file.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402


def readings(workload: str, seeds, control: bool, device=None,
             overrides=None):
    import torch

    cell = harness.find_cell(workload, overrides=overrides)
    cell.device = (torch.device("cuda", 0) if device is None
                   else torch.device(device))
    stage = harness.stage_module(cell.traffic["stage"])
    for seed in seeds:
        cell.seed = seed
        cell.workdir = Path(tempfile.mkdtemp(prefix="portbench-readings-"))
        try:
            t0 = time.perf_counter()
            st = stage.setup(cell)
            if cell.traffic["stage"] == "codebook_builds":
                stage.window(st, 0.0)  # one build
            stage.release(st)
            row = {"workload": workload, "seed": seed,
                   "program": stage.check(st)}
            if st.get("notes"):
                row["notes"] = dict(st["notes"])
            if control:
                row["control"] = stage.check(st, control=True)
            row["seconds"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(cell.workdir, ignore_errors=True)
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    for row in readings(a.workload, seeds, bool(a.control)):
        line = json.dumps(row)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
