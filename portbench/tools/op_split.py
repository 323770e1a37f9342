"""A training cell's device time by the host op that launched it, over one
epoch, in one process: where the step's time goes, by layer.

    python3 portbench/tools/op_split.py --workload <name> --seed <n> \
        [--out <file.jsonl>]

Set-up as a run does it, one epoch warm, then one epoch traced with every
host op (``torch.profiler``, the CPU's and the device's activity): each
op's own device time (``self_device_time_total``: the kernels it launched
itself) summed, over the ATen ops, into the first family whose pattern
its name matches, in ``FAMILIES``' order. One JSON line on standard
output: the epoch's device seconds by family, the ten largest ops, and
the device's name.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

FAMILIES = (
    ("convolution", r"convolution|cudnn"),
    ("groupnorm", r"group_norm"),
    ("batchnorm", r"batch_norm|_TrainNorm"),
    ("silu", r"silu"),
    ("attention", r"attention|sdpa"),
    ("linear", r"^aten::(addmm|mm|bmm|linear)$"),
    ("optimizer", r"_foreach_|_fused_adam"),
    ("nan_guard", r"^aten::where$"),
    ("other", r""),
)


def family(op: str) -> str:
    return next(name for name, pat in FAMILIES if re.search(pat, op))


def _self_device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def split(workload: str, seed: int, device=None, overrides=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cell = harness.find_cell(workload, overrides=overrides)
    cell.seed = seed
    cell.device = (torch.device("cuda", 0) if device is None
                   else torch.device(device))
    cell.workdir = Path(tempfile.mkdtemp(prefix="portbench-split-"))
    stage = harness.stage_module(cell.traffic["stage"])
    cuda = cell.device.type == "cuda"
    try:
        st = stage.setup(cell)
        stage.window(st, 0.0)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            stage.window(st, 0.0)
        # ATen ops alone: the program's spans and the optimizer's step are
        # ranges drawn over the kernels of the ops inside them
        ops = {e.key: _self_device_us(e) / 1e6 for e in prof.key_averages()
               if e.key.startswith("aten::")}
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)
    by = {name: 0.0 for name, _ in FAMILIES}
    for op, s in ops.items():
        by[family(op)] += s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"workload": workload, "seed": seed,
            "device": (torch.cuda.get_device_name(cell.device) if cuda
                       else "cpu"),
            "device_s": by, "total_s": sum(by.values()),
            "top_ops": [[k, v] for k, v in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Device time by host op.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    line = json.dumps(split(args.workload, args.seed))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
