"""What tracing costs a cell's unit of work, in one process.

    python3 portbench/tools/traced_cost.py --workload <name> --seed <n> \
        [--reps 5] [--out <file.jsonl>]

Set-up as a run does it, then ``--reps`` rounds of one epoch or build
each way: untraced, with the device's activity traced, and with every host
op traced too (the run's three ``tracing.Window`` kinds, in that order),
each traced kind also with the program's spans held off (``*_spans_off``:
its profiler flag read as off, where the program has spans). The host's
speed swings within a run (PERF.md §2), so each traced unit is set
against the untraced one of its own round, and the spans' own cost is the
traced kind against its spans-off twin. Where the program records its
spans, each traced epoch also gives ``vae_train.step_host_ms`` and
``vae_train.batchnorm_host_ms`` as the benchmark's readers read them, and
the untraced epoch its seconds over its training steps. One JSON line on
standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, tracing  # noqa: E402

KINDS = (("untraced", False, False), ("device", True, False),
         ("device_spans_off", True, False), ("host_ops", True, True),
         ("host_ops_spans_off", True, True))
READERS = ("vae_train.step_host_ms", "vae_train.batchnorm_host_ms")


class _FlagOff:
    _is_profiler_enabled = False


@contextlib.contextmanager
def _spans(on: bool):
    """The program's spans as they are, or held off (the flag they check
    read as off) where the program has them."""
    from vqvae_tpu_torch.utils import profiling

    real = getattr(profiling, "_autograd_profiler", None)
    if on or real is None:
        yield
        return
    profiling._autograd_profiler = _FlagOff
    try:
        yield
    finally:
        profiling._autograd_profiler = real


def _reset_spans() -> None:
    from vqvae_tpu_torch.utils import profiling

    getattr(profiling, "reset_spans", lambda: None)()


def rounds(workload: str, seed: int, reps: int, device=None,
           overrides=None):
    import torch

    cell = harness.find_cell(workload, overrides=overrides)
    cell.seed = seed
    cell.device = (torch.device("cuda", 0) if device is None
                   else torch.device(device))
    cell.workdir = Path(tempfile.mkdtemp(prefix="portbench-cost-"))
    stage = harness.stage_module(cell.traffic["stage"])
    vae = None  # the kind the stage reports, from its first unit of work
    out = {k: [] for k, _, _ in KINDS}
    spans_of = ("device", "host_ops")
    spans = {f"{kind}.{m}": [] for kind in spans_of for m in READERS}
    try:
        st = stage.setup(cell)
        for _ in range(reps):
            for kind, traced, host_ops in KINDS:
                _reset_spans()
                with _spans(not kind.endswith("_spans_off")), \
                        tracing.Window(traced, cell.device, host_ops) as w:
                    counters = stage.window(st, 0.0)
                out[kind].append(w.seconds)
                if vae is None:
                    vae = stage.info(st, counters)["stage"] == "vae_train"
                if vae and kind in spans_of:
                    for m in READERS:
                        v = harness.reader(m)(None, {"stage": "vae_train"})
                        if v is not None:
                            spans[f"{kind}.{m}"].append(v)
                for path in st.get("outs", []):
                    shutil.rmtree(path, ignore_errors=True)
        _reset_spans()
        row = {"workload": workload, "seed": seed, "seconds": out,
               "slowdown": {k: statistics.median(
                   t / u for t, u in zip(out[k], out["untraced"]))
                   for k in out if k != "untraced"},
               "spans_cost": {k: statistics.median(
                   t / u for t, u in zip(out[k], out[f"{k}_spans_off"]))
                   for k in spans_of}}
        if vae:
            row["untraced_ms_a_step"] = [1e3 * s / st["tr_steps"]
                                         for s in out["untraced"]]
        row["spans"] = {k: v for k, v in spans.items() if v}
        return row
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Tracing's cost to a cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    row = rounds(args.workload, args.seed, args.reps)
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
