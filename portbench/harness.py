"""One run of one cell: find its files by name, set up, measure the window,
check the outputs against the plain reference, print the result line.

``main`` is the command line (``portbench/run.py``); ``run_cell`` is the
run itself, which the tests drive on the CPU at small sizes. A run

1. finds the cell in ``BENCHMARK.json`` and its configuration, traffic,
   limits and per-layer readers by name under ``portbench/``;
2. refuses to run without as many CUDA devices as the cell asks for, and
   with a ``vqvae_tpu_torch`` from anywhere but this checkout;
3. sets up through the traffic kind's stage module (``stages/<kind>.py``),
   which makes every input from the seed and warms every shape the window
   runs; ``setup_s`` is the time from the start of the process to the
   window;
4. runs the window (``tracing.Window``, untraced; where the cell has an
   end-to-end metric read from the device's trace and the run reports
   it, the stage traces each unit of the window's work), reads the
   device's memory peak and, with ``--trace 1``, runs one more epoch or build with
   the device's activity traced (``busy_s``, ``window_s``, the kernels)
   and one with every host op traced (the idle gaps): the profiler slows
   a host-paced loop, so the readers take rates and shares of time from
   the window and device time per unit of work from the traced stretch;
   then frees the program's state and runs the comparison, each number
   beside its limit (``limits/<workload>.json``);
5. refuses to print a result when any module of ``jax``, ``jaxlib``,
   ``flax``, ``optax``, ``orbax`` or ``vqvae_tpu`` (by whole top-level
   name) is loaded.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vqvae_tpu")
# build and kernel caches of the program: fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench_cache"


class RunRefused(Exception):
    """A run that must print no result; ``code`` is the exit code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def forbidden_modules(names) -> List[str]:
    """Module names whose top-level part (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``vqvae_tpu_torch`` is not
    ``vqvae_tpu``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (deep_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


@dataclass
class Cell:
    """A workload with its files loaded, for one run."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    seed: int = 0
    device: Any = None
    workdir: Optional[Path] = None


def find_cell(name: str, manifest: Optional[Dict] = None,
              overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of the manifest with its configuration, traffic
    and limits files, and the metrics it reports."""
    if manifest is None:
        manifest = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise RunRefused(2, f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    if overrides:
        config = deep_merge(config, overrides)
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moves)]
    return Cell(name, entry, config, traffic, limits, e2e, per)


def stage_module(kind: str):
    return importlib.import_module(f"portbench.stages.{kind}")


def reader(metric: str):
    """The per-layer reader ``metrics/<metric>.py`` (its ``read``)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each compared number with its limit; a number missing, not finite
    or over its limit makes the run not correct."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit}
    return out


def all_within(checks: Dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell: Cell, seconds: float, trace: bool, t_start: float):
    """Set-up, window, check: (the result line as a dict, ``checks``
    last; notes for standard error)."""
    import torch

    from . import tracing

    stage = stage_module(cell.traffic["stage"])
    state = stage.setup(cell)
    # an end-to-end metric read from the device's trace: in the run that
    # reports it the stage traces each unit of its window's work (the
    # device's activity alone) and counts the device's busy seconds
    state["trace_window"] = not trace and any(
        m["source"] == "device_trace" for m in cell.end_to_end)
    with tracing.Window(False, cell.device) as win:
        t_window = time.perf_counter()
        counters = stage.window(state, seconds)
    setup_s = t_window - t_start
    cuda = cell.device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(cell.device)) if cuda else 0
    metrics: Dict[str, Dict] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = {**stage.end_to_end(state, counters, win.seconds),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": units[m["name"]]}
    host = {"window": win.host}
    dev = ops = traced = None
    if trace:
        # after the window, which runs as the untraced one does: one more
        # epoch or build with the device's activity traced, then one with
        # every host op traced for the idle gaps
        kept = dict(state.get("notes", {}))
        with tracing.Window(True, cell.device) as dev:
            traced = stage.window(state, 0.0)
        with tracing.Window(True, cell.device, host_ops=True) as ops:
            stage.window(state, 0.0)
        state["notes"] = kept
        host["device_traced"] = {"seconds": dev.seconds, **dev.host}
        host["host_ops_traced"] = {"seconds": ops.seconds, **ops.host}
    stage.release(state)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = judge(stage.check(state), cell.limits)
    notes = {**state.get("notes", {}), "host_clocks": host,
             "check_s": time.perf_counter() - t_check}
    if trace and cuda:  # device metrics come from the card alone
        info = {**stage.info(state, counters), "window_s": win.seconds,
                "traced": traced, "config": cell.config}
        for m in cell.per_layer:
            v = reader(m["name"])(dev.trace, info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device) if cuda
                       else "cpu"),
              "count": int(cell.entry.get("chips", 1)),
              "memory_peak_bytes": peak}
    result = {"correct": all_within(checks),
              "attempted": int(counters["attempted"]),
              "failed": int(counters["failed"]),
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = dev.trace.busy_s
        device["window_s"] = dev.seconds
        result["breakdown"] = {"device_ops": dev.trace.device_ops(),
                               "idle_gaps": ops.trace.idle_by_host()}
    result["checks"] = checks
    return result, notes


def _parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = _parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    workdir = None
    try:
        cell = find_cell(args.workload)
        try:
            import vqvae_tpu_torch
        except ImportError as e:
            raise RunRefused(5, f"the program is missing: {e}") from e
        where = Path(vqvae_tpu_torch.__file__).resolve()
        if ROOT not in where.parents:
            raise RunRefused(5, f"vqvae_tpu_torch comes from {where}, not "
                                f"from this checkout ({ROOT})")
        import torch

        need = int(cell.entry.get("chips", 1))
        if not torch.cuda.is_available():
            raise RunRefused(3, "no CUDA device: torch.cuda.is_available() "
                                "is False")
        if torch.cuda.device_count() < need:
            raise RunRefused(3, f"the cell needs {need} CUDA devices, "
                                f"{torch.cuda.device_count()} visible")
        workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
        cell.seed, cell.device, cell.workdir = (
            args.seed, torch.device("cuda", 0), workdir)
        result, notes = run_cell(cell, args.seconds, bool(args.trace),
                                 t_start)
        bad = forbidden_modules(list(sys.modules))
        if bad:
            raise RunRefused(4, "modules of the JAX package or JAX are "
                                "loaded: " + ", ".join(bad))
    except RunRefused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    finally:
        if workdir is not None:
            shutil.rmtree(workdir, ignore_errors=True)
    for name, c in notes.items():
        print(f"note {name} {c!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
