"""What the program's spans (``utils/profiling.py``) cost, and what a
profiler session keeps of them.

- ``off_ns``: host nanoseconds of a ``with span(name):`` block with no
  profiler session (one check of the profiler's flag), over an empty
  block's;
- ``on_ns``: the same inside a ``torch.profiler`` session (the
  ``record_function`` range and the table's row), by the session's
  activities: the host's, the device's alone (as the benchmark's first
  traced stretch), both;
- ``step_spans``: the spans and counters that training steps of the VAE
  record, by name, a step (run under a profiler);
- ``session_rows``: the profiler's own rows of those ranges, by name and
  device type, from a session that traces the device's activity alone
  (as the benchmark's first traced stretch does) and from one that traces
  the host's ops too; on the CPU only the second.

Run: ``python -m vqvae_tpu_torch.tools.span_cost [--preset
configs/fashionmnist/spatial/geodesic] [--batch 256] [--device cpu]``
from the repository root; prints one JSON line (the card's name with it).
"""
from __future__ import annotations

import argparse
import json
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import torch

from ..config import load_config
from ..device import resolve_device
from ..models import VAE, flax_init_
from ..train.vae_engine import VAEEngine, seeded_generator
from ..utils import profiling


def _block_ns(enter, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with enter("vqvae.tools.span_cost"):
            pass
    return (time.perf_counter_ns() - t0) / n


def _null(name):
    return profiling._NULL


def off_ns(n: int = 1_000_000) -> float:
    """Nanoseconds a span adds with no profiler session."""
    if profiling.tracing():
        raise RuntimeError("a profiler session is active")
    return _block_ns(profiling.span, n) - _block_ns(_null, n)


def on_ns(activities, n: int = 20_000) -> float:
    """Nanoseconds a span adds inside a profiler session of
    ``activities`` (its rows are dropped from the table again)."""
    from torch.profiler import profile

    kept = profiling.spans()
    with profile(activities=activities):
        cost = _block_ns(profiling.span, n) - _block_ns(_null, n)
    profiling.reset_spans()
    profiling._ROWS.extend(kept)
    return cost


def _session(step, activities, steps: int):
    from torch.autograd import DeviceType
    from torch.profiler import profile

    kept = profiling.spans()
    profiling.reset_spans()
    with profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        if any(a.name == "CUDA" for a in activities):
            torch.cuda.synchronize()
    rows = profiling.spans()
    profiling.reset_spans()
    profiling._ROWS.extend(kept)
    kineto = Counter(
        f"{e.name()} {'cuda' if e.device_type() == DeviceType.CUDA else 'cpu'}"
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("vqvae."))
    return rows, kineto


def step_spans(eng: VAEEngine, images, mask, steps: int = 3
               ) -> Dict[str, float]:
    """Spans and counters a training step of ``eng`` records, by name."""
    from torch.profiler import ProfilerActivity

    gen = seeded_generator(eng.device, 0)
    rows, _ = _session(lambda: eng.train_step(images, mask, 1.0, gen,
                                              nan_guard=True),
                       [ProfilerActivity.CPU], steps)
    return {k: v / steps for k, v in Counter(r.name for r in rows).items()}


def session_rows(eng: VAEEngine, images, mask, steps: int = 3) -> Dict:
    """The profiler's rows named ``vqvae.*`` by name and device type, in
    a device-only session (with a card) and a host + device one."""
    from torch.profiler import ProfilerActivity

    gen = seeded_generator(eng.device, 0)
    step = lambda: eng.train_step(images, mask, 1.0, gen,  # noqa: E731
                                  nan_guard=True)
    out = {}
    cuda = eng.device.type == "cuda"
    if cuda:
        out["device_only"] = dict(
            _session(step, [ProfilerActivity.CUDA], steps)[1])
    out["host_and_device"] = dict(_session(
        step, [ProfilerActivity.CPU]
        + ([ProfilerActivity.CUDA] if cuda else []), steps)[1])
    return out


def run(preset: Path, batch: int, device=None) -> Dict:
    dev = resolve_device(device)
    cfg = load_config(Path(preset) / "vae.yaml")
    arch = dict(cfg["model"])
    arch.pop("beta", None)
    model = flax_init_(VAE(**arch), seeded_generator("cpu", 42))
    eng = VAEEngine(model, lr=float(cfg["lr"]), device=dev,
                    grad_clip_max_norm=float(cfg["grad_clip_max_norm"]))
    size = int(arch["output_image_size"])
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((batch, size, size, int(arch["in_channels"])),
                        generator=gen).to(dev)
    mask = torch.ones(batch, device=dev)
    for _ in range(2):  # warm-up
        eng.train_step(images, mask, 1.0, seeded_generator(dev, 0),
                       nan_guard=True)
    from torch.profiler import ProfilerActivity

    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    sessions = {"host": [cpu]}
    if dev.type == "cuda":
        sessions.update(device=[cuda], host_and_device=[cpu, cuda])
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "off_ns": off_ns(),
           "on_ns": {k: on_ns(a) for k, a in sessions.items()},
           "step_spans": step_spans(eng, images, mask),
           "session_rows": session_rows(eng, images, mask)}
    out["spans_a_step"] = sum(out["step_spans"].values())
    return out


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="configs/fashionmnist/spatial/"
                                        "geodesic")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(Path(args.preset), args.batch, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
