"""Profiling and tracing for the pipeline's stages.

The port of ``vqvae_tpu/utils/profiling.py``:

- ``stage_timer``: a wall-clock context manager that adds the block's
  seconds to a sink (the pipeline's per-stage timings);
- ``profile_trace``: a ``torch.profiler`` trace of the block (CPU
  activity, plus CUDA activity when a card is visible), written as a
  Chrome trace to ``<VQVAE_TPU_PROFILE_DIR>/<name>/trace.json``; a no-op
  unless that variable is set. Open it in Perfetto or chrome://tracing;
- ``CompileStats``: counts and times the programs the port compiles, the
  real ``nvcc`` and host-compiler builds of ``_build.compile_shared`` (a
  library reused from ``_build/`` does not count). The JAX side counts
  XLA backend compiles; the pipeline prints both the same way.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def stage_timer(name: str, sink: Optional[Dict[str, float]] = None
                ) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        print(f"[timer] {name}: {dt:.2f}s")


class CompileStats:
    """Counts the port's native builds through ``_build``'s listeners.

    Install once per process; ``snapshot()`` + ``delta()`` give per-stage
    counts. Builds may run in threads (one compiler per source), so the
    counters take a lock."""

    _installed: Optional["CompileStats"] = None

    def __init__(self) -> None:
        self.count = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def _on_build(self, secs: float) -> None:
        with self._lock:
            self.count += 1
            self.seconds += secs

    @classmethod
    def install(cls) -> "CompileStats":
        if cls._installed is None:
            from .. import _build

            inst = cls()
            _build.BUILD_LISTENERS.append(inst._on_build)
            cls._installed = inst
        return cls._installed

    def snapshot(self) -> Dict[str, float]:
        return {"programs": self.count, "compile_seconds": self.seconds}

    def delta(self, since: Dict[str, float]) -> Dict[str, float]:
        return {"programs": self.count - since["programs"],
                "compile_seconds": round(
                    self.seconds - since["compile_seconds"], 2)}


@contextlib.contextmanager
def profile_trace(name: str = "trace") -> Iterator[None]:
    """Trace the block with ``torch.profiler`` when
    ``VQVAE_TPU_PROFILE_DIR`` is set (under a process group, rank 0's
    block only)."""
    from ..parallel.mesh import is_primary

    out_dir = os.environ.get("VQVAE_TPU_PROFILE_DIR")
    if not out_dir or not is_primary():
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, name)
    os.makedirs(path, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    trace = os.path.join(path, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"[profile] trace written to {trace}")
