"""Profiling and tracing for the pipeline's stages.

The port of ``vqvae_tpu/utils/profiling.py``, with the program's own spans:

- ``span`` and ``count``: named ranges and counters inside the program
  (every name starts with ``vqvae.``). They record only while a
  ``torch.profiler`` session is active (``profile_trace``, or any
  caller's ``torch.profiler.profile``): a span then enters
  ``torch.profiler.record_function(name)``, so the trace shows it on the
  clock of the device's kernels, and appends a row to an in-memory table
  (``spans()``, ``reset_spans()``): its name, start and end on the
  profiler's clock (``clock``, nanoseconds), the span open around it on
  the same thread, and the thread. A counter is a row whose ``count``
  holds the amount. With no session, ``span`` returns a shared null
  context after one check of the profiler's flag, and ``count`` does
  nothing. A span given a ``sink`` always reads the clock and adds its
  seconds to the sink (a dict under ``key``, or a list it appends to),
  traced or not; ``after`` chains sink spans (see ``span``);
- ``stage_timer``: a sink span that prints the block's seconds (the
  pipeline's per-stage timings);
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
from typing import Dict, Iterator, List, NamedTuple, Optional, Union

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# the profiler's clock: torch stamps its host events, and CUPTI's device
# events are converted, in Unix-epoch nanoseconds
clock = time.time_ns


class SpanRow(NamedTuple):
    """One finished span, or one counter (``count`` not None, ``start`` ==
    ``end``), on ``clock``'s nanoseconds."""

    name: str
    start: int
    end: int
    parent: Optional[str]
    thread: int
    count: Optional[int] = None


_ROWS: List[SpanRow] = []
_LOCAL = threading.local()
_NULL = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is active in this process."""
    return _autograd_profiler._is_profiler_enabled


def _open() -> List[str]:
    """This thread's stack of open span names."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Span:
    __slots__ = ("name", "sink", "key", "after", "start", "end", "parent",
                 "_range")

    def __init__(self, name: str, sink, key: Optional[str], after):
        self.name, self.sink, self.key, self.after = name, sink, key, after
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
            stack = _open()
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
            self.start = clock()  # inside the profiler's range
        elif self.after is not None:
            self.start = self.after.end  # one reading at the boundary
        else:
            self.start = clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = clock()
        if isinstance(self.sink, list):
            self.sink.append(self.seconds)
        elif self.sink is not None:
            self.sink[self.key] = self.sink.get(self.key, 0.0) + self.seconds
        if self._range is not None:
            _open().pop()
            _ROWS.append(SpanRow(self.name, self.start, self.end, self.parent,
                                 threading.get_ident()))
            self._range.__exit__(*exc)
            self._range = None
        return False


def span(name: str, sink: Union[Dict[str, float], List[float], None] = None,
         key: Optional[str] = None, after: Optional[_Span] = None):
    """``with span("vqvae.<layer>.<step>"):`` records the block while a
    profiler session is active (see the module's notes). ``sink``: a dict
    that gets the block's seconds added under ``key`` (default: the
    name's last dotted part), or a list that gets them appended, traced or
    not. ``after``: the sink span that ended where this one starts; with
    no session this one takes that span's end reading as its start, so
    consecutive spans' seconds add up to the whole run of them exactly (a
    traced span reads its own start, inside its profiler range)."""
    if sink is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, sink, key or name.rsplit(".", 1)[-1], after)


def count(name: str, n: int = 1) -> None:
    """Record ``n`` under the counter ``name`` while a profiler session is
    active."""
    if _autograd_profiler._is_profiler_enabled:
        stack = _open()
        t = clock()
        _ROWS.append(SpanRow(name, t, t, stack[-1] if stack else None,
                             threading.get_ident(), int(n)))


def spans() -> List[SpanRow]:
    """The table: every span and counter recorded so far, in the order
    each ended."""
    return list(_ROWS)


def reset_spans() -> None:
    _ROWS.clear()


@contextlib.contextmanager
def stage_timer(name: str, sink: Optional[Dict[str, float]] = None
                ) -> Iterator[None]:
    """The span ``vqvae.<name>`` with ``sink`` (a dict of its own when
    None) under ``name``; prints the block's seconds."""
    s = _Span(f"vqvae.{name}", {} if sink is None else sink, name, None)
    try:
        with s:
            yield
    finally:
        print(f"[timer] {name}: {s.seconds:.2f}s")


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
