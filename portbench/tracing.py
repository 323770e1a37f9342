"""The measured window, with or without ``torch.profiler``, and the
reduction of its trace to device-busy time, kernel time by name and idle
gaps by what the host was doing.

A traced block records the device's activity alone (CUPTI's kernels,
copies and sets, with the runtime calls that launch them), or with
``host_ops`` every host op as well, for the idle gaps. Either slows a
host-paced loop (1.7 and 2.2 times at the FashionMNIST VAE epoch), so the
measured window itself always runs untraced and the harness traces a
stretch of the same work after it.

Every window also reads the host's own clocks around it (``host``): the
main thread's and the process's CPU seconds, and the machine's CPU
seconds stolen by its hypervisor and its load (``/proc/stat``,
``/proc/loadavg``), so that a run whose host ran slow says why.

The busy time is the union of the device activity intervals (kernels,
copies, sets), the arithmetic of ``vqvae_tpu_torch/utils/profiling.py``'s
phase-16e share, copied here so that the yardstick does not move with the
program.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    """Seconds covered by the union of intervals (nanoseconds in)."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # an interval opens a new run where it starts past every earlier end
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    run_start = s[new]
    run_end = np.maximum.reduceat(e, np.nonzero(new)[0])
    return float((run_end - run_start).sum()) / 1e9


def idle_gaps(starts: np.ndarray, ends: np.ndarray
              ) -> List[Tuple[int, int]]:
    """(start, end) of every gap between the union's runs, nanoseconds."""
    if len(starts) == 0:
        return []
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    gap = s[1:] > reach[:-1]
    return list(zip(reach[:-1][gap].tolist(), s[1:][gap].tolist()))


@dataclass
class Trace:
    """Device intervals and host ops of a traced window (nanoseconds)."""

    window_s: float
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_name: List[str]
    host_start: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_end: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_name: List[str] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_seconds(self.dev_start, self.dev_end)

    def kernel_seconds(self, match) -> float:
        """Summed durations of the device ops whose name ``match`` takes."""
        pick = np.array([bool(match(n)) for n in self.dev_name], bool)
        if not pick.any():
            return 0.0
        return float((self.dev_end[pick] - self.dev_start[pick]).sum()) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        """The ``top`` device ops by summed seconds."""
        sums: Dict[str, float] = {}
        for n, d in zip(self.dev_name, (self.dev_end - self.dev_start)):
            sums[n] = sums.get(n, 0.0) + float(d) / 1e9
        best = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s] for n, s in best]

    def idle_by_host(self, top: int = 10) -> List[List]:
        """Idle seconds summed by the innermost host op running at each
        gap's midpoint ("host, between ops" where none ran)."""
        gaps = idle_gaps(self.dev_start, self.dev_end)
        sums: Dict[str, float] = {}
        if len(self.host_start):
            order = np.argsort(self.host_start, kind="stable")
            hs, he = self.host_start[order], self.host_end[order]
            names = [self.host_name[i] for i in order]
        for a, b in gaps:
            mid = (a + b) // 2
            name = "host, between ops"
            if len(self.host_start):
                hi = int(np.searchsorted(hs, mid, side="right"))
                lo = max(0, hi - 4096)
                cover = np.nonzero(he[lo:hi] >= mid)[0]
                if len(cover):
                    dur = he[lo:hi][cover] - hs[lo:hi][cover]
                    name = names[lo + int(cover[np.argmin(dur)])]
            sums[name] = sums.get(name, 0.0) + (b - a) / 1e9
        best = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s] for n, s in best]


def _events(prof):
    """(device rows, host rows) of a finished profiler as (start ns, end
    ns, name) lists, from kineto's raw events. A ``record_function``
    range drawn on the device's timeline (a user annotation, such as the
    optimizer's step) spans the gaps between its kernels: it is no device
    work and goes with the host rows."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        annotation = e.is_user_annotation() \
            if hasattr(e, "is_user_annotation") else "#" in e.name()
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1000)
        row = (int(start), int(start + dur), e.name())
        on_device = e.device_type() == DeviceType.CUDA and not annotation
        (dev if on_device else host).append(row)
    return dev, host


def _arrays(rows):
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), []
    s, e, n = zip(*rows)
    return np.asarray(s, np.int64), np.asarray(e, np.int64), list(n)


def _proc_stat() -> Dict[str, float]:
    """The machine's CPU seconds (``/proc/stat``'s first line) by kind."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        hz = float(os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError):
        return {}
    kinds = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
             "steal")
    return {k: t / hz for k, t in zip(kinds, ticks)}


def _host_clocks() -> Dict[str, float]:
    return {"thread_cpu": time.thread_time(),
            "process_cpu": time.process_time(), **_proc_stat()}


def _loadavg() -> float:
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0])
    except (OSError, ValueError):
        return float("nan")


class Window:
    """``with Window(trace, device) as w:`` times the block on the host
    clock (ending in a device sync) and, when ``trace``, records it with
    ``torch.profiler`` (the device's activity alone, or with
    ``host_ops`` every host op too); ``w.seconds``, ``w.trace`` and
    ``w.host`` (CPU seconds over the block, see the module's notes) after
    the block."""

    def __init__(self, trace: bool, device, host_ops: bool = False):
        self.tracing = bool(trace)
        self.host_ops = host_ops
        self.device = device
        self.seconds = 0.0
        self.trace: Optional[Trace] = None
        self.host: Dict[str, float] = {}
        self._prof = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.tracing:
            from torch.profiler import ProfilerActivity, profile
            cuda = self.device.type == "cuda"
            acts = [ProfilerActivity.CUDA] if cuda else []
            if self.host_ops or not cuda:
                acts.append(ProfilerActivity.CPU)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._sync()
        self._clocks = _host_clocks()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self._t0
        end = _host_clocks()
        self.host = {k: end[k] - v for k, v in self._clocks.items()
                     if k in ("thread_cpu", "process_cpu", "steal", "idle")}
        self.host["loadavg_1m"] = _loadavg()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                dev, host = _events(self._prof)
                ds, de, dn = _arrays(dev)
                hs, he, hn = _arrays(host)
                self.trace = Trace(self.seconds, ds, de, dn, hs, he, hn)
            self._prof = None
        return False
