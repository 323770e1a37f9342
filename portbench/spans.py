"""The program's own spans and counters (``spans()`` of
``vqvae_tpu_torch.utils.profiling``), for the readers under ``metrics/``.

The program records them only while a profiler session runs, so the table
holds the run's two traced stretches: the one that traces the device's
activity alone first, then the one that traces every host op. A reader
takes the rows inside the first span named ``root`` (the device-only
stretch, which the profiler slows least). A program without the table
gives nothing.
"""
from __future__ import annotations

from typing import List, Optional


def first_stretch(root: str) -> Optional[List]:
    """The rows (spans and counters) that start and end inside the
    earliest span named ``root``, or None without one."""
    try:
        from vqvae_tpu_torch.utils import profiling
    except ImportError:
        return None
    table = getattr(profiling, "spans", None)
    if table is None:
        return None
    rows = table()
    roots = [r for r in rows if r.name == root and r.count is None]
    if not roots:
        return None
    top = min(roots, key=lambda r: r.start)
    return [r for r in rows if r is not top
            and top.start <= r.start and r.end <= top.end]


def seconds(rows: List, *names: str) -> float:
    """Summed seconds of the spans named ``names``."""
    return sum(r.end - r.start for r in rows
               if r.name in names and r.count is None) / 1e9
