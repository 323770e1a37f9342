"""Shared set-up of the benchmark's CPU tests: one torch thread (tiny ops
cost far more across threads on a shared host) and the cells cut to sizes
the CPU holds."""
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")

# the cells at test size, one file a cell (``tiny/<workload>.json``, the
# overrides of its configuration): the same widths, a few batches, so a
# new cell brings its tiny size as a file of its own
TINY = {p.stem: harness.load_json(p)
        for p in sorted((Path(__file__).parent / "tiny").glob("*.json"))}


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_cell(name: str, workdir: Path, seed: int = 2121692627,
              device: str = "cpu") -> harness.Cell:
    cell = harness.find_cell(name, manifest=MANIFEST, overrides=TINY[name])
    cell.seed, cell.device, cell.workdir = seed, torch.device(device), workdir
    return cell


def run_tiny(name: str, workdir: Path, trace: bool = False, **kw):
    return harness.run_cell(tiny_cell(name, workdir, **kw), 0.2, trace,
                            time.perf_counter())
