"""The port's profiling layer (``utils/profiling.py``) and its use by the
orchestrator.

- ``stage_timer`` adds each block's seconds to its sink;
- ``profile_trace`` writes nothing without ``VQVAE_TPU_PROFILE_DIR`` and a
  non-empty Chrome trace (CPU activity here) with it;
- ``CompileStats`` counts a real build of ``_build.compile_shared`` (a
  tiny C++ source, ``BUILD_DIR`` in a temporary directory) and not a
  reused one;
- ``run_pipeline`` traces each stage under the profile directory, prints
  each stage's compile count, and writes ``programs_compiled`` and
  ``compile_seconds`` into the ``VQVAE_TPU_TIMINGS_PATH`` JSON, as JAX's
  orchestrator does.
"""
import json
import time
from pathlib import Path

import pytest
import torch

from vqvae_tpu_torch import _build
from vqvae_tpu_torch.cli import pipeline
from vqvae_tpu_torch.utils.profiling import (CompileStats, profile_trace,
                                             stage_timer)

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "configs" / "sandbox-fashion" / "geodesic"
SOURCE = 'extern "C" int vq_answer(void) { return 42; }\n'


def _compile(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "answer.cpp"
    src.write_text(SOURCE)
    return _build.compile_shared(src, ["g++", "-shared", "-fPIC", "-O0"])


def test_stage_timer_accumulates_sink():
    sink = {}
    with stage_timer("a", sink):
        time.sleep(0.01)
    with stage_timer("a", sink):
        pass
    with stage_timer("b", sink):
        pass
    assert set(sink) == {"a", "b"} and sink["a"] >= 0.01


def test_profile_trace_is_off_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("VQVAE_TPU_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profile_trace("stage"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("VQVAE_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    with profile_trace("stage"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = tmp_path / "prof" / "stage" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_compile_stats_counts_real_builds_only(tmp_path, monkeypatch):
    stats = CompileStats.install()
    assert CompileStats.install() is stats
    before = stats.snapshot()
    path, log = _compile(tmp_path, monkeypatch)
    assert path.exists() and path.parent == tmp_path / "_build"
    first = stats.delta(before)
    assert first["programs"] == 1 and first["compile_seconds"] >= 0.0
    again, log = _compile(tmp_path, monkeypatch)  # reused: not counted
    assert again == path and log == ""
    assert stats.delta(before)["programs"] == 1


def test_run_pipeline_traces_stages_and_writes_compile_counts(
        tmp_path, monkeypatch, capsys):
    """One configured stage whose work is a native build: the stage's
    trace, its printed count and the timings JSON's keys."""
    ran = []

    def stage(name, cfg, device):
        ran.append((name, device.type))
        _compile(tmp_path, monkeypatch)

    monkeypatch.setattr(pipeline, "_run_stage", stage)
    monkeypatch.setenv("VQVAE_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("VQVAE_TPU_TIMINGS_PATH", str(tmp_path / "t.json"))
    skip = set(pipeline.STAGES) - {"codebook"}
    timings = pipeline.run_pipeline(PRESET, skip=skip, root_dir=tmp_path,
                                    device="cpu")
    assert ran == [("codebook", "cpu")]
    assert set(timings) == {"codebook", "total"}
    written = json.loads((tmp_path / "t.json").read_text())
    assert written["programs_compiled"] == 1
    assert written["compile_seconds"] >= 0.0
    assert written["codebook"] == pytest.approx(timings["codebook"])
    assert (tmp_path / "prof" / "codebook" / "trace.json").stat().st_size > 0
    out = capsys.readouterr().out
    assert "[pipeline] codebook done in" in out
    assert "(1 programs compiled," in out
    assert "1 programs compiled" in out.split("TOTAL")[1]
