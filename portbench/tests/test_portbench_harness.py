"""The harness: the import guard by whole top-level names, the files of a
cell found by name, the result line's keys, the refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import MANIFEST, TINY, run_tiny, tiny_cell

ROOT = harness.ROOT


def test_forbidden_modules_compare_whole_top_level_names():
    ok = ["vqvae_tpu_torch", "vqvae_tpu_torch.ops.knn", "portbench",
          "jaxtyping", "flaxy", "vqvae_tpu2"]
    bad = ["vqvae_tpu", "vqvae_tpu.ops.knn", "jax", "jax.numpy",
           "jaxlib.xla_client", "flax.linen", "optax", "orbax.checkpoint"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + bad) == sorted(bad)


def test_nothing_the_benchmark_runs_loads_jax():
    readers = [p.stem for p in (harness.HERE / "metrics").glob("*.py")]
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "import portbench.stages.vae_epochs\n"
        "import portbench.stages.codebook_builds, portbench.tools.readings\n"
        "import vqvae_tpu_torch.train.vae_engine\n"
        "import vqvae_tpu_torch.cli.build_codebook\n"
        "for m in %r: harness.reader(m)\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n"
        % (str(ROOT), readers))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_every_cell_and_metric_is_found_by_name():
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    per_layer = {m["name"] for m in manifest["per_layer"]}
    covered = set()
    for w in manifest["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        harness.stage_module(cell.traffic["stage"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
            covered.add(m["name"])
        assert set(cell.limits)
    assert covered == per_layer


def _file_digests(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_new_files_only(tmp_path, monkeypatch):
    """A later cell (here a CIFAR-10 codebook on traffic and a stage module
    of its own), its tiny size and a per-layer metric come as files of
    their own, and entries appended to ``BENCHMARK.json``; no file the
    benchmark has is edited. The copy's own suite then runs the cell at
    its tiny size through ``harness.run_cell`` and the window test."""
    bench = tmp_path / "portbench"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _file_digests(bench)
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    name = "cifar10-spatial-geodesic.codebook-wide"
    manifest["workloads"].append({"name": name,
                                  "config": "cifar10-spatial-geodesic",
                                  "traffic": "codebook-wide", "chips": 1,
                                  "why": "test"})
    manifest["end_to_end"][1]["workloads"].append(name)
    manifest["per_layer"].append({"name": "codebook.builds_seen",
                                  "unit": "builds", "better": "higher",
                                  "source": "program_counter",
                                  "layer": "stage entry",
                                  "moves": "codebook_build_s",
                                  "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = harness.load_json(bench / "traffic" / "codebook.json")
    (bench / "traffic" / "codebook-wide.json").write_text(
        json.dumps({**traffic, "stage": "codebook_wide", "lobes": 20}))
    shutil.copy(bench / "stages" / "codebook_builds.py",
                bench / "stages" / "codebook_wide.py")
    (bench / "limits" / f"{name}.json").write_text(
        json.dumps({"knn_miss": 0.0}))
    (bench / "tests" / "tiny" / f"{name}.json").write_text(
        json.dumps({"latent_images": 64, "codebook": {"K": 16}}))
    (bench / "metrics" / "codebook.builds_seen.py").write_text(
        "def read(trace, info):\n    return info.get('builds')\n")
    after = _file_digests(bench)
    assert {k: after[k] for k in before} == before
    monkeypatch.setattr(harness, "HERE", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.find_cell(name, manifest=manifest)
    assert cell.traffic["stage"] == "codebook_wide"
    assert cell.traffic["lobes"] == 20
    assert [m["name"] for m in cell.end_to_end] == ["codebook_build_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["codebook.builds_seen"]
    assert harness.reader("codebook.builds_seen")(None, {"builds": 5}) == 5

    # the copy's suite, importing the copy's portbench (the program from
    # this checkout): the new cell through run_cell and the window test,
    # and the tiny files against the copy's manifest
    tests = "portbench/tests/"
    ids = [f"{tests}test_portbench_harness.py::"
           f"test_a_window_counts_its_own_work[{name}]",
           f"{tests}test_portbench_reference.py::"
           f"test_port_matches_the_reference[{name}]",
           f"{tests}test_portbench_harness.py::"
           "test_tiny_overrides_name_existing_cells",
           f"{tests}test_portbench_harness.py::"
           "test_every_cell_and_metric_is_found_by_name"]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-W", "ignore::pytest.PytestUnknownMarkWarning",
         *ids], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "4 passed" in out.stdout, out.stdout[-2000:]
    assert _file_digests(bench) == after


def test_result_line_keys_and_order(tmp_path):
    result, notes = run_tiny("fmnist-spatial-geodesic.vae-train", tmp_path)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    # the cell's other end-to-end metric is read from the device's trace,
    # and on the CPU no device op ran
    assert set(result["metrics"]) == {"setup_s"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for c in result["checks"].values():
        assert list(c) == ["value", "limit"]
    assert "check_s" in notes
    json.dumps(result)


def test_a_device_trace_metric_has_its_window_traced(tmp_path,
                                                    monkeypatch):
    """A cell with an end-to-end metric read from the device's trace has
    each epoch of its untraced run's window traced, the device's activity
    alone, and reads the metric from those traces; a traced run's window
    stays untraced."""
    from portbench import tracing
    from portbench.stages import vae_epochs

    flags = []

    class Recorded(tracing.Window):
        def __init__(self, trace, device, host_ops=False):
            flags.append((bool(trace), host_ops))
            super().__init__(trace, device, host_ops)

    monkeypatch.setattr(tracing, "Window", Recorded)
    name = "fmnist-spatial-geodesic.vae-train"
    assert any(m["source"] == "device_trace"
               for m in harness.find_cell(name).end_to_end)
    cell = tiny_cell(name, tmp_path / "untraced")
    st = vae_epochs.setup(cell)
    st["trace_window"] = True
    counters = vae_epochs.window(st, 0.0)
    assert flags == [(True, False)]
    assert counters["epochs"] == 1 and counters["device_ops"] == 0
    assert counters["device_busy_s"] == 0.0
    flags.clear()
    run_tiny(name, tmp_path / "run")
    assert flags[0] == (False, False) and flags[1:] == [(True, False)] * (
        len(flags) - 1) and len(flags) >= 2
    flags.clear()
    run_tiny(name, tmp_path / "traced", trace=True)
    assert flags == [(False, False), (True, False), (True, True)]

    st = {}
    assert vae_epochs.end_to_end(
        st, {"epochs": 2, "device_busy_s": 3.0, "device_ops": 5}, 9.0) == {
        "vae_train_epoch_device_s": 1.5}
    assert st["notes"]["window_device_ops_an_epoch"] == 2.5
    # no device op ran (the CPU), or the window was not traced
    assert vae_epochs.end_to_end(
        {}, {"epochs": 2, "device_busy_s": 0.0, "device_ops": 0}, 9.0) == {}
    assert vae_epochs.end_to_end({}, {"epochs": 2}, 9.0) == {}


def test_traced_result_on_the_cpu_reports_no_device_metric(tmp_path):
    result, notes = run_tiny("fmnist-spatial-geodesic.vae-train", tmp_path,
                             trace=True)
    assert result["metrics"] == {}
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    clocks = notes["host_clocks"]
    assert set(clocks) == {"window", "device_traced", "host_ops_traced"}
    assert clocks["window"]["thread_cpu"] > 0


def test_traced_cost_reads_the_kind_the_stage_reports(monkeypatch):
    """``tools/traced_cost.py`` takes the VAE path from the kind the stage
    reports (its ``info()``), not from the stage module's name: a new
    cell's copy of the VAE stage under a name of its own is timed a
    step."""
    from portbench.stages import vae_epochs
    from portbench.tools import traced_cost

    name, kind = "fmnist-spatial-geodesic.vae-train", "vae_epochs_renamed"
    find, load = harness.find_cell, harness.stage_module

    def renamed(*a, **kw):
        cell = find(*a, **kw)
        cell.traffic = {**cell.traffic, "stage": kind}
        return cell

    monkeypatch.setattr(harness, "find_cell", renamed)
    monkeypatch.setattr(harness, "stage_module",
                        lambda k: vae_epochs if k == kind else load(k))
    row = traced_cost.rounds(name, 2121692627, 1, device="cpu",
                             overrides=TINY[name])
    assert len(row["untraced_ms_a_step"]) == 1


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_window_counts_its_own_work(name, tmp_path):
    """The traced stretch after the window is a second call of the
    stage's window: each call counts only the work it ran."""
    from .conftest import tiny_cell
    cell = tiny_cell(name, tmp_path)
    stage = harness.stage_module(cell.traffic["stage"])
    st = stage.setup(cell)
    first, second = stage.window(st, 0.0), stage.window(st, 0.0)
    assert first == second
    assert first["attempted"] > 0


def test_no_cuda_means_no_result(capsys):
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    code = harness.main(["--workload", "fmnist-spatial-geodesic.vae-train",
                         "--seed", "1", "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_benchmark_files_alone_refuse_to_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fmnist-spatial-geodesic.vae-train", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 5 and out.stdout == ""
    assert "program is missing" in out.stderr


def test_unknown_workload_is_refused(capsys):
    assert harness.main(["--workload", "nope.nothing", "--seed", "1",
                         "--seconds", "1"], 0.0) == 2
    assert capsys.readouterr().out == ""


def test_tiny_overrides_name_existing_cells():
    assert set(TINY) == {w["name"] for w in MANIFEST["workloads"]}


def test_the_vae_rate_and_device_share_readers():
    import numpy as np

    from portbench import tracing, yardstick

    read = harness.reader("vae_train.images_per_s")
    assert read(None, {"stage": "vae_train", "images": 120000,
                       "window_s": 8.0}) == 15000.0
    assert read(None, {"stage": "codebook", "builds": 3,
                       "window_s": 8.0}) is None
    # the traced epoch's FLOPs over its 2 s of device work
    read = harness.reader("vae_train.mfu_device_pct")
    ns = 10 ** 9
    trace = tracing.Trace(9.0, np.array([0, ns // 2]), np.array([ns, 2 * ns]),
                          ["a", "b"])
    info = {"stage": "vae_train", "traced": {"flops": yardstick.F32_FLOPS}}
    assert read(trace, info) == 50.0
    empty = tracing.Trace(9.0, np.zeros(0, np.int64), np.zeros(0, np.int64),
                          [])
    assert read(empty, info) is None
    assert read(None, info) is None
    assert read(trace, {**info, "stage": "codebook"}) is None
