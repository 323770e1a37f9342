"""The harness: the import guard by whole top-level names, the files of a
cell found by name, the result line's keys, the refusals."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import MANIFEST, TINY, run_tiny

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


def test_a_new_cell_needs_new_files_only(tmp_path, monkeypatch):
    """A later cell (here the CIFAR codebook on traffic of its own) and a
    per-layer metric come as files of their own; no file the harness has
    is edited."""
    bench = tmp_path / "portbench"
    shutil.copytree(harness.HERE, bench)
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
    traffic = harness.load_json(bench / "traffic" / "codebook.json")
    (bench / "traffic" / "codebook-wide.json").write_text(
        json.dumps({**traffic, "lobes": 20}))
    (bench / "limits" / f"{name}.json").write_text(
        json.dumps({"knn_miss": 0.0}))
    (bench / "metrics" / "codebook.builds_seen.py").write_text(
        "def read(trace, info):\n    return info.get('builds')\n")
    monkeypatch.setattr(harness, "HERE", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    shutil.copytree(ROOT / "portbench" / "configs", bench / "configs",
                    dirs_exist_ok=True)
    cell = harness.find_cell(name, manifest=manifest)
    assert cell.traffic["stage"] == "codebook_builds"
    assert cell.traffic["lobes"] == 20
    assert [m["name"] for m in cell.end_to_end] == ["codebook_build_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["codebook.builds_seen"]
    assert harness.reader("codebook.builds_seen")(None, {"builds": 5}) == 5


def test_result_line_keys_and_order(tmp_path):
    result, notes = run_tiny("fmnist-spatial-geodesic.vae-train", tmp_path)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["metrics"]) == {"vae_train_images_per_s", "setup_s"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for c in result["checks"].values():
        assert list(c) == ["value", "limit"]
    assert "check_s" in notes
    json.dumps(result)


def test_traced_result_on_the_cpu_reports_no_device_metric(tmp_path):
    result, notes = run_tiny("fmnist-spatial-geodesic.vae-train", tmp_path,
                             trace=True)
    assert result["metrics"] == {}
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    clocks = notes["host_clocks"]
    assert set(clocks) == {"window", "device_traced", "host_ops_traced"}
    assert clocks["window"]["thread_cpu"] > 0


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
