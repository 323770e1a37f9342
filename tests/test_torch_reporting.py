"""Port parity: the reporting scripts, the visualizations and the legacy
VAE trainer.

- ``cli.compare_all_approaches`` against ``scripts/compare_all_approaches.py``
  (run in process) on the same directories: a port sandbox run, synthetic
  result directories in each file layout the loader reads, and a missing
  one. The same rows and columns, every value equal (NaN where JAX's is
  NaN), and the same best-PSNR and best-LPIPS lines;
- JAX's ``tools/make_results_table.py`` reading that sandbox run's
  artifacts: PSNR, SSIM and the quantization analysis present (LPIPS is
  null: no weights in the repository);
- ``visualizations.knn_experiments`` and ``interactive_knn_viz``: per k the
  components and the LCC share equal, the mean geodesic distance from
  sources 0-7 within rtol 1e-6 of JAX's functions' (the same graphs, each
  Dijkstra sums in its own float order), and JAX's script prints the same
  lines; the explorer's distances within rtol 1e-6 of JAX's ``Explorer``;
  both ``main``s write their PNG;
- ``cli.train_legacy_vae``'s composed config equal to JAX's script's (run
  with its trainer replaced), and one epoch of it on the CPU.
"""
import csv
import importlib.util
import math
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu_torch.cli import compare_all_approaches as cmp_port
from vqvae_tpu_torch.cli import train_legacy_vae
from vqvae_tpu_torch.cli.pipeline import run_pipeline
from vqvae_tpu_torch.visualizations import interactive_knn_viz, knn_experiments

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "configs" / "sandbox-fashion" / "geodesic"
EXP = Path("experiments") / "sandbox-fashion" / "geodesic"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(rel: str):
    path = REPO / rel
    spec = importlib.util.spec_from_file_location("jax_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_paths(monkeypatch):
    """The JAX scripts import ``_common`` and ``plot_utils`` from their
    own directories."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    monkeypatch.syspath_prepend(str(REPO / "visualizations"))


@pytest.fixture(scope="module")
def sandbox_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("sandbox")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LPIPS_WEIGHTS", raising=False)
        run_pipeline(PRESET, overrides={
            "vae": {"max_epochs": 1, "data": {"synthetic_size": 128}},
            "quality": {"synthetic_size": 64},
            "transformer": {"training": {"epochs": 1}},
            "evaluate": {"data": {"synthetic_size": 64}}},
            root_dir=root, device="cpu")
    return root


def _result_dirs(root: Path, run: Path):
    """Directories in each layout the loader reads."""
    a = root / "yaml_and_health"
    (a / "evaluation").mkdir(parents=True)
    (a / "evaluation" / "metrics.yaml").write_text(yaml.safe_dump(
        {"PSNR": "21.5", "SSIM": 0.61, "LPIPS": 0.2, "note": "text",
         "FID": None}))
    (a / "evaluation" / "codebook_health.json").write_text(
        '{"entropy": 7.5, "used_codes": 400, "usage_percent": 78.125, '
        '"health_assessment": "GOOD"}')
    b = root / "results_json"
    b.mkdir()
    (b / "evaluation_results.json").write_text(
        '{"recon_psnr": 23.25, "recon_ssim": 0.7, "lpips": 0.15, '
        '"psnr_db": 1.0, "ok": true}')
    c = root / "quant_only"
    c.mkdir()
    (c / "quantization_analysis.json").write_text(
        '{"psnr_continuous_vs_quantized": 30.5, '
        '"ssim_continuous_vs_quantized": 0.9}')
    return [("sandbox", str(run)), ("yaml_and_health", str(a)),
            ("results_json", str(b)), ("missing", str(root / "nope")),
            ("quant_only", str(c))]


def _read_csv(path: Path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], {r[0]: [math.nan if v == "" else float(v)
                            for v in r[1:]] for r in rows[1:]}


def test_compare_all_approaches_matches_jax(tmp_path, sandbox_run,
                                            jax_paths, monkeypatch):
    pairs = _result_dirs(tmp_path, sandbox_run / EXP)
    table = cmp_port.run(pairs, tmp_path / "port")
    mod = _jax_script("scripts/compare_all_approaches.py")
    monkeypatch.setattr(sys, "argv", [mod.__file__, "--approaches",
                                      *(f"{n}={p}" for n, p in pairs),
                                      "--out_dir", str(tmp_path / "jax")])
    mod.main()
    head, got = _read_csv(tmp_path / "port" / "comparison_table.csv")
    jax_head, want = _read_csv(tmp_path / "jax" / "comparison_table.csv")
    assert head == jax_head and list(got) == list(want) == list(table)
    assert "missing" not in got
    for name, row in want.items():
        np.testing.assert_array_equal(got[name], row, err_msg=name)
    assert not math.isnan(got["sandbox"][0])  # the run's PSNR was read
    port_md = (tmp_path / "port" / "comparison_report.md").read_text()
    jax_md = (tmp_path / "jax" / "comparison_report.md").read_text()
    best = [line for line in jax_md.splitlines()
            if line.startswith("**Best")]
    assert len(best) == 2
    assert [line for line in port_md.splitlines()
            if line.startswith("**Best")] == best


def test_compare_main_writes_charts(tmp_path, sandbox_run):
    pairs = _result_dirs(tmp_path, sandbox_run / EXP)
    cmp_port.main(["--approaches", *(f"{n}={p}" for n, p in pairs),
                   "--out_dir", str(tmp_path / "out")])
    for name in ("comparison_table.csv", "comparison_report.md",
                 "comparison_charts.png", "entropy_vs_psnr.png"):
        assert (tmp_path / "out" / name).stat().st_size > 0, name
    assert cmp_port.run([("gone", str(tmp_path / "gone"))],
                        tmp_path / "none") is None


def test_make_results_table_reads_a_port_run(sandbox_run):
    mod = _jax_script("tools/make_results_table.py")
    rows = mod.collect(sandbox_run / "experiments")
    assert len(rows) == 1
    row = rows[0]
    assert row["psnr"] is not None and row["ssim"] is not None
    assert np.isfinite(row["psnr"]) and np.isfinite(row["ssim"])
    assert row["lpips"] is None and row["grid"] is not None
    assert {"psnr_real_vs_continuous", "psnr_real_vs_quantized",
            "psnr_continuous_vs_quantized", "ssim_real_vs_continuous",
            "ssim_real_vs_quantized",
            "ssim_continuous_vs_quantized"} <= set(row["quant"])
    text = mod.render(rows, sandbox_run / "experiments")
    assert row["method"] in text and f"{row['psnr']:.2f}" in text


def test_knn_experiments_match_jax(tmp_path, jax_paths, monkeypatch,
                                   capsys):
    from vqvae_tpu.ops import analyze_graph_connectivity, build_knn_graph
    from vqvae_tpu.ops.backend import multi_source_distances

    z = knn_experiments.load_points(None, 400)
    ks = (1, 5, 10)
    got = knn_experiments.run(z, ks, device="cpu")["rows"]
    port_lines = [line for line in capsys.readouterr().out.splitlines()
                  if line.startswith("k=")]
    for row, k in zip(got, ks):
        W, _ = build_knn_graph(z, k=k, sym="union")
        stats = analyze_graph_connectivity(W)
        D = multi_source_distances(W, np.arange(8))
        finite = D[np.isfinite(D)]
        assert row["n_components"] == stats["n_components"]
        assert row["connectivity_ratio"] == stats["connectivity_ratio"]
        np.testing.assert_allclose(row["mean_geodesic"], finite.mean(),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.sort(row["distances"]),
                                   np.sort(finite), rtol=1e-6)
    assert got[0]["n_components"] > 1  # k = 1 leaves the graph in pieces
    mod = _jax_script("visualizations/knn_experiments.py")
    monkeypatch.setattr(sys, "argv", [
        mod.__file__, "--n", "400", "--ks", *map(str, ks), "--out",
        str(tmp_path / "jax.png")])
    mod.main()
    jax_lines = [line for line in capsys.readouterr().out.splitlines()
                 if line.startswith("k=")]
    assert port_lines == jax_lines
    knn_experiments.main(["--n", "400", "--ks", "5", "10", "--out",
                          str(tmp_path / "port.png"), "--device", "cpu"])
    assert (tmp_path / "port.png").stat().st_size > 0


def test_interactive_explorer_matches_jax(tmp_path, jax_paths):
    mod = _jax_script("visualizations/interactive_knn_viz.py")
    res = interactive_knn_viz.run(n=300, k=6, device="cpu")
    ref = mod.Explorer(res["z"], 6)
    np.testing.assert_allclose(res["distances"], ref.distances_from(0),
                               rtol=1e-6)
    explorer = res["explorer"]
    explorer.set_k(3)
    ref.set_k(3)
    np.testing.assert_allclose(explorer.distances_from(17),
                               ref.distances_from(17), rtol=1e-6)
    explorer.set_k(6)  # served from the per-k cache
    assert sorted(explorer._cache) == [3, 6]
    np.testing.assert_allclose(explorer.distances_from(0),
                               res["distances"], rtol=0)


def test_interactive_main_saves_the_static_panel(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    out = tmp_path / "panel.png"
    interactive_knn_viz.main(["--n", "200", "--k", "6", "--out", str(out),
                              "--device", "cpu"])
    assert out.stat().st_size > 0


def test_legacy_config_matches_jax(tmp_path, jax_paths, monkeypatch):
    import vqvae_tpu.cli as jax_cli

    seen = {}

    def capture(cfg, topology=None):
        seen["cfg"], seen["topology"] = cfg.to_dict(), topology

    monkeypatch.setattr(jax_cli, "train_vae_main", capture)
    monkeypatch.setattr(sys, "argv", [
        "train_legacy_vae.py", "--epochs", "3", "--lr", "1e-3",
        "--synthetic-size", "64", "--out-dir", str(tmp_path / "jax")])
    runpy.run_path(str(REPO / "scripts" / "train_legacy_vae.py"),
                   run_name="__main__")
    cfg = train_legacy_vae.compose_config(
        REPO / "configs" / "vae.yaml", REPO / "configs" / "data.yaml",
        str(tmp_path / "jax"), 3, 1e-3, 64)
    assert cfg._data == seen["cfg"]
    assert seen["topology"] == cfg["model"]["topology"] == "flat"
    assert cfg["data"]["augment"] is True


def test_legacy_trainer_runs_one_epoch(tmp_path, monkeypatch):
    from vqvae_tpu_torch.train import VAEEngine

    paths = []
    orig = VAEEngine.run_epoch

    def spy(self, *args, **kwargs):  # the per-batch (augmented) path
        paths.append("per_batch")
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(VAEEngine, "run_epoch", spy)
    out = train_legacy_vae.main([
        "--epochs", "1", "--synthetic-size", "64", "--out-dir",
        str(tmp_path / "legacy"), "--device", "cpu"])
    assert out == tmp_path / "legacy"
    assert (out / "checkpoints" / "best.pt").exists()
    assert (out / "latents_train" / "latents.npz").exists()
    assert paths
