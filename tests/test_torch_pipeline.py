"""The port's pipeline orchestrator (``cli/pipeline.py``) on the CPU.

- ``run_pipeline`` on ``configs/sandbox-fashion/geodesic`` with
  ``device="cpu"`` in a fresh root: all six stages (the VAE on 256
  synthetic images for one epoch, the transformer for one epoch), every
  stage's artifacts, the timings and their JSON file;
- the CLI's ``--skip-*`` flags (and the reference's ``--skip-generation``
  / ``--skip-evaluation`` names) on the same artifacts;
- a non-critical stage's failure is printed and passed over, a critical
  stage's is raised; a config naming a legacy codebook builder, or a
  reference-style config implying one, is dispatched to
  ``build_codebook_legacy_main`` (the riemannian flag as named);
- a vanilla preset (``configs/sandbox-fashion/euclidean``, the flat VAE)
  through all six stages with the ``legacy_riemannian`` builder: flat
  codes (N,) with -1 only off the LCC, both graph files, the transformer
  on two-token sequences, the sample grid and finite PSNR / SSIM.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu_torch.cli import pipeline
from vqvae_tpu_torch.cli.pipeline import STAGES, run_pipeline
from vqvae_tpu_torch.utils.images import load_image

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "configs" / "sandbox-fashion" / "geodesic"
EXP = Path("experiments") / "sandbox-fashion" / "geodesic"
OVERRIDES = {"vae": {"max_epochs": 1, "data": {"synthetic_size": 256}},
             "transformer": {"training": {"epochs": 1}}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipeline_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("root")
    timings_path = root / "timings.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQVAE_TPU_TIMINGS_PATH", str(timings_path))
        mp.setenv("VQVAE_TPU_SYNTH_SIZE", "256")
        mp.delenv("LPIPS_WEIGHTS", raising=False)
        timings = run_pipeline(PRESET, overrides=OVERRIDES, root_dir=root,
                               device="cpu")
    return root, timings, json.loads(timings_path.read_text())


def test_all_six_stages_write_their_artifacts(pipeline_root):
    root, timings, written = pipeline_root
    assert list(timings) == list(STAGES) + ["total"]
    compiled = {k: written.pop(k) for k in ("programs_compiled",
                                            "compile_seconds")}
    assert written == pytest.approx(timings)
    assert compiled["programs_compiled"] >= 0
    assert compiled["compile_seconds"] >= 0.0
    assert all(t > 0 for t in timings.values())
    exp = root / EXP
    run = exp / "vae" / "spatial_vae_fashionmnist"
    for path in (run / "checkpoints" / "best.pt",
                 run / "checkpoints" / "latest.pt",
                 run / "latents_train" / "latents.npz",
                 run / "vae_quality_assessment.json",
                 exp / "codebook" / "codebook.npz",
                 exp / "codebook" / "knn_graph_geodesic.npz",
                 exp / "evaluation" / "quantization_analysis.json",
                 exp / "evaluation" / "codebook_health.json",
                 exp / "transformer" / "checkpoints" / "best.pt",
                 exp / "transformer" / "checkpoints" / "latest.pt",
                 exp / "transformer" / "labels_cache.npy",
                 exp / "evaluation" / "comparison_grid.png"):
        assert path.exists(), path
    codes = np.load(exp / "codebook" / "codes.npy")
    assert codes.shape == (256, 4, 4)
    rows = [json.loads(line) for line in (exp / "transformer"
                                          / "metrics.jsonl").read_text()
            .splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    grid = load_image(exp / "evaluation" / "generated_samples.png")
    assert grid.shape == (10 * 30 + 2, 4 * 30 + 2, 1)
    metrics = yaml.safe_load((exp / "evaluation" / "metrics.yaml")
                             .read_text())
    assert np.isfinite(metrics["PSNR_full"])
    assert np.isfinite(metrics["SSIM_full"])
    assert metrics["LPIPS"] is None and metrics["LPIPS_full"] is None


def test_skip_flags(pipeline_root, monkeypatch):
    root, _, _ = pipeline_root
    monkeypatch.chdir(root)
    monkeypatch.delenv("VQVAE_TPU_TIMINGS_PATH", raising=False)
    metrics = root / EXP / "evaluation" / "metrics.yaml"
    metrics.unlink()
    timings = pipeline.main(["--preset", str(PRESET), "--device", "cpu",
                             "--skip-vae", "--skip-codebook",
                             "--skip-quality", "--skip-transformer",
                             "--skip-generation", "--timings-out",
                             "t.json"])
    assert list(timings) == ["evaluate", "total"]
    assert json.loads((root / "t.json").read_text()) == pytest.approx(
        timings)
    assert metrics.exists()
    timings = pipeline.main(["--preset", str(PRESET), "--device", "cpu",
                             *(f"--skip-{s}" for s in STAGES)])
    assert list(timings) == ["total"]
    timings = pipeline.main(["--preset", str(PRESET), "--device", "cpu",
                             "--skip-vae", "--skip-codebook",
                             "--skip-quality", "--skip-transformer",
                             "--skip-generate", "--skip-evaluation"])
    assert list(timings) == ["total"]


def test_non_critical_failure_continues_and_critical_raises(tmp_path,
                                                            capsys):
    # nothing upstream exists: evaluate (non-critical) fails and the run
    # goes on; the transformer stage (critical) raises
    only = list(STAGES[:-1])
    timings = run_pipeline(PRESET, skip=only, root_dir=tmp_path,
                           device="cpu")
    assert list(timings) == ["evaluate", "total"]
    assert "non-critical stage evaluate failed" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        run_pipeline(PRESET, skip=set(STAGES) - {"transformer"},
                     root_dir=tmp_path, device="cpu")


class _Dispatched(Exception):
    pass


@pytest.mark.parametrize("codebook,builder", [
    ({"builder": "legacy"}, "legacy"),
    ({"builder": None, "riemannian": {"k": 5}}, "legacy_riemannian"),
    ({"builder": None, "model": {"K": 8}}, "legacy"),
])
def test_legacy_codebook_builders_raise(tmp_path, codebook, builder,
                                        monkeypatch):
    # the legacy builder is reached (and stops the run with a sentinel)
    from vqvae_tpu_torch import cli

    calls = []

    def fake(cfg, riemannian=False, device=None):
        calls.append((riemannian, device))
        raise _Dispatched

    monkeypatch.setattr(cli, "build_codebook_legacy_main", fake)
    monkeypatch.setattr(cli, "build_codebook_main", None)  # not reached
    with pytest.raises(_Dispatched):
        run_pipeline(PRESET, skip={"vae"}, overrides={"codebook": codebook},
                     root_dir=tmp_path, device="cpu")
    assert calls == [(builder == "legacy_riemannian", torch.device("cpu"))]
    cfg = pipeline._stage_config(PRESET, "codebook",
                                 {"codebook": codebook})
    assert pipeline.codebook_builder(cfg) == builder


VANILLA = REPO / "configs" / "sandbox-fashion" / "euclidean"
VANILLA_EXP = Path("experiments") / "sandbox-fashion" / "euclidean"


def test_vanilla_preset_runs_all_six_stages(tmp_path, monkeypatch):
    monkeypatch.setenv("VQVAE_TPU_SYNTH_SIZE", "256")
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    overrides = {
        "vae": {"max_epochs": 1, "data": {"synthetic_size": 256}},
        "codebook": {"builder": "legacy_riemannian",
                     "riemannian": {"mode": "subset", "max_edges": 200,
                                    "batch_size": 128}},
        "quality": {"synthetic_size": 64},
        "transformer": {"training": {"epochs": 1}},
        "evaluate": {"data": {"synthetic_size": 64}}}
    timings = run_pipeline(VANILLA, overrides=overrides, root_dir=tmp_path,
                           device="cpu")
    assert list(timings) == list(STAGES) + ["total"]
    exp = tmp_path / VANILLA_EXP
    for path in (exp / "vae" / "checkpoints" / "best.pt",
                 exp / "codebook" / "knn_graph.npz",
                 exp / "codebook" / "knn_graph_riemannian.npz",
                 exp / "codebook" / "codebook.npz",
                 exp / "evaluation" / "quantization_analysis.json",
                 exp / "evaluation" / "codebook_health.json",
                 exp / "transformer" / "checkpoints" / "best.pt",
                 exp / "evaluation" / "metrics.yaml"):
        assert path.exists(), path
    codes = np.load(exp / "codebook" / "codes.npy")
    rec = json.loads(bytes(np.load(exp / "codebook" / "codebook.npz")
                           ["config_json"]))
    assert codes.shape == (256,) and codes.max() < 128
    assert int((codes >= 0).sum()) == rec["lcc_nodes"]
    assert rec["riemannian"] is True and np.isfinite(
        rec["quantization_error"])
    rows = [json.loads(line) for line in (exp / "transformer"
                                          / "metrics.jsonl").read_text()
            .splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    grid = load_image(exp / "evaluation" / "generated_samples.png")
    assert grid.shape == (10 * 30 + 2, 4 * 30 + 2, 1)
    metrics = yaml.safe_load((exp / "evaluation" / "metrics.yaml")
                             .read_text())
    assert np.isfinite(metrics["PSNR_full"])
    assert np.isfinite(metrics["SSIM_full"])


def test_missing_preset_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="preset directory"):
        run_pipeline(tmp_path / "nope", device="cpu")
    with pytest.raises(FileNotFoundError, match="no stage configs"):
        run_pipeline(tmp_path, device="cpu")
