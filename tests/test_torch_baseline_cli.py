"""The EMA VQ-VAE baseline's entry points on the CPU
(``cli/train_baseline_vqvae.py``, ``cli/evaluate_baseline.py``,
``cli/eval_codebook_metrics.py`` and ``run_baseline_pipeline``).

- 2 tiny epochs of training on the synthetic CIFAR-10 split (120 / 32
  images, batch 32, so the padded set has 8 zero rows), then the
  evaluator and the metrics CSV: the checkpoints, the per-epoch recon
  grids (read back by the port's PNG reader), the logged rows with the
  JAX engine's keys, and the three evaluation files and the CSV with the
  JAX scripts' keys and header;
- the evaluator and the metrics CSV against the JAX scripts
  (``scripts/evaluate_baseline_simple.py``,
  ``scripts/eval_codebook_metrics.py``, run in process) on the same
  weights and codebook, carried across from a JAX-initialized model:
  PSNR and SSIM within 2e-4 (both round to 4 decimals), identical
  codebook statistics and perplexity; the CSV's metrics within rtol 1e-4;
- every entry point raises without CUDA when no device is given.
"""
import csv
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu.models import VQVAE as JaxVQVAE
from vqvae_tpu.models.vqvae_baseline import CodebookState as JaxCodebook
from vqvae_tpu.utils.checkpoint import Checkpointer
from vqvae_tpu_torch.cli import (eval_codebook_metrics_main,
                                 evaluate_baseline_main, pipeline,
                                 run_baseline_pipeline, train_baseline_main)
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.models.vqvae_baseline import VQVAE
from vqvae_tpu_torch.utils.checkpoint import (codebook_state_from_jax,
                                              save_baseline_checkpoint,
                                              vqvae_state_dict_from_jax)
from vqvae_tpu_torch.utils.images import load_image

REPO = Path(__file__).resolve().parents[1]
MODEL = {"in_channels": 3, "z_channels": 16, "hidden": 32,
         "n_res_blocks": 1, "n_codes": 32, "beta": 0.25,
         "ema_decay": 0.99, "ema_eps": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, out="baseline"):
    cfg = {"seed": 0, "out_dir": str(tmp_path / out),
           "data": {"root": str(tmp_path / "no-data"), "name": "CIFAR10",
                    "img_size": 32, "synthetic_size": 120},
           "train": {"batch_size": 32, "epochs": 2, "lr": 2e-4,
                     "weight_decay": 0.0, "grad_clip": 1.0},
           "model": MODEL, "log": {"samples_every": 1, "save_best": True}}
    path = tmp_path / f"{out}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_evaluate_and_metrics_write_the_jax_files(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    path = _config(tmp_path)
    timings = run_baseline_pipeline(path, device="cpu")
    assert list(timings) == ["train", "evaluate", "total"]
    base = tmp_path / "baseline"
    for name in ("checkpoints/best.pt", "checkpoints/latest.pt",
                 "metrics.csv", "metrics.jsonl"):
        assert (base / name).exists(), name
    for ep in (1, 2):
        grid = load_image(base / f"recon_epoch{ep:04d}.png")
        assert grid.shape == (4 * 34 + 2, 8 * 34 + 2, 3)
    rows = [json.loads(line) for line in
            (base / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2
    keys = ("loss", "rec", "vq", "q_mse", "perplex", "usage", "dead")
    for row in rows:
        for k in [f"{s}_{m}" for s in ("train", "val") for m in keys] + [
                "embed_norm_mean", "embed_norm_min", "embed_norm_max",
                "reseeded"]:
            assert k in row and np.isfinite(row[k]), k
        assert row["train_steps"] == 4 and row["val_perplex"] >= 1.0
    assert rows[1]["train_loss"] < rows[0]["train_loss"]
    ckpt = torch.load(base / "checkpoints" / "latest.pt",
                      weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "codebook", "epoch"}
    assert ckpt["epoch"] == 2 and ckpt["optimizer"]["count"] == 8

    ev = base / "evaluation"
    results = json.loads((ev / "evaluation_results.json").read_text())
    assert set(results) == {"recon_psnr", "recon_ssim", "lpips", "entropy",
                            "used_codes", "dead_codes", "perplexity",
                            "codebook_size", "samples_evaluated"}
    assert results["lpips"] is None and results["codebook_size"] == 32
    assert results["samples_evaluated"] == 32
    assert np.isfinite(results["recon_psnr"])
    assert set(yaml.safe_load((ev / "metrics.yaml").read_text())) == {
        "PSNR", "SSIM", "LPIPS"}
    health = json.loads((ev / "codebook_health.json").read_text())
    assert set(health) == {"entropy", "used_codes", "dead_codes",
                           "usage_percent", "health_assessment"}
    assert load_image(ev / "generated_samples.png").shape == (
        8 * 34 + 2, 8 * 34 + 2, 3)

    metrics = eval_codebook_metrics_main(load_config(path), split="test",
                                         device="cpu")
    eval_codebook_metrics_main(load_config(path), split="test",
                               device="cpu")
    with open(base / "codebook_eval_test.csv") as f:
        table = list(csv.reader(f))
    assert table[0] == ["split", "loss", "rec", "vq", "q_mse", "perplex",
                        "usage", "dead", "embed_norm_mean",
                        "embed_norm_min", "embed_norm_max"]
    assert len(table) == 3 and table[1] == table[2]
    assert float(table[1][1]) == pytest.approx(metrics["loss"])

    # skip-train evaluates the existing checkpoint; the CLI flag too
    timings = pipeline.main(["--baseline", str(path), "--skip-train",
                             "--device", "cpu"])
    assert list(timings) == ["evaluate", "total"]


def _jax_script(name, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluators_match_the_jax_scripts(tmp_path, monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    path = _config(tmp_path, "carried")
    cfg = load_config(path)
    jmodel = JaxVQVAE(**{k: MODEL[k] for k in ("in_channels", "z_channels",
                                              "hidden", "n_res_blocks")})
    params = jax.device_get(jax.jit(jmodel.init)(
        {"params": jax.random.key(3)},
        np.zeros((1, 32, 32, 3), np.float32))["params"])
    rng = np.random.default_rng(0)
    embed = rng.normal(0, 0.3, (32, 16)).astype(np.float32)
    jcb = JaxCodebook(embed, rng.uniform(0, 9, 32).astype(np.float32),
                      embed.copy())
    jax_ckpt = tmp_path / "jax_ckpt"
    Checkpointer(jax_ckpt).save("best", {"params": params,
                                         "codebook": jcb._asdict(),
                                         "epoch": 1})
    port = VQVAE(**{k: MODEL[k] for k in ("in_channels", "z_channels",
                                          "hidden", "n_res_blocks")})
    port.load_state_dict(vqvae_state_dict_from_jax(params))
    save_baseline_checkpoint(tmp_path / "carried" / "checkpoints" / "best.pt",
                             port, None, codebook_state_from_jax(jcb), 1)

    got = evaluate_baseline_main(cfg, max_samples=20, device="cpu")
    ev = _jax_script("evaluate_baseline_simple", monkeypatch, tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "evaluate_baseline_simple.py", "--config", str(path), "--ckpt_dir",
        str(jax_ckpt), "--out_dir", str(tmp_path / "jax"),
        "--max_samples", "20"])
    ev.main()
    want = json.loads((tmp_path / "jax" / "evaluation" /
                       "evaluation_results.json").read_text())
    assert set(got) == set(want)
    for key in ("recon_psnr", "recon_ssim"):
        assert abs(got[key] - want[key]) <= 2e-4, key
    for key in ("lpips", "entropy", "used_codes", "dead_codes",
                "perplexity", "codebook_size", "samples_evaluated"):
        assert got[key] == want[key], key
    assert got["samples_evaluated"] == 20 and got["used_codes"] > 1
    for name in ("codebook_health.json",):
        a = json.loads((tmp_path / "carried" / "evaluation" / name)
                       .read_text())
        b = json.loads((tmp_path / "jax" / "evaluation" / name).read_text())
        assert a == pytest.approx(b)

    got = eval_codebook_metrics_main(cfg, split="test", device="cpu")
    mod = _jax_script("eval_codebook_metrics", monkeypatch, tmp_path)
    jax_cfg = dict(yaml.safe_load(path.read_text()),
                   out_dir=str(tmp_path / "jax"))
    jax_path = tmp_path / "jax.yaml"
    jax_path.write_text(yaml.safe_dump(jax_cfg))
    monkeypatch.setattr(sys, "argv", [
        "eval_codebook_metrics.py", "--config", str(jax_path), "--ckpt",
        str(jax_ckpt), "--split", "test"])
    mod.main()
    with open(tmp_path / "jax" / "codebook_eval_test.csv") as f:
        want_rows = list(csv.reader(f))
    with open(tmp_path / "carried" / "codebook_eval_test.csv") as f:
        got_rows = list(csv.reader(f))
    assert got_rows[0] == want_rows[0]
    np.testing.assert_allclose([float(v) for v in got_rows[1][1:]],
                               [float(v) for v in want_rows[1][1:]],
                               rtol=1e-4, atol=1e-6)
    assert got["perplex"] > 1.0


def test_entry_points_need_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    path = _config(tmp_path)
    cfg = load_config(path)
    for call in (lambda: train_baseline_main(cfg),
                 lambda: evaluate_baseline_main(cfg),
                 lambda: eval_codebook_metrics_main(cfg),
                 lambda: run_baseline_pipeline(path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
