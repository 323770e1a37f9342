"""The EMA VQ-VAE baseline on the card against the CPU, and kernel K3 at
the vanilla presets' flat width D = 128.

Every test needs a CUDA device (the ``cuda`` marker) and skips without
one. The file imports no JAX, so it runs on a GPU host without it:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_vqvae_baseline_cuda.py``.

- one train step of a narrow baseline (z 32, hidden 64, 64 codes, a
  batch of 16 whose last 4 rows are padding) from the same weights,
  codebook, batch and bank draw, full f32: the loss within rtol 1e-5,
  each gradient within 1e-3 of its tensor's norm, ``quantize``'s indices
  equal except at near-ties (the two codes' exact distances within 1e-5
  relative), each code of the EMA codebook within 1e-5 of its norm on
  the codes no near-tie row moved (a code's sum adds its members'
  latents, whose elements cancel: one element's relative error can be
  large where the sum is near 0);
- the baseline's train -> evaluate -> metrics entry points on the card at
  a tiny size: finite losses and the evaluation files;
- K3 at D = 128 against 512 codes, at the vanilla quality stage's row
  counts (1,000 and 10,000): indices equal except at near-ties, distances
  within rtol 1e-5.
"""
import copy
import json

import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu_torch.cli import (eval_codebook_metrics_main,
                                 run_baseline_pipeline)
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.vae import flax_init_
from vqvae_tpu_torch.models.vqvae_baseline import (VQVAE, CodebookState,
                                                   quantize)
from vqvae_tpu_torch.ops.assign import nearest_codes, nearest_codes_reference
from vqvae_tpu_torch.train import VQVAEEngine

N_CODES = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (card vs CPU)")
    return resolve_device("cuda")  # full f32


def _near_tie_rows(z, cb, idx, ref_idx):
    """Rows where two assignments differ; each must be a near-tie."""
    differ = torch.nonzero(idx != ref_idx).flatten()
    if differ.numel():
        zd = z[differ].double()
        a = ((zd - cb[idx[differ]].double()) ** 2).sum(1)
        b = ((zd - cb[ref_idx[differ]].double()) ** 2).sum(1)
        assert ((a - b).abs() <= 1e-5 * torch.minimum(a, b)).all()
    return differ


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    model = flax_init_(VQVAE(3, 32, 64, 2), torch.Generator().manual_seed(0))
    cb0 = CodebookState.create(torch.Generator().manual_seed(1), N_CODES, 32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (16, 32, 32, 3)).astype(
        np.float32))
    mask = torch.ones(16)
    x[-4:], mask[-4:] = 0.0, 0.0

    def step(dev):
        eng = VQVAEEngine(copy.deepcopy(model), n_codes=N_CODES, lr=2e-4,
                          grad_clip=1.0, bank_size=64, device=dev)
        grads, run_opt = {}, eng.opt.step

        def snapshot_then_step():
            grads.update({k: p.grad.detach().cpu().clone()
                          for k, p in eng.model.named_parameters()})
            run_opt()

        eng.opt.step = snapshot_then_step
        with torch.no_grad():
            z_e = eng.model.encode(x.to(dev))
            _, idx = quantize(cb0.to(dev), z_e)
        cb, _, m = eng.train_step(cb0.to(dev), torch.zeros(64, 32,
                                                           device=dev),
                                  x.to(dev), mask.to(dev),
                                  torch.Generator().manual_seed(2))
        return float(m["loss"]), grads, cb.to("cpu"), idx.cpu(), z_e.cpu()

    loss_g, grad_g, cb_g, idx_g, _ = step(cuda_device)
    loss_c, grad_c, cb_c, idx_c, z_c = step("cpu")
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for key, g_c in grad_c.items():
        assert float((grad_g[key] - g_c).norm()) <= 1e-3 * float(
            g_c.norm()), key
    flat_g, flat_c = idx_g.reshape(-1), idx_c.reshape(-1)
    differ = _near_tie_rows(z_c.reshape(-1, 32), cb0.embed, flat_g, flat_c)
    keep = torch.ones(N_CODES, dtype=torch.bool)
    keep[flat_g[differ]] = False
    keep[flat_c[differ]] = False
    for key in ("embed", "cluster_size", "embed_avg"):
        a, b = getattr(cb_g, key)[keep], getattr(cb_c, key)[keep]
        if a.ndim == 1:
            a, b = a[:, None], b[:, None]
        assert ((a - b).norm(dim=1) <= 1e-5 * b.norm(dim=1)).all(), key


@pytest.mark.cuda
def test_baseline_entry_points_on_card(cuda_device, tmp_path):
    cfg = {"seed": 0, "out_dir": str(tmp_path / "baseline"),
           "data": {"root": str(tmp_path / "no-data"), "name": "CIFAR10",
                    "img_size": 32, "synthetic_size": 200},
           "train": {"batch_size": 64, "epochs": 2, "lr": 2e-4,
                     "weight_decay": 0.0, "grad_clip": 1.0},
           "model": {"in_channels": 3, "z_channels": 32, "hidden": 64,
                     "n_res_blocks": 2, "n_codes": N_CODES, "beta": 0.25,
                     "ema_decay": 0.99, "ema_eps": 1e-5},
           "log": {"samples_every": 1}}
    path = tmp_path / "baseline.yaml"
    path.write_text(yaml.safe_dump(cfg))
    timings = run_baseline_pipeline(path, device="cuda")
    assert list(timings) == ["train", "evaluate", "total"]
    metrics = eval_codebook_metrics_main(load_config(path), device="cuda")
    base = tmp_path / "baseline"
    rows = [json.loads(line) for line in
            (base / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(np.isfinite(r["train_loss"])
                                  for r in rows)
    results = json.loads((base / "evaluation" / "evaluation_results.json")
                         .read_text())
    assert np.isfinite(results["recon_psnr"])
    assert metrics["perplex"] >= 1.0
    assert (base / "codebook_eval_test.csv").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000, 10_000])
def test_k3_at_flat_width_128(cuda_device, n):
    rng = np.random.default_rng(n)
    z = torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32)).to(
        cuda_device)
    cb = torch.from_numpy(rng.normal(size=(512, 128)).astype(
        np.float32)).to(cuda_device)
    before = nearest_codes.launches
    idx, dist = nearest_codes(z, cb)
    assert nearest_codes.launches == before + 1
    ref_idx, ref_dist = nearest_codes_reference(z, cb)
    torch.cuda.synchronize()
    differ = _near_tie_rows(z, cb, idx, ref_idx)
    assert differ.numel() <= 1e-4 * n + 1
    same = idx == ref_idx
    torch.testing.assert_close(dist[same], ref_dist[same], rtol=1e-5,
                               atol=1e-5)
