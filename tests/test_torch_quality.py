"""Port parity for the quality stage, and the slice vae -> codebook ->
quality as a whole.

The three evaluators run on one tiny experiment directory: the JAX side
reads the VAE from an orbax ``best`` (through
``vqvae_tpu.utils.checkpoint.Checkpointer``, here in the test only), the
port from ``best.pt`` with the same weights. PSNRs agree within 1e-3 dB,
SSIMs within 1e-5; ratings, codes, entropy, used and dead codes are
identical. The JAX loader also reads a ``best.pt`` that the port wrote and
decodes identically (within float order), so the artifacts stay
interchangeable. The chained test trains a tiny VAE with the port, builds
its codebook through the preset's ``.../checkpoints/best`` path, and holds
the port's quality stage against JAX's on those artifacts.
"""
import json
from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from vqvae_tpu.cli import quality_checks as jq
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.utils.checkpoint import Checkpointer
from vqvae_tpu.utils.checkpoint import \
    load_vae_from_checkpoint as jax_load_vae
from vqvae_tpu.utils.torch_compat import (export_reference_vae_checkpoint,
                                          load_reference_vae_checkpoint)
from vqvae_tpu_torch.cli import quality_checks as pq
from vqvae_tpu_torch.cli.build_codebook import build_codebook_main
from vqvae_tpu_torch.cli.train_vae import train_vae_main
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.ops.assign import nearest_codes
from vqvae_tpu_torch.utils.checkpoint import (cpu_state_dict,
                                              load_vae_from_checkpoint,
                                              save_checkpoint)
from vqvae_tpu_torch.utils.latents import save_latents

REPO = Path(__file__).resolve().parents[1]
ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 4
N_VAL, K = 60, 24


def _variables(seed=3):
    model = JaxVAE(in_channels=1, enc_channels=ENC, dec_channels=DEC,
                   latent_dim=LATENT, recon_loss="mse", output_image_size=28,
                   norm_type="batch", topology="spatial")
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        model.init({"params": jax.random.key(seed)},
                   np.zeros((1, 28, 28, 1), np.float32))))
    rng = np.random.RandomState(seed)
    for side in variables["batch_stats"].values():
        for st in side.values():
            st["mean"] = rng.uniform(-0.3, 0.3, st["mean"].shape).astype(
                np.float32)
            st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(
                np.float32)
    return variables


def _write_orbax_best(ckpt_dir: Path, variables) -> None:
    ckptr = Checkpointer(ckpt_dir)
    ckptr.save("best", {"params": variables["params"],
                        "batch_stats": variables["batch_stats"],
                        "step": 0, "epoch": 1})
    ckptr.close()


def _experiment(tmp_path: Path) -> Path:
    exp = tmp_path / "exp"
    vae_dir = exp / "vae" / "spatial_vae_fashionmnist"
    variables = _variables()
    _write_orbax_best(vae_dir / "checkpoints", variables)
    export_reference_vae_checkpoint(variables,
                                    vae_dir / "checkpoints" / "best.pt",
                                    "spatial", ENC, DEC, "batch")
    rng = np.random.default_rng(0)
    mu = rng.normal(0, 1, (N_VAL, 4, 4, LATENT)).astype(np.float32)
    logvar = rng.normal(-2, 0.3, mu.shape).astype(np.float32)
    z = (mu + np.exp(0.5 * logvar) * rng.normal(size=mu.shape)).astype(
        np.float32)
    save_latents(vae_dir / "latents_val", z, mu, logvar,
                 np.zeros(N_VAL, np.int32))
    (exp / "codebook").mkdir(parents=True)
    np.savez_compressed(
        exp / "codebook" / "codebook.npz",
        medoid_indices=np.arange(K, dtype=np.int32),
        z_medoid=rng.normal(0, 1, (K, LATENT)).astype(np.float32),
        config_json=np.bytes_(b"{}"))
    return exp


def _outputs(exp: Path) -> dict:
    files = list(exp.glob("vae/*/vae_quality_assessment.json")) + [
        exp / "evaluation" / "quantization_analysis.json",
        exp / "evaluation" / "codebook_health.json"]
    return {f.name: json.loads(f.read_text()) for f in files}


def _run_both(exp: Path, synthetic_size: int):
    rc_j = jq.evaluate_vae_quality_main(exp, max_samples=40)
    jq.evaluate_quantization_loss_main(exp, max_samples=40,
                                       synthetic_size=synthetic_size)
    jq.evaluate_codebook_health_main(exp)
    ref = _outputs(exp)
    rc_p = pq.evaluate_vae_quality_main(exp, max_samples=40, device="cpu")
    pq.evaluate_quantization_loss_main(exp, max_samples=40,
                                       synthetic_size=synthetic_size,
                                       device="cpu")
    pq.evaluate_codebook_health_main(exp, device="cpu")
    return rc_j, rc_p, ref, _outputs(exp)


def _assert_same(ref: dict, got: dict) -> None:
    assert set(got) == set(ref) and len(ref) == 3
    for name, want in ref.items():
        have = got[name]
        assert set(have) == set(want), name
        for key, val in want.items():
            if key.startswith("psnr"):
                assert abs(have[key] - val) <= 1e-3, (name, key)
            elif key.startswith("ssim") or key == "mu_variance_max":
                assert abs(have[key] - val) <= 1e-5, (name, key)
            else:  # ratings, counts, entropy, usage
                assert have[key] == val, (name, key, have[key], val)


def test_evaluators_match_jax(tmp_path):
    exp = _experiment(tmp_path)
    rc_j, rc_p, ref, got = _run_both(exp, synthetic_size=50)
    assert rc_p == rc_j
    _assert_same(ref, got)
    # the codes behind entropy/used/dead: identical
    z = np.load(exp / "vae" / "spatial_vae_fashionmnist" / "latents_val" /
                "latents.npz")["z"].reshape(-1, LATENT)
    cb = np.load(exp / "codebook" / "codebook.npz")["z_medoid"]
    np.testing.assert_array_equal(pq.nearest_medoid_assign(z, cb, "cpu"),
                                  jq.nearest_medoid_assign(z, cb))


def test_jax_loader_reads_the_ports_best_pt(tmp_path):
    variables = _variables(seed=5)
    src = export_reference_vae_checkpoint(variables, tmp_path / "x.pt",
                                          "spatial", ENC, DEC, "batch")
    cfg = {"in_channels": 1, "enc_channels": ENC, "dec_channels": DEC,
           "latent_dim": LATENT, "norm_type": "batch", "topology": "spatial",
           "output_image_size": 28}
    port = load_vae_from_checkpoint(src, cfg, device="cpu")
    save_checkpoint(tmp_path / "ckpt" / "best.pt",
                    {"model_state_dict": cpu_state_dict(port), "epoch": 2})
    model, jvars = jax_load_vae(tmp_path / "ckpt", "best.pt", config=cfg)
    z = np.random.default_rng(1).normal(size=(7, 4, 4, LATENT)).astype(
        np.float32)
    ref = np.asarray(model.apply(jvars, z, method=model.decode))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # and the port reads it back through the JAX package's name for it
    again = load_vae_from_checkpoint(tmp_path / "ckpt" / "best", None,
                                     device="cpu")
    for key, val in port.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], val, rtol=0,
                                   atol=0)


def test_slice_chains_vae_codebook_quality(tmp_path):
    exp = tmp_path / "experiments" / "geo"
    vae_cfg = {
        "seed": 42, "max_epochs": 1, "lr": 1e-3, "weight_decay": 1e-5,
        "optimizer": "adamw", "scheduler": {"name": "cosine", "t_max": 1},
        "grad_clip_max_norm": 1.0, "out_dir": str(exp / "vae"),
        "data": {"root": str(tmp_path / "no-data"), "name": "FashionMNIST",
                 "batch_size": 32, "augment": False, "synthetic_size": 192},
        "model": {"in_channels": 1, "output_image_size": 28,
                  "latent_dim": LATENT, "enc_channels": list(ENC),
                  "dec_channels": list(DEC), "recon_loss": "mse",
                  "beta": 1.0, "norm_type": "batch", "mse_use_sigmoid": True,
                  "topology": "spatial"},
    }
    (tmp_path / "vae.yaml").write_text(yaml.safe_dump(vae_cfg))
    run = train_vae_main(load_config(tmp_path / "vae.yaml"), device="cpu")
    # the codebook preset's layout, unchanged: checkpoints/best, no .pt
    preset = yaml.safe_load((
        REPO / "configs/fashionmnist/spatial/geodesic/codebook.yaml"
    ).read_text())
    assert preset["vae_ckpt_path"].endswith("/checkpoints/best")
    preset.update(latents_path=str(run / "latents_train"),
                  vae_ckpt_path=str(run / "checkpoints" / "best"),
                  out_dir=str(exp / "codebook"))
    preset["vae"].update(latent_dim=LATENT, enc_channels=list(ENC),
                         dec_channels=list(DEC))
    preset["graph"]["k"] = 10
    preset["quantize"]["K"] = K
    (tmp_path / "codebook.yaml").write_text(yaml.safe_dump(preset))
    build_codebook_main(load_config(tmp_path / "codebook.yaml"),
                        device="cpu")
    assert (exp / "codebook" / "codes.npy").exists()

    # JAX reads its VAE from orbax: write one from the port's best.pt
    variables = load_reference_vae_checkpoint(
        run / "checkpoints" / "best.pt", "spatial", ENC, DEC, "batch")
    _write_orbax_best(run / "checkpoints", variables)
    rc_j, rc_p, ref, got = _run_both(exp, synthetic_size=32)
    assert rc_p == rc_j
    _assert_same(ref, got)
    assert nearest_codes.launches == 0  # no card here


def test_module_entry_point_runs_the_three_evaluators(tmp_path):
    exp = _experiment(tmp_path)
    rc = pq.main(["--experiment", str(exp), "--device", "cpu"])
    assert rc in (0, 1)
    assert len(_outputs(exp)) == 3
