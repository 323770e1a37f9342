"""Port parity on the CIFAR-10 presets' path: 3 channels at 32 px, D = 32.

Narrow widths (encoder 8/16/32, decoder 32/16/8), the presets' latent
width 32, JAX-initialized weights carried across
(``vae_state_dict_from_jax`` / ``export_reference_vae_checkpoint``).

- one epoch of the device-resident path (3 steps of 8 images, padding
  rows in the middle batch) with ``spatial_free_bits`` 0.1 (some cells
  clamped at the floor, some above it), the noise taken out on both
  sides: the epoch's mean (loss, recon, kl) within rtol 1e-5 and the
  parameters within ``tests/test_torch_vae_epoch.py``'s limits
  (rtol 1e-4 or 2e-5 of the tensor's largest value, at most 0.1 % of a
  tensor past it and all within 2 * steps * lr; the conv biases that
  feed a BatchNorm within the learning-rate bound only);
- the mlp, edgewise and nodal Riemannian lengths against JAX's engines
  within rtol 1e-4 (``tests/test_torch_riemannian.py``'s tolerance); the
  linearized decoder's head maps 4 x 4 x 8 to 8 x 8 x 3;
- the codebook stage at D = 32 through both packages'
  ``build_codebook_main`` from one YAML (JAX's kNN on its Pallas kernel in
  interpret mode): the graph's structure, the codes, the medoids equal;
  edge lengths and QE within rtol 1e-4;
- cut copies of ``configs/cifar10/spatial/geodesic`` and
  ``configs/cifar10/vanilla/geodesic`` through the port's
  ``run_pipeline``: every artifact JAX's ``run_pipeline`` writes with the
  same overrides (``JAX_ARTIFACTS``, read from JAX's run; its orbax
  checkpoint directories are ``best.pt`` / ``latest.pt`` here);
- ``tools.check_cifar_collapse.measure`` equal to JAX's probe formula on
  the same checkpoint and latents: the latent std exactly, the lengths
  within rtol 1e-4.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vqvae_tpu.models.vae as jax_vae_mod
import vqvae_tpu_torch.models.vae as vae_mod
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.ops.riemannian import (
    edge_lengths_riemannian_auto as jax_lengths,
    make_decoder_image_fn as jax_decoder_image_fn)
from vqvae_tpu.train import VAEEngine as JaxEngine
from vqvae_tpu_torch.cli.pipeline import STAGES, run_pipeline
from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.data import load_dataset
from vqvae_tpu_torch.models import VAE
from vqvae_tpu_torch.ops.riemannian import (build_mlp_decode_fn,
                                            edge_lengths_riemannian_auto,
                                            make_decoder_image_fn)
from vqvae_tpu_torch.train import VAEEngine
from vqvae_tpu_torch.utils.checkpoint import (build_vae, load_vae_state_dict,
                                              vae_state_dict_from_jax)

REPO = Path(__file__).resolve().parents[1]
ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 32
CFG = dict(in_channels=3, enc_channels=ENC, dec_channels=DEC,
           latent_dim=LATENT, recon_loss="mse", output_image_size=32,
           norm_type="batch", mse_use_sigmoid=False, topology="spatial")
FREE_BITS = 0.1
N, BS, LR, WD, CLIP = 20, 8, 1e-3, 1e-5, 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_variables(seed=5, stats=False):
    model = JaxVAE(**CFG)
    variables = _np_tree(model.init({"params": jax.random.key(seed)},
                                    np.zeros((1, 32, 32, 3), np.float32)))
    if stats:  # non-trivial running statistics for eval-mode decoding
        rng = np.random.RandomState(0)
        for st in variables["batch_stats"]["decoder"].values():
            st["mean"] = rng.uniform(-0.3, 0.3, st["mean"].shape).astype(
                np.float32)
            st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(
                np.float32)
    return model, variables


def _port_model(variables, **extra):
    sd = vae_state_dict_from_jax(variables, "spatial", ENC, DEC, "batch")
    return load_vae_state_dict(VAE(**{**CFG, **extra}), sd)


# -- one epoch-path step set with spatial free bits ---------------------------

@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jax_vae_mod, "reparameterize",
                        lambda rng, mu, logvar: mu)
    monkeypatch.setattr(vae_mod, "reparameterize",
                        lambda mu, logvar, generator, rows=None: mu)


def _sd(params, stats):
    return vae_state_dict_from_jax({"params": _np_tree(params),
                                    "batch_stats": _np_tree(stats)},
                                   "spatial", ENC, DEC)


def _pre_norm_biases(model):
    out = set()
    for key, _ in model.named_parameters():
        if key.endswith(".weight") and isinstance(
                model.get_submodule(key[:-len(".weight")]),
                vae_mod.BatchNorm):
            head, idx, _ = key.rsplit(".", 2)
            out.add(f"{head}.{int(idx) - 1}.bias")
    return out


def test_epoch_step_with_free_bits_matches_jax(no_noise):
    x = load_dataset("cifar10", root="no-such-dir", train=True,
                     synthetic_size=N, seed=0).images
    assert x.shape == (N, 32, 32, 3)
    perm = np.random.default_rng(1).permutation(24)
    assert (perm[8:16] >= N).any()  # a padding row in the middle batch
    loader = SimpleNamespace(split=SimpleNamespace(images=x))

    model = JaxVAE(**CFG, spatial_free_bits=FREE_BITS)
    jeng = JaxEngine(model, lr=LR, weight_decay=WD, grad_clip_max_norm=CLIP,
                     cosine_t_max=3, steps_per_epoch=3, seed=0)
    state = jeng.init_state(x[:1])
    sd0 = _sd(state.params, state.batch_stats)
    train_fn, _ = jeng._build_epoch_fns(BS)
    data, mask, steps, _ = jeng._device_dataset(loader, BS)
    state, tr = train_fn(state, data, mask, jnp.asarray(perm),
                         jax.random.key(1), jnp.float32(1.0), n_steps=steps)

    port = load_vae_state_dict(VAE(**CFG, spatial_free_bits=FREE_BITS), sd0)
    with torch.no_grad():  # both sides of the floor on the first batch
        mu, logvar = port.encode(torch.from_numpy(x[perm[:8] % N]))
        kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    assert (kl < FREE_BITS).any() and (kl > FREE_BITS).any()
    eng = VAEEngine(port, lr=LR, weight_decay=WD, grad_clip_max_norm=CLIP,
                    cosine_t_max=3, steps_per_epoch=3, seed=0, device="cpu")
    pdata, pmask, psteps, _ = eng.device_dataset(loader, BS)
    ptr = eng.train_epoch(pdata, pmask, torch.from_numpy(perm), 1.0, psteps,
                          BS, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ptr.numpy(), np.asarray(tr), rtol=1e-5)

    want = _sd(state.params, state.batch_stats)
    skip = _pre_norm_biases(eng.model)
    assert len(skip) == 5
    for key, p in eng.model.named_parameters():
        got, ref = p.detach().numpy(), want[key].numpy()
        assert np.isfinite(got).all(), key
        if key in skip:
            assert np.abs(got - ref).max() <= 2 * 3 * LR * 1.01, key
            continue
        loose = np.abs(got - ref) > 1e-4 * np.abs(ref) + 2e-5 * np.abs(
            ref).max()
        assert loose.sum() <= max(1, 1e-3 * ref.size), (key, loose.sum())
        assert (np.abs(got - ref) <= 2 * 3 * LR).all(), key


# -- Riemannian lengths at 3 channels, 32 px ----------------------------------

def _edges(n=120, e=300, seed=1):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, LATENT).astype(np.float32)
    rows = rng.randint(0, n, e)
    cols = (rows + 1 + rng.randint(0, n - 1, e)) % n
    return z, rows, cols


@pytest.mark.parametrize("engine", ["mlp", "edgewise", "nodal"])
def test_lengths_match_jax_at_three_channels(engine, monkeypatch):
    model, variables = _jax_variables(stats=True)
    port = _port_model(variables)
    z, rows, cols = _edges()
    monkeypatch.setenv("VQVAE_TPU_RIEMANNIAN", engine)
    ref = jax_lengths(jax_decoder_image_fn(model, variables, "spatial"), z,
                      rows, cols, batch_size=128)
    out = edge_lengths_riemannian_auto(make_decoder_image_fn(port), z, rows,
                                       cols, batch_size=128, engine=engine,
                                       device="cpu")
    assert out.shape == ref.shape == (len(rows),)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_linearized_head_maps_to_three_channels():
    _, variables = _jax_variables(stats=True)
    port = _port_model(variables)
    from vqvae_tpu_torch.ops.riemannian import _decoder_affine_segments

    segs = _decoder_affine_segments(port.eval())
    assert [tuple(M.shape) for M, _ in segs] == [
        (LATENT, 2 * 2 * 16), (2 * 2 * 16, 4 * 4 * 8), (4 * 4 * 8, 8 * 8 * 3)]
    mlp = build_mlp_decode_fn(port)
    z = torch.from_numpy(_edges()[0][:6])
    with torch.no_grad():
        conv = torch.sigmoid(port.decode(z[:, None, None, :]))
    # NHWC flattening: the mlp's rows are the conv image's (H, W, C) order
    np.testing.assert_allclose(mlp(z).numpy(),
                               conv.reshape(6, -1).numpy(), rtol=1e-4,
                               atol=1e-6)
    assert conv.shape == (6, 8, 8, 3)


# -- the codebook stage at D = 32 ---------------------------------------------

def _codebook_inputs(tmp_path: Path) -> Path:
    from vqvae_tpu.utils.latents import save_latents
    from vqvae_tpu.utils.torch_compat import export_reference_vae_checkpoint

    _, variables = _jax_variables(seed=0)
    ckpt = export_reference_vae_checkpoint(
        variables, tmp_path / "vae" / "best.pt", "spatial", ENC, DEC,
        "batch")
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 0.5, size=(6, LATENT)).astype(np.float32)
    z = centers[rng.integers(0, 6, size=(96, 4, 4))]
    z = z + rng.normal(0, 1.0, size=z.shape).astype(np.float32)
    z[-1] = 40.0 + rng.normal(0, 0.1, size=(4, 4, LATENT))  # far-off image
    z = z.astype(np.float32)
    save_latents(tmp_path / "latents", z, z, np.zeros_like(z),
                 np.zeros(96, np.int64))
    preset = yaml.safe_load((REPO / "configs/cifar10/spatial/geodesic/"
                             "codebook.yaml").read_text())
    cfg = {**preset, "latents_path": str(tmp_path / "latents"),
           "vae_ckpt_path": str(ckpt), "out_dir": str(tmp_path / "out"),
           "vae": {**preset["vae"], "enc_channels": list(ENC),
                   "dec_channels": list(DEC)},
           "graph": {"k": 10, "sym": "union"},
           "quantize": {"K": 16, "init": "kpp_parallel", "seed": 42},
           "system": {"batch_size": 512}}
    assert cfg["vae"]["latent_dim"] == LATENT and cfg["vae"][
        "in_channels"] == 3
    path = tmp_path / "codebook.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_codebook_stage_at_d32_matches_jax(tmp_path, monkeypatch):
    from scipy import sparse

    from vqvae_tpu.cli.build_codebook import (
        build_codebook_main as jax_build_codebook_main)
    from vqvae_tpu.config import load_config as jax_load_config
    from vqvae_tpu.ops.kmedoids import fit_kmedoids as jax_fit
    from vqvae_tpu_torch.cli.build_codebook import (build_codebook_main,
                                                    load_codebook)
    from vqvae_tpu_torch.config import load_config

    cfg_path = _codebook_inputs(tmp_path)
    monkeypatch.setenv("VQVAE_TPU_KNN_KERNEL", "pallas")
    jax_out = jax_build_codebook_main(jax_load_config(
        cfg_path, {"out_dir": str(tmp_path / "jax")}))
    out = build_codebook_main(
        load_config(cfg_path, {"out_dir": str(tmp_path / "port")}),
        device="cpu")
    ref_codes, codes = (np.load(d / "codes.npy") for d in (jax_out, out))
    assert codes.shape == ref_codes.shape == (96, 4, 4)
    assert (codes[-1] == -1).all() and (codes[:-1] >= 0).all()
    np.testing.assert_array_equal(codes, ref_codes)
    ref_cb, cb = load_codebook(jax_out), load_codebook(out)
    np.testing.assert_array_equal(cb["medoid_indices"],
                                  ref_cb["medoid_indices"])
    np.testing.assert_array_equal(cb["z_medoid"], ref_cb["z_medoid"])
    assert cb["z_medoid"].shape == (16, LATENT)
    ref_w = sparse.load_npz(jax_out / "knn_graph_geodesic.npz")
    w = sparse.load_npz(out / "knn_graph_geodesic.npz")
    np.testing.assert_array_equal(w.indptr, ref_w.indptr)
    np.testing.assert_array_equal(w.indices, ref_w.indices)
    np.testing.assert_allclose(w.data, ref_w.data, rtol=1e-4)
    _, _, ref_qe = jax_fit(ref_w, K=16, init="kpp_parallel", seed=42)
    np.testing.assert_allclose(cb["config"]["quantization_error"], ref_qe,
                               rtol=1e-4)


# -- the cut presets through run_pipeline -------------------------------------

W8 = {"enc_channels": [8, 16, 32], "dec_channels": [32, 16, 8]}


def _cut(num_tokens: int):
    tf = {"num_tokens": num_tokens, "embed_dim": 32, "n_layers": 1,
          "n_head": 2}
    return {
        "vae": {"max_epochs": 1, "model": W8,
                "data": {"synthetic_size": 128, "batch_size": 32}},
        "codebook": {"vae": W8, "quantize": {"K": 16},
                     "riemannian": {"max_edges": 100, "batch_size": 64}},
        "quality": {"synthetic_size": 64},
        "transformer": {"training": {"epochs": 1}, "model": tf},
        "generate": {"vae": W8, "transformer": tf, "num_samples": 20,
                     "top_k": 8},
        "evaluate": {"data": {"synthetic_size": 64}, "num_samples": 20}}


_SPATIAL_VAE = "vae/spatial_vae_cifar10/"
_COMMON = ("codebook/codebook.npz", "codebook/codebook.pt",
           "codebook/codes.npy", "evaluation/codebook_health.json",
           "evaluation/comparison_grid.png",
           "evaluation/generated_samples.png", "evaluation/metrics.yaml",
           "evaluation/quantization_analysis.json",
           "transformer/checkpoints/best.pt",
           "transformer/checkpoints/latest.pt",
           "transformer/labels_cache.npy", "transformer/metrics.csv",
           "transformer/metrics.jsonl", "transformer/params.yaml")
_VAE = ("checkpoints/best.pt", "checkpoints/latest.pt",
        "latents_train/latents.npz", "latents_val/latents.npz",
        "metrics.csv", "metrics.jsonl", "params.yaml", "recon_grid.png",
        "vae_quality_assessment.json")
JAX_ARTIFACTS = {
    "spatial/geodesic": sorted(
        _COMMON + ("codebook/knn_graph_geodesic.npz",)
        + tuple(_SPATIAL_VAE + f for f in _VAE)),
    "vanilla/geodesic": sorted(
        _COMMON + ("codebook/knn_graph.npz",
                   "codebook/knn_graph_riemannian.npz")
        + tuple("vae/" + f for f in _VAE)),
}


@pytest.mark.parametrize("variant,num_tokens", [("spatial/geodesic", 16),
                                                ("vanilla/geodesic", 17)])
def test_cut_presets_write_jax_artifacts(variant, num_tokens, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("VQVAE_TPU_SYNTH_SIZE", "128")
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    timings = run_pipeline(REPO / "configs" / "cifar10" / variant,
                           overrides=_cut(num_tokens), root_dir=tmp_path,
                           device="cpu")
    assert list(timings) == list(STAGES) + ["total"]
    exp = tmp_path / "experiments" / "cifar10" / variant
    written = sorted(str(p.relative_to(exp)) for p in exp.rglob("*")
                     if p.is_file())
    assert written == JAX_ARTIFACTS[variant]
    metrics = yaml.safe_load((exp / "evaluation" / "metrics.yaml")
                             .read_text())
    assert np.isfinite(metrics["PSNR_full"])
    assert np.isfinite(metrics["SSIM_full"])
    codes = np.load(exp / "codebook" / "codes.npy")
    assert codes.shape == ((128, 4, 4) if variant.startswith("spatial")
                           else (128,))
    health = json.loads((exp / "evaluation" / "codebook_health.json")
                        .read_text())
    assert health["dataset"] == "cifar10"


# -- the collapse probe's measurement -----------------------------------------

def test_probe_measure_matches_jax_formula(tmp_path):
    from vqvae_tpu.ops import edge_lengths_riemannian as jax_endpoint
    from vqvae_tpu.utils.torch_compat import export_reference_vae_checkpoint
    from vqvae_tpu_torch.tools.check_cifar_collapse import VAE_KEYS, measure
    from vqvae_tpu_torch.utils.latents import save_latents

    model, variables = _jax_variables(seed=2, stats=True)
    run_dir = tmp_path / "spatial_vae_cifar10"
    export_reference_vae_checkpoint(variables, run_dir / "checkpoints" /
                                    "best.pt", "spatial", ENC, DEC, "batch")
    rng = np.random.default_rng(3)
    z = (rng.normal(size=(40, 4, 4, LATENT))
         * rng.uniform(0.2, 1.5, LATENT)).astype(np.float32)
    save_latents(run_dir / "latents_train", z, z, np.zeros_like(z),
                 np.zeros(40, np.int64))
    cfg = Config({"model": {**{k: CFG[k] for k in VAE_KEYS},
                            "recon_loss": "mse", "mse_use_sigmoid": False}})
    got = measure(run_dir, cfg, device="cpu")

    # JAX's probe, line for line, on the same weights and latents
    cells = z.reshape(-1, LATENT)
    per_dim_std = cells.std(axis=0)
    draw = np.random.default_rng(0)
    idx = draw.integers(0, len(cells), size=2048)
    za = cells[idx]
    zb = za + draw.normal(0, per_dim_std.mean() + 1e-8,
                          size=za.shape).astype(np.float32)
    lengths = np.asarray(jax_endpoint(
        jax_decoder_image_fn(model, variables, "spatial"), za, zb,
        batch_size=512))
    assert got["latent_std_mean"] == float(per_dim_std.mean())
    assert got["latent_std_min"] == float(per_dim_std.min())
    np.testing.assert_allclose(got["riem_length_mean"], lengths.mean(),
                               rtol=1e-4)
    np.testing.assert_allclose(got["riem_length_p90"],
                               np.quantile(lengths, 0.9), rtol=1e-4)
    assert got["collapsed"] is False
