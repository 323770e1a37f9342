"""Port parity: the Riemannian stage's accounting.

- ``conv_decoder_jvp_flops_per_sample`` equals JAX's at (28 px, 1
  channel), (32, 1) and (32, 3), at the presets' decoder widths and at
  narrow ones (exact: both are integer arithmetic in float64);
- the linearized decoder's ``jvp_flops_per_sample`` equals JAX's on the
  same JAX-initialized weights carried across (exact: it counts the
  probed matrices' entries);
- ``RIEM_STATS``: one record per ``edge_lengths_riemannian_auto`` call
  with JAX's keys, the same engine and the same sample count as JAX's
  ``VQVAE_TPU_RIEM_STATS=1`` run on the same edges; the port's nodal
  engine (which JAX does not record) counts each node's D basis JVPs.
"""
import jax
import numpy as np
import pytest
import torch

from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.ops import riemannian as jax_riem
from vqvae_tpu_torch.ops import riemannian as riem
from vqvae_tpu_torch.utils.checkpoint import (build_vae, load_vae_state_dict,
                                              vae_state_dict_from_jax)

SHAPES = [(28, 1), (32, 1), (32, 3)]
PRESET = dict(enc_channels=(64, 128, 256), dec_channels=(256, 128, 64))
NARROW = dict(enc_channels=(8, 16, 32), dec_channels=(32, 16, 8))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(size, channels, widths, latent):
    return dict(in_channels=channels, latent_dim=latent, recon_loss="mse",
                output_image_size=size, norm_type="batch",
                topology="spatial", **widths)


def _pair(size, channels, widths=NARROW, latent=6):
    cfg = _cfg(size, channels, widths, latent)
    model = JaxVAE(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(model.init(
        {"params": jax.random.key(3)},
        np.zeros((1, size, size, channels), np.float32))))
    sd = vae_state_dict_from_jax(variables, "spatial", cfg["enc_channels"],
                                 cfg["dec_channels"], "batch")
    port = load_vae_state_dict(build_vae(cfg), sd)
    return model, variables, port


@pytest.mark.parametrize("size,channels", SHAPES)
@pytest.mark.parametrize("widths,latent", [(PRESET, 16), (PRESET, 32),
                                           (NARROW, 6)])
def test_conv_flops_match_jax(size, channels, widths, latent):
    cfg = _cfg(size, channels, widths, latent)
    want = jax_riem.conv_decoder_jvp_flops_per_sample(JaxVAE(**cfg))
    got = riem.conv_decoder_jvp_flops_per_sample(build_vae(cfg))
    assert got == want and got > 0
    flat = build_vae({**cfg, "topology": "flat"})
    assert riem.conv_decoder_jvp_flops_per_sample(flat) is None


def test_conv_flops_at_the_presets():
    """FashionMNIST's decoder (latent 16, 28 px, 1 channel) and CIFAR's
    (latent 32, 32 px, 3 channels), counted by hand."""
    fashion = build_vae(_cfg(28, 1, PRESET, 16))
    cifar = build_vae(_cfg(32, 3, PRESET, 32))
    deconvs = 2 * 2 * 16 * 256 * 128 + 4 * 4 * 16 * 128 * 64
    assert riem.conv_decoder_jvp_flops_per_sample(fashion) == 4.0 * (
        16 * 256 + deconvs + 4 * 4 * 16 * 64 * 1)
    assert riem.conv_decoder_jvp_flops_per_sample(cifar) == 4.0 * (
        32 * 256 + deconvs + 8 * 8 * 16 * 64 * 3)


@pytest.mark.parametrize("size,channels", SHAPES)
def test_mlp_flops_match_jax(size, channels):
    model, variables, port = _pair(size, channels)
    want = jax_riem.build_mlp_decode_fn(model, variables)
    got = riem.build_mlp_decode_fn(port)
    assert got.jvp_flops_per_sample == want.jvp_flops_per_sample
    out = 4 * 4 if size == 28 else 8 * 8
    assert got.jvp_flops_per_sample == 4.0 * (
        6 * 2 * 2 * 16 + 2 * 2 * 16 * 4 * 4 * 8 + 4 * 4 * 8 * out * channels)


@pytest.mark.parametrize("engine", ["mlp", "edgewise"])
def test_riem_stats_match_jax(engine, monkeypatch):
    model, variables, port = _pair(32, 3)
    rng = np.random.RandomState(0)
    z = rng.randn(50, 6).astype(np.float32)
    rows = rng.randint(0, 50, 120)
    cols = (rows + 1 + rng.randint(0, 49, 120)) % 50
    monkeypatch.setenv("VQVAE_TPU_RIEMANNIAN", engine)
    monkeypatch.setenv("VQVAE_TPU_RIEM_STATS", "1")
    n_jax, n_port = len(jax_riem.RIEM_STATS), len(riem.RIEM_STATS)
    jax_riem.edge_lengths_riemannian_auto(
        jax_riem.make_decoder_image_fn(model, variables, "spatial"), z, rows,
        cols, batch_size=64)
    riem.edge_lengths_riemannian_auto(riem.make_decoder_image_fn(port), z,
                                      rows, cols, batch_size=64,
                                      engine=engine, device="cpu")
    assert len(jax_riem.RIEM_STATS) == n_jax + 1
    assert len(riem.RIEM_STATS) == n_port + 1
    want, got = jax_riem.RIEM_STATS[-1], riem.RIEM_STATS[-1]
    assert set(got) == set(want)
    for key in ("engine", "samples", "jvp_flops_per_sample"):
        assert got[key] == want[key], key
    assert got["samples"] == 2 * len(rows) and got["seconds"] > 0


def test_nodal_record_counts_basis_jvps():
    _, _, port = _pair(28, 1)
    z = np.random.RandomState(1).randn(30, 6).astype(np.float32)
    rows, cols = np.arange(29), np.arange(1, 30)
    n = len(riem.RIEM_STATS)
    riem.edge_lengths_riemannian_auto(riem.make_decoder_image_fn(port), z,
                                      rows, cols, batch_size=60,
                                      engine="nodal", device="cpu")
    assert len(riem.RIEM_STATS) == n + 1
    rec = riem.RIEM_STATS[-1]
    assert rec["engine"] == "nodal" and rec["samples"] == 30 * 6
    assert rec["jvp_flops_per_sample"] == \
        riem.conv_decoder_jvp_flops_per_sample(port)
