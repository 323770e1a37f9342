"""Port parity: the VAE modules and the weight carry-across from JAX.

JAX ``VAE.init`` weights (batch statistics randomized so the norm mapping
is exercised) go through ``vae_state_dict_from_jax`` into the port's
``models.VAE``; decoded logits must agree with the JAX decoder within
1e-5 (float order of the convolutions only). The file that
``export_reference_vae_checkpoint`` writes must load into the same state.
"""
import jax
import numpy as np
import pytest
import torch

from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.utils.torch_compat import export_reference_vae_checkpoint
from vqvae_tpu_torch.utils.checkpoint import (build_vae,
                                              load_vae_from_checkpoint,
                                              load_vae_state_dict,
                                              vae_state_dict_from_jax)

ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 6


def _jax_model(topology, size, norm="batch"):
    in_ch = 3 if size == 32 else 1
    cfg = dict(in_channels=in_ch, enc_channels=ENC, dec_channels=DEC,
               latent_dim=LATENT, recon_loss="mse", output_image_size=size,
               norm_type=norm, topology=topology)
    model = JaxVAE(**cfg)
    variables = jax.device_get(model.init(
        {"params": jax.random.key(3)},
        np.zeros((1, size, size, in_ch), np.float32)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if norm == "batch":  # non-trivial running statistics
        rng = np.random.RandomState(0)
        for side in variables["batch_stats"].values():
            for st in side.values():
                st["mean"] = rng.uniform(-0.5, 0.5, st["mean"].shape).astype(
                    np.float32)
                st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(
                    np.float32)
    return model, variables, cfg


def _port_model(variables, cfg):
    sd = vae_state_dict_from_jax(variables, cfg["topology"], ENC, DEC,
                                 cfg["norm_type"])
    return load_vae_state_dict(build_vae(cfg), sd).eval()


@pytest.mark.parametrize("topology,size,norm", [
    ("spatial", 28, "batch"), ("spatial", 32, "batch"),
    ("spatial", 28, "none"), ("flat", 28, "batch"), ("flat", 32, "batch")])
def test_decode_matches_jax(topology, size, norm):
    model, variables, cfg = _jax_model(topology, size, norm)
    port = _port_model(variables, cfg)
    rng = np.random.RandomState(1)
    z = rng.randn(*((5, 4, 4, LATENT) if topology == "spatial"
                    else (5, LATENT))).astype(np.float32)
    ref = np.asarray(model.apply(variables, z, method=model.decode))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (5, size, size, cfg["in_channels"])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_encode_matches_jax(topology):
    model, variables, cfg = _jax_model(topology, 28)
    port = _port_model(variables, cfg)
    x = np.random.RandomState(2).rand(3, 28, 28, 1).astype(np.float32)
    mu, logvar = model.apply(variables, x, method=model.encode)
    with torch.no_grad():
        p_mu, p_logvar = port.encode(torch.from_numpy(x))
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p_logvar.numpy(), np.asarray(logvar),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_exported_checkpoint_loads_same_state(tmp_path, topology):
    _, variables, cfg = _jax_model(topology, 28)
    path = export_reference_vae_checkpoint(variables, tmp_path / "vae.pt",
                                           topology, ENC, DEC, "batch")
    loaded = load_vae_from_checkpoint(path, cfg, device="cpu")
    want = vae_state_dict_from_jax(variables, topology, ENC, DEC, "batch")
    got = loaded.state_dict()
    for key, val in want.items():
        torch.testing.assert_close(got[key], val, rtol=0, atol=0)


def test_orbax_directory_names_the_way_across(tmp_path):
    _, _, cfg = _jax_model("spatial", 28)
    with pytest.raises(ValueError, match="export_reference_vae_checkpoint"):
        load_vae_from_checkpoint(tmp_path, cfg, device="cpu")
