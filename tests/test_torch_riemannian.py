"""Port parity: Riemannian edge lengths through decoder JVPs.

The same JAX-initialized spatial decoder (carried across with
``vae_state_dict_from_jax``) and the same edges go through the JAX
``edge_lengths_riemannian_auto`` and the port's, engine by engine. rtol
1e-4: the JVP's float order differs between the frameworks (convolution
algorithms, the probed affine segments' matmuls).
"""
import jax
import numpy as np
import pytest

from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.ops.riemannian import (
    edge_lengths_riemannian_auto as jax_lengths,
    make_decoder_image_fn as jax_decoder_image_fn)
from vqvae_tpu_torch.ops.riemannian import (build_mlp_decode_fn,
                                            edge_lengths_riemannian_auto,
                                            make_decoder_image_fn)
from vqvae_tpu_torch.utils.checkpoint import (build_vae, load_vae_state_dict,
                                              vae_state_dict_from_jax)

LATENT = 8


def _models(topology="spatial", size=28):
    cfg = dict(in_channels=1, enc_channels=(8, 16, 32),
               dec_channels=(32, 16, 8), latent_dim=LATENT,
               recon_loss="mse", output_image_size=size, norm_type="batch",
               topology=topology)
    model = JaxVAE(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(model.init(
        {"params": jax.random.key(5)}, np.zeros((1, size, size, 1),
                                                np.float32))))
    rng = np.random.RandomState(0)
    for st in variables["batch_stats"]["decoder"].values():
        st["mean"] = rng.uniform(-0.3, 0.3, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    sd = vae_state_dict_from_jax(variables, topology, cfg["enc_channels"],
                                 cfg["dec_channels"], "batch")
    port = load_vae_state_dict(build_vae(cfg), sd)
    return (jax_decoder_image_fn(model, variables, topology),
            make_decoder_image_fn(port))


def _edges(n=300, e=700, seed=1):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, LATENT).astype(np.float32)
    rows = rng.randint(0, n, e)
    cols = (rows + 1 + rng.randint(0, n - 1, e)) % n
    return z, rows, cols


@pytest.mark.parametrize("engine", ["mlp", "edgewise"])
def test_lengths_match_jax(engine, monkeypatch):
    jax_fn, port_fn = _models()
    z, rows, cols = _edges()
    monkeypatch.setenv("VQVAE_TPU_RIEMANNIAN", engine)
    ref = jax_lengths(jax_fn, z, rows, cols, batch_size=256)
    out = edge_lengths_riemannian_auto(port_fn, z, rows, cols,
                                       batch_size=256, engine=engine,
                                       device="cpu")
    assert out.shape == ref.shape == (len(rows),) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_mlp_engine_agrees_with_conv_engine():
    _, port_fn = _models(size=32)
    z, rows, cols = _edges(e=300, seed=2)
    assert build_mlp_decode_fn(port_fn.model) is not None  # self-check passes
    a = edge_lengths_riemannian_auto(port_fn, z, rows, cols, engine="mlp",
                                     device="cpu")
    b = edge_lengths_riemannian_auto(port_fn, z, rows, cols,
                                     engine="edgewise", device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_flat_decoder_takes_the_conv_engine():
    _, port_fn = _models(topology="flat")
    assert build_mlp_decode_fn(port_fn.model) is None
    with pytest.raises(ValueError):
        edge_lengths_riemannian_auto(port_fn, np.zeros((4, LATENT),
                                                       np.float32),
                                     np.array([0]), np.array([1]),
                                     engine="mlp", device="cpu")


def test_batch_size_invariance():
    _, port_fn = _models()
    z, rows, cols = _edges(e=333, seed=3)
    a = edge_lengths_riemannian_auto(port_fn, z, rows, cols, batch_size=64,
                                     engine="edgewise", device="cpu")
    b = edge_lengths_riemannian_auto(port_fn, z, rows, cols, batch_size=333,
                                     engine="edgewise", device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert (a > 0).all()


# -- the nodal engine (per-node pullback metrics) ----------------------------

@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_pullback_metrics_match_jax(topology):
    from vqvae_tpu.ops.riemannian import pullback_metrics as jax_pullback
    from vqvae_tpu_torch.ops.riemannian import pullback_metrics

    jax_fn, port_fn = _models(topology=topology)
    z, _, _ = _edges(n=40, e=1)
    ref = jax_pullback(jax_fn, z, batch_size=64)
    got = pullback_metrics(port_fn, z, batch_size=64, device="cpu")
    assert got.shape == ref.shape == (40, LATENT, LATENT)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(got, got.transpose(0, 2, 1), rtol=1e-5,
                               atol=1e-7 * np.abs(got).max())


@pytest.mark.parametrize("topology,rtol", [("spatial", 1e-3),
                                           ("flat", 1e-4)])
def test_nodal_engine_matches_edgewise_and_jax(topology, rtol, monkeypatch):
    """JAX's own bounds for nodal against edgewise (spatial rtol 1e-3,
    flat 1e-4, atol 1e-5); against JAX's nodal engine rtol 1e-4."""
    jax_fn, port_fn = _models(topology=topology)
    z, rows, cols = _edges(n=60, e=250, seed=4)
    nodal = edge_lengths_riemannian_auto(port_fn, z, rows, cols,
                                         batch_size=64, engine="nodal",
                                         device="cpu")
    edgewise = edge_lengths_riemannian_auto(port_fn, z, rows, cols,
                                            batch_size=64,
                                            engine="edgewise", device="cpu")
    np.testing.assert_allclose(nodal, edgewise, rtol=rtol, atol=1e-5)
    monkeypatch.setenv("VQVAE_TPU_RIEMANNIAN", "nodal")
    ref = jax_lengths(jax_fn, z, rows, cols, batch_size=64)
    np.testing.assert_allclose(nodal, ref, rtol=1e-4)
    from vqvae_tpu_torch.ops.riemannian import edge_lengths_riemannian_nodal
    blocks = edge_lengths_riemannian_nodal(port_fn, z, rows, cols,
                                           batch_size=64, edge_block=100,
                                           device="cpu")
    np.testing.assert_allclose(blocks, nodal, rtol=1e-6)
