"""Port parity: the public names of ``vqvae_tpu.config``,
``vqvae_tpu.models`` and ``vqvae_tpu.utils`` that the port carries too.

- ``Config.to_dict`` (a deep copy), ``Config.replace`` (a nested override
  deep-merged into a new config) and ``save_config`` (a YAML round trip in
  the config's key order) give what ``vqvae_tpu.config`` gives on the same
  mapping, and the read-only error names ``.replace``;
- ``models.decode_to_image`` on weights carried across with
  ``vae_state_dict_from_jax`` agrees with JAX's within rtol 1e-5 / atol
  1e-6, spatial (a 4 x 4 latent grid and the 1 x 1 one of the metric) and
  flat, with running statistics away from flax's initial ones; the
  Riemannian decode map gives the same bits;
- ``vqvae_tpu_torch.utils`` exports ``MetricsLogger``, ``save_image_grid``
  and ``auto_detect_vae_config``, as ``vqvae_tpu.utils`` does, and the
  package exports of both trees hold the same names apart from the
  differences on purpose.
"""
import jax
import numpy as np
import pytest
import torch

import vqvae_tpu.models as jax_models
import vqvae_tpu.utils as jax_utils
import vqvae_tpu_torch.models as port_models
import vqvae_tpu_torch.utils as port_utils
from vqvae_tpu.config import Config as JaxConfig
from vqvae_tpu.config import load_config as jax_load_config
from vqvae_tpu.config import save_config as jax_save_config
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.models import decode_to_image as jax_decode_to_image
from vqvae_tpu_torch.config import Config, load_config, save_config
from vqvae_tpu_torch.models import decode_to_image
from vqvae_tpu_torch.ops.riemannian import make_decoder_image_fn
from vqvae_tpu_torch.utils.checkpoint import (build_vae, load_vae_state_dict,
                                              vae_state_dict_from_jax)

DATA = {"seed": 42, "lr": 3e-4,
        "model": {"latent_dim": 16, "enc_channels": [64, 128, 256],
                  "norm_type": "batch", "head": {"k": 4, "p": None}},
        "data": {"name": "FashionMNIST", "batch_size": 256},
        "tags": ["a", "b"]}
UPDATES = {"lr": 1e-3, "model": {"latent_dim": 32, "head": {"p": 1},
                                 "new": [1, 2]},
           "extra": {"x": 1}}
PRESET = "configs/fashionmnist/spatial/geodesic/vae.yaml"


def test_to_dict_and_replace_match_jax():
    port, ref = Config(DATA), JaxConfig(DATA)
    assert port.to_dict() == ref.to_dict() == DATA
    copy = port.to_dict()
    copy["model"]["enc_channels"].append(512)
    assert port.model.enc_channels == [64, 128, 256]  # a deep copy
    new, want = port.replace(**UPDATES), ref.replace(**UPDATES)
    assert isinstance(new, Config)
    assert new.to_dict() == want.to_dict()
    assert new.model.head.to_dict() == {"k": 4, "p": 1}
    assert new.model.enc_channels == [64, 128, 256]
    assert port.to_dict() == DATA  # replace leaves the original as it was
    with pytest.raises(TypeError, match=r"\.replace"):
        port.lr = 1.0


@pytest.mark.parametrize("kind", ["config", "mapping", "preset"])
def test_save_config_round_trip_matches_jax(tmp_path, kind):
    if kind == "preset":
        port, ref = (load_config(PRESET, UPDATES),
                     jax_load_config(PRESET, UPDATES))
    elif kind == "config":
        port, ref = Config(DATA), JaxConfig(DATA)
    else:
        port = ref = dict(DATA)
    save_config(port, tmp_path / "port" / "deep" / "cfg.yaml")
    jax_save_config(ref, tmp_path / "jax" / "deep" / "cfg.yaml")
    text = (tmp_path / "port" / "deep" / "cfg.yaml").read_text()
    assert text == (tmp_path / "jax" / "deep" / "cfg.yaml").read_text()
    back = load_config(tmp_path / "port" / "deep" / "cfg.yaml")
    want = port.to_dict() if kind != "mapping" else DATA
    assert back.to_dict() == want
    assert list(back) == list(want)  # key order kept (sort_keys=False)


@pytest.mark.parametrize("topology,grid", [("spatial", 4), ("spatial", 1),
                                           ("flat", None)])
def test_decode_to_image_matches_jax(topology, grid):
    enc, dec, latent = (8, 16, 32), (32, 16, 8), 6
    cfg = dict(in_channels=1, enc_channels=enc, dec_channels=dec,
               latent_dim=latent, recon_loss="mse", output_image_size=28,
               norm_type="batch", topology=topology)
    model = JaxVAE(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        model.init({"params": jax.random.key(5)},
                   np.zeros((1, 28, 28, 1), np.float32))))
    rng = np.random.default_rng(7)
    # running statistics away from flax's (0, 1) start, so eval mode shows
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 2.0, a.shape) if a.min() > 0 else
                   rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    port = load_vae_state_dict(build_vae(cfg), vae_state_dict_from_jax(
        variables, topology, enc, dec)).eval()
    shape = (5, grid, grid, latent) if grid else (5, latent)
    z = rng.normal(0.0, 1.0, shape).astype(np.float32)
    want = np.asarray(jax_decode_to_image(model, variables, z))
    with torch.no_grad():
        got = decode_to_image(port, torch.from_numpy(z)).numpy()
    # a 1 x 1 grid decodes to 4 x 4 pixels (1 -> 2 -> 4 -> 2 * 4 - 4)
    assert got.shape == want.shape == (5, 16 if grid == 1 else 28 * 28)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if grid in (1, None):  # the Riemannian map is this function
        fn = make_decoder_image_fn(port, topology)
        flat = torch.from_numpy(z.reshape(5, latent))
        with torch.no_grad():
            assert torch.equal(fn(flat), decode_to_image(
                port, flat[:, None, None, :] if grid else flat))


def test_package_exports_match_jax():
    for name in ("MetricsLogger", "save_image_grid",
                 "auto_detect_vae_config"):
        assert name in port_utils.__all__ and hasattr(port_utils, name)
    assert port_utils.auto_detect_vae_config.__module__ \
        == "vqvae_tpu_torch.utils.checkpoint"
    # flax's TrainState and orbax's Checkpointer have no port (on purpose)
    assert set(jax_utils.__all__) - {"Checkpointer"} <= \
        set(port_utils.__all__)
    assert set(jax_models.__all__) <= set(port_models.__all__)
