"""Port parity: VAE training (model, loss, BatchNorm, optimizer, init,
latent dump, and a short training curve).

Weights cross from JAX through ``vae_state_dict_from_jax``; it is linear,
so it carries gradients across too. Spatial and flat models at small
widths, 28 px, a batch of 8 whose last 3 rows are padding (mask 0, zero
images, counted in the BatchNorm statistics as flax counts them).

- train-mode forward (z = mu): within rtol 1e-4 / atol 1e-5;
- ``elbo_loss`` on every branch: within rtol 1e-5;
- gradients: within rtol 1e-4, or 2e-5 of the tensor's largest gradient.
  The loss sums over pixels, so gradients reach ~10, and the f32 sums over
  the batch's positions leave ~1e-5 of absolute residue (measured at most
  8.2e-6 of the largest gradient) on elements that cancel to near 0;
  conv biases that feed a BatchNorm have a true gradient of 0 and are
  checked to be ~0 on both sides;
- BatchNorm running statistics after one training forward: within rtol
  1e-5. This is the test that showed the port's first BatchNorm (torch's
  momentum 0.1 and unbiased running variance) drifting from flax's
  (momentum 0.99, biased variance);
- parameters after 3 AdamW + clip + cosine steps on the same gradients as
  optax: within rtol 1e-5;
- per-layer init std at the preset's widths: within 10 % of flax's;
- ``dump_latents``: mu within 1e-5 of JAX's, (z - mu) / sigma ~ N(0, 1);
- 3 epochs of ``train_vae_main`` from the same init on 512 synthetic
  images: final val loss within 15 % of JAX's (training agrees
  statistically: the noise and batch order differ).
"""
import json

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from vqvae_tpu.cli.train_vae import train_vae_main as jax_train_vae_main
from vqvae_tpu.config import load_config as jax_load_config
from vqvae_tpu.data import get_data_loaders as jax_loaders
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.models.vae import elbo_loss as jax_elbo
from vqvae_tpu.train import VAEEngine as JaxEngine
from vqvae_tpu.train.state import make_optimizer as jax_make_optimizer
from vqvae_tpu_torch.cli.train_vae import train_vae_main
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.data import get_data_loaders
from vqvae_tpu_torch.models.vae import BatchNorm, elbo_loss, flax_init_
from vqvae_tpu_torch.train import VAEEngine, make_optimizer
from vqvae_tpu_torch.utils.checkpoint import (build_vae, load_vae_state_dict,
                                              read_checkpoint,
                                              vae_state_dict_from_jax)

ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _setup(topology, enc=ENC, dec=DEC, latent=LATENT, seed=3):
    cfg = dict(in_channels=1, enc_channels=enc, dec_channels=dec,
               latent_dim=latent, recon_loss="mse", output_image_size=28,
               norm_type="batch", topology=topology)
    model = JaxVAE(**cfg)
    variables = _np_tree(model.init({"params": jax.random.key(seed)},
                                    np.zeros((1, 28, 28, 1), np.float32)))
    return model, variables, cfg


def _port(variables, cfg):
    sd = vae_state_dict_from_jax(variables, cfg["topology"],
                                 cfg["enc_channels"], cfg["dec_channels"])
    return load_vae_state_dict(build_vae(cfg), sd)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((8, 28, 28, 1), dtype=np.float32)
    mask = np.ones(8, np.float32)
    x[5:] = 0.0
    mask[5:] = 0.0
    return x, mask


def _jax_loss(model, params, stats, x, mask):
    (logits, mu, logvar, z), new = model.apply(
        {"params": params, "batch_stats": stats}, x, None, True,
        mutable=["batch_stats"])
    total, recon, kl = jax_elbo(
        x, logits, mu, logvar, recon_loss=model.recon_loss,
        mse_use_sigmoid=model.mse_use_sigmoid, topology=model.topology,
        beta=1.0, mask=mask, free_bits=model.free_bits,
        capacity_max=model.capacity_max,
        capacity_anneal_steps=model.capacity_anneal_steps,
        capacity_mode=model.capacity_mode, step=0,
        spatial_free_bits=model.spatial_free_bits)
    return total, (logits, mu, logvar, new["batch_stats"])


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_train_forward_grads_and_batchnorm_match_jax(topology):
    model, variables, cfg = _setup(topology)
    port = _port(variables, cfg).train()
    assert all(isinstance(m, BatchNorm) for m in port.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    x, mask = _batch()
    (total, (logits, mu, logvar, new_stats)), grads = jax.value_and_grad(
        _jax_loss, argnums=1, has_aux=True)(
        model, variables["params"], variables["batch_stats"], x, mask)

    p_logits, p_mu, p_logvar, p_z = port(torch.from_numpy(x))
    p_total, _, _ = port.loss(torch.from_numpy(x), p_logits, p_mu, p_logvar,
                              beta=1.0, mask=torch.from_numpy(mask), step=0)
    p_total.backward()
    assert p_z is p_mu  # no generator: z = mu
    for got, want in ((p_logits, logits), (p_mu, mu), (p_logvar, logvar)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p_total.item(), float(total), rtol=1e-5)

    want_g = vae_state_dict_from_jax(
        {"params": _np_tree(grads), "batch_stats": variables["batch_stats"]},
        topology, ENC, DEC)
    named = dict(port.named_parameters())
    assert set(named) <= set(want_g)
    # a conv bias that feeds a BatchNorm has a true gradient of 0 (the norm
    # removes per-channel constants): both sides hold rounding residue there
    pre_norm = {k.rsplit(".", 2)[0] + f".{int(k.rsplit('.', 2)[1]) - 1}.bias"
                for k in named if k.endswith(".weight")
                and isinstance(port.get_submodule(k[:-len(".weight")]),
                               BatchNorm)}
    for key, p in named.items():
        if key in pre_norm:
            scale = named[key[:-len("bias")] + "weight"].grad.abs().max()
            assert p.grad.abs().max() <= 1e-4 * scale, key
            assert np.abs(want_g[key].numpy()).max() <= 1e-4 * scale, key
            continue
        want = want_g[key].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=key)
    assert len(pre_norm) == 5

    want_s = vae_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": _np_tree(new_stats)},
        topology, ENC, DEC)
    bufs = dict(port.named_buffers())
    n_stats = 0
    for key, val in want_s.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(bufs[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
            n_stats += 1
    assert n_stats == 2 * 5  # three encoder and two decoder norms


def _loss_inputs(topology, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((6, 28, 28, 1), dtype=np.float32)
    logits = rng.normal(0, 2, x.shape).astype(np.float32)
    shape = (6, 4, 4, 5) if topology == "spatial" else (6, 5)
    mu = rng.normal(0, 1, shape).astype(np.float32)
    logvar = rng.normal(-0.5, 0.8, shape).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return x, logits, mu, logvar, mask


@pytest.mark.parametrize("kw", [
    dict(topology="spatial", recon_loss="mse", mse_use_sigmoid=True),
    dict(topology="spatial", recon_loss="mse", mse_use_sigmoid=False),
    dict(topology="spatial", recon_loss="bce", mse_use_sigmoid=True),
    dict(topology="spatial", recon_loss="mse", mse_use_sigmoid=True,
         spatial_free_bits=0.25),
    dict(topology="flat", recon_loss="bce", mse_use_sigmoid=True,
         free_bits=0.5),
    dict(topology="flat", recon_loss="mse", mse_use_sigmoid=True,
         free_bits=None, capacity_max=15.0, capacity_anneal_steps=100,
         capacity_mode="abs", step=40),
    dict(topology="flat", recon_loss="mse", mse_use_sigmoid=False,
         free_bits=0.5, capacity_max=15.0, capacity_anneal_steps=100,
         capacity_mode="clipped", step=250),
    dict(topology="flat", recon_loss="bce", mse_use_sigmoid=True,
         free_bits=0.5, capacity_max=2.0, capacity_anneal_steps=10,
         capacity_mode="clipped", step=3),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
@pytest.mark.parametrize("masked", [True, False])
def test_elbo_loss_matches_jax_on_every_branch(kw, masked):
    x, logits, mu, logvar, mask = _loss_inputs(kw["topology"])
    mask_j = mask if masked else None
    ref = jax_elbo(x, logits, mu, logvar, beta=0.7, mask=mask_j, **kw)
    got = elbo_loss(*(torch.from_numpy(a) for a in (x, logits, mu, logvar)),
                    beta=0.7, mask=torch.from_numpy(mask) if masked else None,
                    **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5)


@pytest.mark.parametrize("optimizer,clip,cosine", [("adamw", 1.0, 3),
                                                   ("adam", 0.0, None)])
def test_three_optimizer_steps_match_optax(optimizer, clip, cosine):
    model, variables, cfg = _setup("spatial")
    port = _port(variables, cfg)
    lr, wd = 3e-3, 0.01
    tx = jax_make_optimizer(lr, wd, optimizer, clip, cosine, 1)
    params = variables["params"]
    opt_state = tx.init(params)
    popt = make_optimizer(port.parameters(), lr, wd, optimizer, clip,
                          cosine, 1)
    named = dict(port.named_parameters())
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = _np_tree(optax.apply_updates(params, updates))
        g_sd = vae_state_dict_from_jax(
            {"params": grads, "batch_stats": variables["batch_stats"]},
            "spatial", ENC, DEC)
        for key, p in named.items():
            p.grad = g_sd[key].clone()
        popt.step()
    want = vae_state_dict_from_jax(
        {"params": params, "batch_stats": variables["batch_stats"]},
        "spatial", ENC, DEC)
    for key, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert popt.count == 3


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_init_matches_flax_distributions_at_preset_width(topology):
    enc, dec = (64, 128, 256), (256, 128, 64)
    _, variables, cfg = _setup(topology, enc, dec, 16, seed=0)
    want = vae_state_dict_from_jax(variables, topology, enc, dec)
    port = flax_init_(build_vae(cfg), torch.Generator().manual_seed(0))
    got = port.state_dict()
    n_weights = 0
    for key, val in want.items():
        if key.endswith(".weight") and val.ndim >= 2:
            ratio = got[key].std().item() / val.std().item()
            assert abs(ratio - 1.0) < 0.1, (key, ratio)
            bound = 2.0 * val.std().item() / 0.8796 * 1.05
            assert got[key].abs().max().item() <= bound, key  # truncated
            n_weights += 1
        elif key.endswith(".bias") or key.endswith(".weight"):
            torch.testing.assert_close(got[key], val)  # zeros / ones
    assert n_weights == 9  # 3 convs + 2 heads; 4 decoder layers


def test_dump_latents_match_jax(tmp_path):
    model, variables, cfg = _setup("spatial", latent=4)
    rng = np.random.RandomState(0)  # non-trivial running statistics
    for side in variables["batch_stats"].values():
        for st in side.values():
            st["mean"] = rng.uniform(-0.5, 0.5, st["mean"].shape).astype(
                np.float32)
            st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(
                np.float32)
    jtr, _ = jax_loaders("FashionMNIST", batch_size=64, synthetic_size=256,
                         seed=0)
    ptr, _ = get_data_loaders("FashionMNIST", batch_size=64,
                              synthetic_size=256, seed=0)
    jeng = JaxEngine(model, lr=1e-3, seed=0)
    state = jeng.init_state(jtr.split.images[:1]).replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    ref = np.load(jeng.dump_latents(state, jtr, tmp_path / "jax"))
    peng = VAEEngine(_port(variables, {**cfg, "latent_dim": 4}), lr=1e-3,
                     seed=0, device="cpu")
    got = np.load(peng.dump_latents(ptr, tmp_path / "port"))
    assert got["z"].shape == ref["z"].shape == (256, 4, 4, 4)
    np.testing.assert_allclose(got["mu"], ref["mu"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["logvar"], ref["logvar"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["y"], ref["y"])
    assert bytes(got["layout"]) == b"NHWC"
    eps = (got["z"] - got["mu"]) / np.exp(0.5 * got["logvar"])
    assert abs(eps.mean()) < 0.03 and abs(eps.std() - 1.0) < 0.03


def _vae_yaml(tmp_path, name, **over):
    cfg = {
        "seed": 42, "max_epochs": 3, "lr": 1e-3, "weight_decay": 1e-5,
        "early_stop": 0, "kl_anneal_epochs": 0, "optimizer": "adamw",
        "scheduler": {"name": "cosine", "t_max": 200},
        "grad_clip_max_norm": 1.0, "out_dir": str(tmp_path / name / "vae"),
        "save_latents": True, "run_name": "spatial_vae_fashionmnist",
        "data": {"root": str(tmp_path / "no-data"), "name": "FashionMNIST",
                 "batch_size": 64, "augment": False, "synthetic_size": 512},
        "model": {"in_channels": 1, "output_image_size": 28,
                  "latent_dim": 4, "enc_channels": list(ENC),
                  "dec_channels": list(DEC), "recon_loss": "mse",
                  "beta": 1.0, "norm_type": "batch", "mse_use_sigmoid": True,
                  "topology": "spatial"},
    }
    cfg.update(over)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _last_val_loss(run_dir):
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    return rows[-1]["val_loss"], rows


def test_short_training_curve_matches_jax(tmp_path, monkeypatch):
    jax_out = jax_train_vae_main(jax_load_config(_vae_yaml(tmp_path, "jax")))
    # the JAX stage's own init, carried across as the port's init
    jtr, _ = jax_loaders("FashionMNIST", root=str(tmp_path / "no-data"),
                         batch_size=64, synthetic_size=512, seed=42)
    model = JaxVAE(in_channels=1, output_image_size=28, latent_dim=4,
                   enc_channels=ENC, dec_channels=DEC, recon_loss="mse",
                   norm_type="batch", mse_use_sigmoid=True,
                   topology="spatial")
    state = JaxEngine(model, lr=1e-3, seed=42).init_state(
        jtr.split.images[:1])
    sd = vae_state_dict_from_jax(
        {"params": _np_tree(state.params),
         "batch_stats": _np_tree(state.batch_stats)}, "spatial", ENC, DEC)
    monkeypatch.setattr(VAEEngine, "init_state",
                        lambda self: load_vae_state_dict(self.model, sd))
    out = train_vae_main(load_config(_vae_yaml(tmp_path, "port")),
                         device="cpu")
    assert out.name == jax_out.name == "spatial_vae_fashionmnist"

    ref_loss, _ = _last_val_loss(jax_out)
    loss, rows = _last_val_loss(out)
    assert abs(loss - ref_loss) <= 0.15 * abs(ref_loss), (loss, ref_loss)
    assert len(rows) == 3 and rows[-1]["train_steps"] == 8
    for name in ("latents_train", "latents_val", "recon_grid.png",
                 "metrics.csv", "params.yaml"):
        assert (out / name).exists(), name
    assert (out / "recon_grid.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"

    best = read_checkpoint(out / "checkpoints" / "best")  # JAX-style name
    assert set(best) == {"model_state_dict", "epoch"}
    latest = read_checkpoint(out / "checkpoints" / "latest.pt")
    assert latest["step"] == 24 and latest["epoch"] == 3
    assert {"model_state_dict", "optimizer_state_dict"} <= set(latest)

    # resume continues from latest.pt: step and optimizer state carry on
    train_vae_main(load_config(_vae_yaml(tmp_path, "port", max_epochs=1,
                                         resume=True)), device="cpu")
    latest = read_checkpoint(out / "checkpoints" / "latest.pt")
    assert latest["step"] == 32
    assert latest["optimizer_state_dict"]["count"] == 32
