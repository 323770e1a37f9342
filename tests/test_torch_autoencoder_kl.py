"""FLUX.1's KL autoencoder in the port (``models/autoencoder_kl.py``) on the
CPU, against the benchmark's plain reference
(``portbench/reference/autoencoder_kl.py``) on seeded weights:

- at a small size (widths 32 and 64, 32 groups, 32-px images, batch 2):
  the forward (mean, log-variance, output), the loss and every gradient;
- at the published widths: the parameter count, diffusers' state-dict
  names and shapes, and one forward of a 32 x 32 image;
- the log-variance clamp, the engine's initialization and evaluation in
  [0, 1], ``elbo_loss``'s ``l1`` branch against a hand sum, the
  ``synthetic_rgb`` split;
- the VAE stage's CLI with ``model.arch: autoencoder_kl`` for one epoch
  (checkpoints, latents, the reconstruction grid);
- the spans ``vqvae.kl.encode``, ``vqvae.kl.decode`` and
  ``vqvae.kl.attention`` and the counter ``vqvae.kl.attention_tokens``
  under a profiler session: 2 x batch x grid^2 tokens a training step.
"""
import json
import math
from collections import Counter

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from portbench.reference import autoencoder_kl as ref
from vqvae_tpu_torch.cli.train_vae import train_vae_main
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.data import load_dataset
from vqvae_tpu_torch.models import AutoencoderKL, elbo_loss
from vqvae_tpu_torch.models import autoencoder_kl as kl
from vqvae_tpu_torch.train.vae_engine import VAEEngine, seeded_generator
from vqvae_tpu_torch.utils import profiling
from vqvae_tpu_torch.utils.checkpoint import read_checkpoint

PUBLISHED = {"in_channels": 3, "out_channels": 3,
             "block_out_channels": [128, 256, 512, 512],
             "layers_per_block": 2, "latent_channels": 16,
             "norm_num_groups": 32}
SMALL = {**PUBLISHED, "block_out_channels": [32, 64], "latent_channels": 4}
KL_WEIGHT = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, side=32):
    return {**arch, "data": {"image_shape": [side, side, 3]},
            "vae_train": {"kl_weight": KL_WEIGHT}}


def _model(arch, seed=0):
    """The program with the reference's seeded weights: (model, state)."""
    state = ref.initial_state(_cfg(arch), seed, 3, "cpu")
    model = AutoencoderKL(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in arch.items()})
    model.load_state_dict(state)
    return model, state


def _images(n, side=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, side, side, 3), generator=g) * 2 - 1


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm())


def test_small_model_matches_the_reference_forward_loss_and_gradients():
    cfg = _cfg(SMALL)
    model, state = _model(SMALL)
    x, mask = _images(2), torch.tensor([1.0, 1.0])
    mu, logvar = model.encode(x)
    r_mu, r_lv = ref.encode(cfg, state, x)
    assert mu.shape == (2, 16, 16, 4) and _rel(mu, r_mu) < 1e-5
    assert _rel(logvar, r_lv) < 1e-5
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2))
    z = mu + eps * torch.exp(0.5 * logvar)
    assert _rel(model.decode(z), ref.decode(cfg, state, z)) < 1e-5

    # the training step: the program's forward with a generator draws eps
    gen = torch.Generator().manual_seed(2)
    x_hat, mu, logvar, _ = model(x, gen)
    loss, _, _ = model.loss(x, x_hat, mu, logvar, beta=KL_WEIGHT, mask=mask)
    loss.backward()
    params = {k: v.clone().requires_grad_() for k, v in state.items()}
    r_loss, r_grads = ref.gradients(cfg, params, x, mask, eps, chunk=1)
    loss = float(loss.detach())
    assert abs(loss - float(r_loss)) < 1e-6 * abs(float(r_loss))
    got = dict(model.named_parameters())
    assert set(got) == set(r_grads)
    norms = sorted(float(g.norm()) for g in r_grads.values())
    floor = norms[len(norms) // 2]
    for k, g in r_grads.items():
        # relative to the larger of the leaf's norm and the median leaf's
        # (the k projections' biases have a gradient of rounding alone:
        # softmax ignores a shift shared by every key)
        gap = float((got[k].grad - g).norm()) / max(float(g.norm()), floor)
        assert gap < 3e-5, k


def test_published_widths_names_shapes_and_a_forward():
    cfg = _cfg(PUBLISHED)
    model, state = _model(PUBLISHED, seed=5)
    assert sum(p.numel() for p in model.parameters()) == 83_819_683
    sd = model.state_dict()
    assert set(sd) == set(state)
    for name, shape in {
            "encoder.conv_out.weight": (32, 512, 3, 3),
            "decoder.conv_in.weight": (512, 16, 3, 3),
            "encoder.down_blocks.0.resnets.0.norm1.weight": (128,),
            "encoder.mid_block.attentions.0.to_q.weight": (512, 512),
            "decoder.up_blocks.0.upsamplers.0.conv.weight": (512, 512, 3, 3),
            "encoder.down_blocks.1.resnets.0.conv_shortcut.weight":
                (256, 128, 1, 1),
            "decoder.up_blocks.3.resnets.2.conv2.weight": (128, 128, 3, 3),
            "decoder.mid_block.attentions.0.to_out.0.bias": (512,)}.items():
        assert tuple(sd[name].shape) == shape, name
    assert "encoder.down_blocks.3.downsamplers.0.conv.weight" not in sd
    assert "decoder.up_blocks.3.upsamplers.0.conv.weight" not in sd
    x = _images(1)
    with torch.no_grad():
        x_hat, mu, logvar, _ = model(x)
        r_mu, r_lv = ref.encode(cfg, state, x)
        r_hat = ref.decode(cfg, state, r_mu)
    assert mu.shape == (1, 4, 4, 16) and x_hat.shape == (1, 32, 32, 3)
    assert _rel(mu, r_mu) < 1e-5 and _rel(logvar, r_lv) < 1e-5
    assert _rel(x_hat, r_hat) < 1e-5


def test_the_log_variance_is_clamped():
    model, state = _model(SMALL)
    with torch.no_grad():
        model.encoder.conv_out.bias[4:] = 45.0  # the log-variance half
        _, logvar = model.encode(_images(1))
    assert float(logvar.min()) == kl.LOGVAR_RANGE[1]


def test_l1_elbo_is_the_hand_sum():
    g = torch.Generator().manual_seed(0)
    x, x_hat = torch.randn(3, 4, 4, 3, generator=g), torch.randn(
        3, 4, 4, 3, generator=g)
    mu, logvar = torch.randn(3, 2, 2, 5, generator=g), torch.randn(
        3, 2, 2, 5, generator=g)
    mask = torch.tensor([1.0, 1.0, 0.0])
    total, recon, kld = elbo_loss(x, x_hat, mu, logvar, recon_loss="l1",
                                  mse_use_sigmoid=False, topology="spatial",
                                  beta=0.5, mask=mask)
    want_recon = sum(float((x_hat[i] - x[i]).abs().sum()) for i in (0, 1)) / 2
    want_kl = sum(float(0.5 * (mu[i] ** 2 + logvar[i].exp() - 1
                               - logvar[i]).sum()) for i in (0, 1)) / 2
    assert float(recon) == pytest.approx(want_recon, rel=1e-6)
    assert float(kld) == pytest.approx(want_kl, rel=1e-6)
    assert float(total) == pytest.approx(want_recon + 0.5 * want_kl,
                                         rel=1e-6)


def test_engine_draws_pytorchs_defaults_and_evaluates_in_unit_range():
    arch = {k: tuple(v) if isinstance(v, list) else v
            for k, v in SMALL.items()}
    engines = [VAEEngine(AutoencoderKL(**arch), lr=1e-4, device="cpu",
                         seed=7) for _ in range(2)]
    for eng in engines:
        eng.init_state()
    a, b = (dict(e.model.named_parameters()) for e in engines)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["encoder.down_blocks.1.resnets.0.conv1.weight"].detach()  # 32 x 9
    bound = 1 / math.sqrt(32 * 9)
    assert float(w.abs().max()) <= bound and float(w.std()) == pytest.approx(
        bound / math.sqrt(3), rel=0.05)
    assert torch.equal(a["encoder.conv_norm_out.weight"], torch.ones(64))

    eng = engines[0]
    x, mask = _images(2), torch.ones(2)
    out = eng.eval_step(x, mask, KL_WEIGHT, seeded_generator("cpu", 1))
    with torch.no_grad():
        x_hat, *_ = eng.model(x, seeded_generator("cpu", 1))
    rec = torch.clamp((x_hat + 1) / 2, 0, 1)
    mse = float(((rec - (x + 1) / 2) ** 2).mean())
    assert float(out["psnr"]) == pytest.approx(10 * math.log10(1 / mse),
                                               rel=1e-5)


def test_synthetic_rgb_split():
    split = load_dataset("synthetic_rgb", root="no-such-dir", train=False,
                         synthetic_size=5, image_size=48)
    assert split.images.shape == (5, 48, 48, 3) and split.signed
    assert split.images.min() >= -1.0 and split.images.max() <= 1.0
    assert split.images.min() < -0.5 < 0.5 < split.images.max()
    shown = split.denormalize(split.images)
    assert shown.min() >= 0.0 and shown.max() <= 1.0


def _cli_cfg(tmp_path, **model):
    cfg = {"seed": 0, "max_epochs": 1, "lr": 1e-4, "out_dir": str(tmp_path),
           "data": {"name": "synthetic_rgb", "image_size": 32,
                    "batch_size": 4, "synthetic_size": 8},
           "model": {"arch": "autoencoder_kl", "block_out_channels": [32, 64],
                     "latent_channels": 4, "beta": KL_WEIGHT, **model}}
    path = tmp_path / "vae.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(path)


def test_cli_trains_the_kl_autoencoder(tmp_path):
    out = train_vae_main(_cli_cfg(tmp_path), device="cpu")
    row = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])
    assert row["train_steps"] == 2 and np.isfinite(row["val_loss"])
    for name in ("best.pt", "latest.pt"):
        sd = read_checkpoint(out / "checkpoints" / name)["model_state_dict"]
        AutoencoderKL(block_out_channels=(32, 64),
                      latent_channels=4).load_state_dict(sd)
    lat = np.load(out / "latents_train" / "latents.npz")
    assert lat["z"].shape == (8, 16, 16, 4)
    assert (out / "latents_val" / "latents.npz").exists()
    assert (out / "recon_grid.png").exists()
    with pytest.raises(ValueError, match="float32"):
        train_vae_main(_cli_cfg(tmp_path, dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="model.arch"):
        train_vae_main(_cli_cfg(tmp_path, arch="unet"), device="cpu")


def test_spans_and_the_attention_counter():
    model, _ = _model(SMALL)
    eng = VAEEngine(model, lr=1e-4, device="cpu", steps_per_epoch=2)
    batch, steps = 2, 2
    x, mask = _images(batch * steps), torch.ones(batch * steps)
    perm = torch.arange(batch * steps)
    gen = seeded_generator("cpu", 0)
    profiling.reset_spans()
    eng.train_epoch(x, mask, perm, KL_WEIGHT, steps, batch, gen)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        eng.train_epoch(x, mask, perm, KL_WEIGHT, steps, batch, gen)
    rows = profiling.spans()
    profiling.reset_spans()
    spans = Counter(r.name for r in rows if r.count is None)
    assert spans["vqvae.kl.encode"] == spans["vqvae.kl.decode"] == steps
    assert spans["vqvae.kl.attention"] == 2 * steps
    counts = [r for r in rows if r.name == "vqvae.kl.attention_tokens"]
    assert {r.parent for r in counts} == {"vqvae.kl.attention"}
    grid = 16  # 32 px over one down sampler
    assert sum(r.count for r in counts) == steps * 2 * batch * grid * grid
    parents = Counter((r.name, r.parent) for r in rows if r.count is None)
    assert parents[("vqvae.kl.attention", "vqvae.kl.encode")] == steps
    assert parents[("vqvae.kl.attention", "vqvae.kl.decode")] == steps
    assert parents[("vqvae.kl.encode", "vqvae.vae.forward")] == steps
