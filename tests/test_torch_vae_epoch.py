"""Port parity: the VAE stage's device-resident epoch path
(``VAEEngine.train_epoch`` / ``eval_epoch``) against JAX's
``_build_epoch_fns``, which every preset takes (``data.augment: false``).

A spatial model at small widths, 28 px, 20 images in batches of 8: the
split pads to 24 rows, and the permutation (drawn once with numpy and
carried to both sides) puts padding rows inside a middle batch, where they
enter the BatchNorm statistics on both sides. The noise is taken out on
both sides (``reparameterize`` returns mu), AdamW with clipping and the
cosine schedule.

- parameters after the epoch within rtol 1e-4, or 2e-5 of the tensor's
  largest value (the gradient tests' limit). Adam divides each step by
  sqrt(v), so an element whose gradient sits near the f32 residue can
  step differently by up to the learning rate: at most 0.1 % of a tensor
  (or one element) may leave that limit, and every element stays within
  2 * steps * lr (the NaN case has one such element). The conv biases
  that feed a BatchNorm have a true gradient of 0, so all their steps are
  such residue: they are held to the learning-rate bound only;
- the epoch's mean (loss, recon, kl) within rtol 1e-5; the eval sums
  within rtol 1e-5 from the same state (JAX's after the epoch): in eval
  mode those pre-norm biases no longer cancel against the running mean,
  so from the port's own post-epoch state the KL sum leaves that limit;
- a NaN pixel in the second batch: the loss of that step is not finite,
  its gradients become zeros on both sides and AdamW still steps; the
  parameters and both Adam moments stay finite and equal JAX's (the
  BatchNorm running statistics take that batch's NaN statistics on both
  sides, as JAX replaces them every step, and are left out);
- ``train`` takes the epoch path without augmentation and the per-batch
  path with it.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vqvae_tpu.models.vae as jax_vae_mod
import vqvae_tpu_torch.models.vae as vae_mod
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.train import VAEEngine as JaxEngine
from vqvae_tpu_torch.data import get_data_loaders
from vqvae_tpu_torch.train import VAEEngine
from vqvae_tpu_torch.utils.checkpoint import (build_vae, load_vae_state_dict,
                                              vae_state_dict_from_jax)

ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 6
N, BS, LR, WD, CLIP = 20, 8, 1e-3, 1e-4, 1.0
CFG = dict(in_channels=1, enc_channels=ENC, dec_channels=DEC,
           latent_dim=LATENT, recon_loss="mse", output_image_size=28,
           norm_type="batch", topology="spatial")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jax_vae_mod, "reparameterize",
                        lambda rng, mu, logvar: mu)
    monkeypatch.setattr(vae_mod, "reparameterize",
                        lambda mu, logvar, generator, rows=None: mu)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _sd(params, stats):
    return vae_state_dict_from_jax({"params": _np_tree(params),
                                    "batch_stats": _np_tree(stats)},
                                   "spatial", ENC, DEC)


def _images(nan_row=None):
    x = np.random.default_rng(0).random((N, 28, 28, 1), dtype=np.float32)
    if nan_row is not None:
        x[nan_row, 5, 7, 0] = np.nan
    return x


def _perm():
    perm = np.random.default_rng(1).permutation(24)
    # a padding row (index >= 20) inside the middle batch
    assert (perm[8:16] >= N).any()
    return perm


def _run(x, perm):
    loader = SimpleNamespace(split=SimpleNamespace(images=x))
    model = JaxVAE(**CFG)
    jeng = JaxEngine(model, lr=LR, weight_decay=WD, grad_clip_max_norm=CLIP,
                     cosine_t_max=3, steps_per_epoch=3, seed=0)
    state = jeng.init_state(x[:1])
    sd0 = _sd(state.params, state.batch_stats)
    train_fn, eval_fn = jeng._build_epoch_fns(BS)
    data, mask, steps, n_pad = jeng._device_dataset(loader, BS)
    state, tr = train_fn(state, data, mask, jnp.asarray(perm),
                         jax.random.key(1), jnp.float32(1.0), n_steps=steps)
    va = eval_fn(state, data, mask, jnp.arange(n_pad), jax.random.key(1),
                 jnp.float32(1.0), n_steps=steps)

    eng = VAEEngine(load_vae_state_dict(build_vae(CFG), sd0), lr=LR,
                    weight_decay=WD, grad_clip_max_norm=CLIP,
                    cosine_t_max=3, steps_per_epoch=3, seed=0, device="cpu")
    pdata, pmask, psteps, ppad = eng.device_dataset(loader, BS)
    assert (psteps, ppad) == (steps, n_pad) == (3, 24)
    gen = torch.Generator().manual_seed(0)
    ptr = eng.train_epoch(pdata, pmask, torch.from_numpy(perm), 1.0, psteps,
                          BS, gen)
    # evaluation from JAX's state after the epoch (see the module notes)
    ev = VAEEngine(load_vae_state_dict(build_vae(CFG), _sd(
        state.params, state.batch_stats)), lr=LR, seed=0, device="cpu")
    pva = ev.eval_epoch(pdata, pmask, 1.0, psteps, BS, gen)
    return state, np.asarray(tr), np.asarray(va), eng, ptr.numpy(), \
        pva.numpy()


def _pre_norm_biases(eng):
    named = dict(eng.model.named_parameters())
    out = set()
    for key in named:
        if key.endswith(".weight") and isinstance(
                eng.model.get_submodule(key[:-len(".weight")]),
                vae_mod.BatchNorm):
            head, idx, _ = key.rsplit(".", 2)
            out.add(f"{head}.{int(idx) - 1}.bias")
    assert len(out) == 5
    return out


def _check_params(eng, state, steps=3):
    want = _sd(state.params, state.batch_stats)
    skip = _pre_norm_biases(eng)
    for key, p in eng.model.named_parameters():
        got, ref = p.detach().numpy(), want[key].numpy()
        assert np.isfinite(got).all(), key
        if key in skip:  # Adam steps on rounding residue: |step| <= lr
            assert np.abs(got - ref).max() <= 2 * steps * LR * 1.01, key
            continue
        # Adam divides by sqrt(v): an element whose gradient sits near the
        # f32 residue can step differently by up to the learning rate
        loose = np.abs(got - ref) > 1e-4 * np.abs(ref) + 2e-5 * np.abs(
            ref).max()
        assert loose.sum() <= max(1, 1e-3 * ref.size), (key, loose.sum())
        assert (np.abs(got - ref) <= 2 * steps * LR).all(), key


def _adam_moments(state):
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return adam[0]


def test_epoch_matches_jax_epoch_fns(no_noise):
    state, tr, va, eng, ptr, pva = _run(_images(), _perm())
    _check_params(eng, state)
    np.testing.assert_allclose(ptr, tr, rtol=1e-5)
    np.testing.assert_allclose(pva, va, rtol=1e-5)
    assert pva[-1] == N  # every real row counted once
    assert eng.opt.count == eng.step == 3


def test_nan_batch_keeps_parameters_finite_and_equal_to_jax(no_noise):
    perm = _perm()
    state, tr, _, eng, ptr, _ = _run(_images(nan_row=int(perm[9])), perm)
    # the guarded step's loss is NaN on both sides and enters the mean
    assert not np.isfinite(tr[0]) and not np.isfinite(ptr[0])
    _check_params(eng, state)
    adam = _adam_moments(state)
    assert int(np.asarray(adam.count)) == eng.opt.count == 3
    skip = _pre_norm_biases(eng)
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = _sd(tree, state.batch_stats)
        for key, p in eng.model.named_parameters():
            got = eng.opt.opt.state[p][name].numpy()
            ref = want[key].numpy()
            assert np.isfinite(got).all(), (name, key)
            if key in skip:
                continue
            np.testing.assert_allclose(got, ref, rtol=1e-3,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("augment", [False, True])
def test_train_dispatches_on_augment(augment, monkeypatch):
    tr, va = get_data_loaders("FashionMNIST", batch_size=16,
                              synthetic_size=48, augment=augment, seed=0)
    assert tr.augment is augment
    eng = VAEEngine(build_vae({**CFG, "latent_dim": 2}), lr=LR, seed=0,
                    device="cpu")
    calls = []
    for name in ("train_epoch", "run_epoch"):
        fn = getattr(eng, name)
        monkeypatch.setattr(eng, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    eng.train(tr, va, num_epochs=1, save_latents_flag=False)
    assert calls == (["run_epoch", "run_epoch"] if augment
                     else ["train_epoch"])
    assert eng.step == 3


def test_cli_trains_bf16_and_refuses_non_floating(tmp_path):
    """``model.dtype: bfloat16`` through ``train_vae_main`` on the epoch
    path: finite losses, float32 checkpoints; a non-floating dtype is
    refused."""
    import json

    import yaml

    from vqvae_tpu_torch.cli.train_vae import train_vae_main
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.utils.checkpoint import read_checkpoint

    cfg = {
        "seed": 0, "max_epochs": 1, "lr": 1e-3, "out_dir": str(tmp_path),
        "save_latents": False, "data": {
            "root": str(tmp_path / "no-data"), "name": "FashionMNIST",
            "batch_size": 16, "augment": False, "synthetic_size": 40},
        "model": {**{k: list(v) if isinstance(v, tuple) else v
                     for k, v in CFG.items()}, "dtype": "bfloat16"},
    }
    path = tmp_path / "vae.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = train_vae_main(load_config(path), device="cpu")
    row = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    assert row["train_steps"] == 3
    best = read_checkpoint(out / "checkpoints" / "best.pt")
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in best["model_state_dict"].values())
    with pytest.raises(ValueError, match="model.dtype"):
        train_vae_main(load_config(path, {"model": {"dtype": "int32"}}),
                       device="cpu")
