"""Port parity: the transformer prior (``models/transformer.py``), its loss,
one train step, AdamW over three steps, the KV-cache decode step and the
carry-across of flax's params.

The JAX model's params cross through ``transformer_state_dict_from_jax``;
the mapping is linear, so it carries gradients across too. Small width:
embed 32, 2 layers, 4 heads, vocab 64, max_seq_len 16, 10 classes,
dropout 0 (dropout masks cannot match across RNGs), a batch of 6 rows of
15 tokens whose last 2 rows are padding (mask 0).

Tolerances:
- logits: |port - JAX| <= 1e-5 |JAX| + 1e-6 (measured at most 1.5e-7
  absolute on logits up to 0.43; the 1e-6 floor covers logits near 0,
  where a relative bound alone cannot hold);
- loss: rtol 1e-6 on the same logits, rtol 1e-5 through the model;
- gradients: rtol 1e-4, or 2e-5 of the tensor's largest gradient (the VAE
  port's standard); the attention key biases have a true gradient of 0
  and are checked to be ~0 on both sides;
- parameters after 3 AdamW + clip + weight decay + cosine steps on the
  same gradients as optax: rtol 1e-5, atol 1e-7;
- KV-cache logits against flax's ``decode=True`` logits: as the logits;
- init: each weight tensor's std within 10 % of flax's at the preset's
  width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae_tpu.models import Transformer as JaxTransformer
from vqvae_tpu.models.transformer import cross_entropy_loss as jax_ce
from vqvae_tpu.train.state import make_optimizer as jax_make_optimizer
from vqvae_tpu_torch.models.transformer import (Transformer,
                                                cross_entropy_loss,
                                                transformer_init_)
from vqvae_tpu_torch.train import make_optimizer
from vqvae_tpu_torch.utils.checkpoint import transformer_state_dict_from_jax

CFG = dict(num_classes=10, num_tokens=64, embed_dim=32, n_layers=2,
           n_head=4, max_seq_len=16, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are tiny, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _setup(cfg=CFG, seed=1):
    model = JaxTransformer(**cfg)
    x = np.zeros((2, cfg["max_seq_len"] - 1), np.int32)
    y = np.zeros(2, np.int32) if cfg["num_classes"] else None
    params = _np_tree(jax.jit(lambda key: model.init({"params": key}, x, y=y))(
        jax.random.key(seed))["params"])
    port = Transformer(**cfg)
    port.load_state_dict(transformer_state_dict_from_jax(params))
    return model, params, port


def _batch(cfg=CFG, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg["num_tokens"], (6, 15)).astype(np.int32)
    t = rng.integers(0, cfg["num_tokens"], (6, 15)).astype(np.int32)
    y = rng.integers(0, max(cfg["num_classes"], 1), 6).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return x, t, y, mask


def _assert_logits(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("classes,labels", [(10, True), (10, False),
                                            (0, False)],
                         ids=["conditioned", "labels-none", "unconditioned"])
def test_logits_match_jax(classes, labels):
    cfg = {**CFG, "num_classes": classes}
    model, params, port = _setup(cfg)
    x, _, y, _ = _batch(cfg)
    y_j = y if labels else None
    want = jax.jit(model.apply)({"params": params}, x, y=y_j)
    got = port.eval()(torch.from_numpy(x).long(),
                      y=torch.from_numpy(y).long() if labels else None)
    assert got.shape == (6, 15, cfg["num_tokens"])
    _assert_logits(got, want)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [True, False])
def test_loss_matches_jax(smoothing, masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (6, 15, 64)).astype(np.float32)
    targets = rng.integers(0, 64, (6, 15)).astype(np.int32)
    mask = np.array([1, 1, 1, 0, 1, 0], np.float32) if masked else None
    want = jax_ce(logits, targets, mask=mask, label_smoothing=smoothing)
    got = cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        mask=torch.from_numpy(mask) if masked else None,
        label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_all_masked_batch_gives_zero_loss():
    logits = torch.randn(2, 3, 8)
    loss = cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.long),
                              mask=torch.zeros(2), label_smoothing=0.1)
    assert loss.item() == 0.0  # the sum over max(weights, 1)


def _jax_loss(model, params, x, t, y, mask, smoothing):
    logits = model.apply({"params": params}, x, y=y, train=True,
                         rngs={"dropout": jax.random.key(0)})
    return jax_ce(logits, t, mask=mask, label_smoothing=smoothing)


def test_train_step_gradients_match_jax():
    model, params, port = _setup()
    x, t, y, mask = _batch()
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss, argnums=1),
                          static_argnums=(0, 6))(model, params, x, t, y,
                                                 mask, 0.1)
    port.train()
    p_loss = cross_entropy_loss(
        port(torch.from_numpy(x).long(), y=torch.from_numpy(y).long(),
             generator=torch.Generator().manual_seed(0)),
        torch.from_numpy(t), mask=torch.from_numpy(mask),
        label_smoothing=0.1)
    p_loss.backward()
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-5)
    want = transformer_state_dict_from_jax(_np_tree(grads))
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    n_key_bias = 0
    for key, p in named.items():
        w = want[key].numpy()
        if key.endswith("attn.key.bias"):
            # the softmax over keys ignores a constant added to every key's
            # logit, so this bias has a true gradient of 0: both sides
            # hold rounding residue
            scale = named[key[:-len("bias")] + "weight"].grad.abs().max()
            assert p.grad.abs().max() <= 1e-6 * scale, key
            assert np.abs(w).max() <= 1e-6 * scale, key
            n_key_bias += 1
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=key)
    assert n_key_bias == CFG["n_layers"]
    # padded rows and unused classes take no gradient on either side
    assert np.abs(want["class_emb.weight"].numpy()[
        np.setdiff1d(np.arange(10), y[:4])]).max() == 0.0


def test_three_adamw_steps_match_optax():
    model, params, port = _setup()
    lr, wd, clip = 3e-3, 0.01, 1.0
    tx = jax_make_optimizer(lr, wd, "adamw", clip, 3, 1)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    popt = make_optimizer(port.parameters(), lr, wd, "adamw", clip, 3, 1)
    named = dict(port.named_parameters())
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = _np_tree(optax.apply_updates(params, updates))
        g_sd = transformer_state_dict_from_jax(grads)
        for key, p in named.items():
            p.grad = g_sd[key].clone()
        popt.step()
    want = transformer_state_dict_from_jax(params)
    for key, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert popt.count == 3


@pytest.mark.parametrize("labels", [True, False])
def test_kv_cache_step_matches_jax_decode(labels):
    model, params, port = _setup()
    x, _, y, _ = _batch()
    y_j = y if labels else None
    y_t = torch.from_numpy(y).long() if labels else None
    cache = model.init_cache(x.shape[0])
    step = jax.jit(lambda c, tok, i: model.apply(
        {"params": params, "cache": c}, tok, y=y_j, decode=True,
        decode_index=i, mutable=["cache"]))
    p_cache = port.eval().init_cache(x.shape[0])
    with torch.no_grad():
        for i in range(x.shape[1]):
            want, mut = step(cache, x[:, i:i + 1], jnp.int32(i))
            cache = mut["cache"]
            got = port(torch.from_numpy(x[:, i:i + 1]).long(), y=y_t,
                       cache=p_cache)
            assert p_cache.index == i + 1
            _assert_logits(got, want)


def test_carry_across_covers_every_flax_leaf():
    _, params, port = _setup()
    leaves = jax.tree_util.tree_leaves(params)
    sd = transformer_state_dict_from_jax(params)
    assert len(sd) == len(leaves) == len(dict(port.named_parameters()))
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(leaf.shape)) for leaf in leaves)
    missing, unexpected = port.load_state_dict(sd, strict=True)
    assert not missing and not unexpected


def test_init_matches_flax_distributions_at_preset_width():
    cfg = dict(num_classes=10, num_tokens=512, embed_dim=256, n_layers=4,
               n_head=4, max_seq_len=16, dropout=0.1)
    _, params, _ = _setup(cfg, seed=0)
    want = transformer_state_dict_from_jax(params)
    got = transformer_init_(Transformer(**cfg),
                            torch.Generator().manual_seed(0)).state_dict()
    n_normal = 0
    for key, val in want.items():
        if val.ndim >= 2:
            ratio = got[key].std().item() / val.std().item()
            assert abs(ratio - 1.0) < 0.1, (key, ratio)
            n_normal += 1
        else:  # zero biases, unit LayerNorm scales
            torch.testing.assert_close(got[key], val)
    # token, class and positional tables, the head, 6 kernels a block
    assert n_normal == 4 + 6 * 4
