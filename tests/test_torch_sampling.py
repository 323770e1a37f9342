"""Port parity: KV-cached autoregressive sampling
(``train/transformer_engine.py`` ``sample_autoregressive``).

The RNG streams of the two packages cannot match, so:
- greedy sampling (top_k = 1) must give JAX's tokens exactly, on the same
  prompts, carried-across params and labels (a near-tie of the top two
  logits, under 1e-5 relative, could flip a token; none occurs at these
  seeds);
- the port's KV-cache path must pick the tokens its own full-prefix
  forward picks greedily, with logits within 1e-5 relative (1e-6
  absolute);
- the top-k filter must equal JAX's ``where(scaled < kth, -inf, scaled)``
  exactly, ties at the k-th value kept;
- 20,000 draws from fixed logits must follow softmax(logits / T) over the
  top k: a chi-square statistic under its 1 - 1e-6 quantile, at a fixed
  seed (no flake), and no draw outside the top k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from vqvae_tpu.models import Transformer as JaxTransformer
from vqvae_tpu.train.transformer_engine import (
    sample_autoregressive as jax_sample)
from vqvae_tpu_torch.models.transformer import Transformer
from vqvae_tpu_torch.train.transformer_engine import (sample_autoregressive,
                                                      sample_next,
                                                      top_k_filter)
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


def _setup(cfg=CFG, seed=2):
    model = JaxTransformer(**cfg)
    x = np.zeros((2, cfg["max_seq_len"]), np.int32)
    y = np.zeros(2, np.int32) if cfg["num_classes"] else None
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: model.init({"params": key}, x, y=y))(
            jax.random.key(seed))["params"])
    port = Transformer(**cfg)
    port.load_state_dict(transformer_state_dict_from_jax(params))
    return model, params, port.eval()


@pytest.mark.parametrize("t0,labels", [(1, True), (3, True), (1, False)],
                         ids=["one-token-prompt", "three-token-prompt",
                              "unconditioned"])
def test_greedy_tokens_equal_jax(t0, labels):
    model, params, port = _setup()
    rng = np.random.default_rng(t0)
    first = rng.integers(0, 64, (12, t0)).astype(np.int32)
    y = rng.integers(0, 10, 12).astype(np.int32) if labels else None
    steps = CFG["max_seq_len"] - t0
    want = np.asarray(jax_sample(model, params, first, steps=steps,
                                 rng=jax.random.key(0), top_k=1, labels=y))
    got = sample_autoregressive(
        port, torch.from_numpy(first), steps=steps,
        generator=torch.Generator().manual_seed(0), top_k=1,
        labels=torch.from_numpy(y).long() if labels else None)
    assert got.shape == (12, CFG["max_seq_len"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_matches_own_full_prefix_forward():
    _, _, port = _setup()
    rng = np.random.default_rng(4)
    first = torch.from_numpy(rng.integers(0, 64, (8, 1)))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    got = sample_autoregressive(port, first, steps=15,
                                generator=torch.Generator().manual_seed(0),
                                top_k=1, labels=y)
    toks = first
    with torch.no_grad():
        cache = port.init_cache(8)
        for i in range(15):
            full = port(toks, y=y)[:, -1]
            step = port(toks[:, -1:], y=y, cache=cache)[:, 0]
            np.testing.assert_allclose(step.numpy(), full.numpy(),
                                       rtol=1e-5, atol=1e-6)
            toks = torch.cat([toks, full.argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(got.numpy(), toks.numpy())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_filter_matches_jax_with_ties(k):
    rows = np.array([
        [0.5, 2.0, 2.0, 2.0, -1.0, 0.1, 2.0, 0.3],  # 4-way tie at the top
        [1.0, 3.0, 2.0, 2.0, 2.0, -4.0, 0.0, 2.0],  # tie at the 2nd-5th
        [-1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0],  # all equal
        [4.0, 3.0, 2.0, 1.0, 0.0, -1.0, -2.0, -3.0],  # no ties
    ], np.float32) / np.float32(0.7)
    kth = jax.lax.top_k(jnp.asarray(rows), k)[0][:, -1]
    want = np.asarray(jnp.where(rows < kth[:, None], -jnp.inf, rows))
    got = top_k_filter(torch.from_numpy(rows), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.isfinite(got).sum(1) >= k).all()


@pytest.mark.parametrize("temperature,top_k", [(1.0, None), (0.7, 5),
                                               (1.5, 12)])
def test_draws_follow_softmax_over_the_top_k(temperature, top_k):
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 1.5, 40).astype(np.float32)
    n = 20_000
    toks = sample_next(torch.from_numpy(logits).expand(n, -1),
                       torch.Generator().manual_seed(123),
                       temperature=temperature, top_k=top_k)
    assert toks.shape == (n, 1)
    counts = np.bincount(toks.numpy()[:, 0], minlength=40)
    scaled = logits.astype(np.float64) / temperature
    keep = np.ones(40, bool)
    if top_k is not None:
        keep = scaled >= np.sort(scaled)[-top_k]
        assert counts[~keep].sum() == 0
    p = np.exp(scaled[keep] - scaled[keep].max())
    p /= p.sum()
    expected = n * p
    chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
    assert chi2 < stats.chi2.ppf(1 - 1e-6, df=int(keep.sum()) - 1), chi2
