"""Port parity: the EMA VQ-VAE baseline (``models/vqvae_baseline.py`` and
``train/vqvae_engine.py``).

A narrow JAX model (3 channels, 32 px, hidden 16, z 8, one ResBlock, 16
codes) is carried across with ``vqvae_state_dict_from_jax`` and its
codebook with ``codebook_state_from_jax``.

- ``encode`` / ``decode``: within rtol 1e-5 (atol 1e-6 near 0);
- ``quantize``: identical indices (ties take the first index);
- ``ema_update``: within 1e-6, the Laplace smoothing, the clamp and the
  NaN guard too; ``straight_through`` and ``commitment_loss``: values and
  gradients; ``reseed_dead_codes`` on a one-row bank (the draw is then
  deterministic), and a mismatched or empty bank changes nothing;
  ``perplexity`` at its extremes;
- one engine step against JAX's jitted step, a batch of 6 whose last 2
  rows are padding (mask 0, zero images): loss and metrics within rtol
  1e-5; the parameters after Adam each within rtol 1e-4 plus two
  learning rates of JAX's (Adam's first step is about lr * sign(g), and a
  gradient at rounding distance from 0 may take either sign), at least
  99 % within rtol 1e-4; the EMA codebook within rtol 1e-5;
- the NaN guard against JAX's: a step on a batch with a NaN leaves the
  codebook as it was, Adam's count still advances, and the parameters
  move by the decayed moments as optax moves them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.models import VQVAE as JaxVQVAE
from vqvae_tpu.models import vqvae_baseline as jvb
from vqvae_tpu.train import VQVAEEngine as JaxEngine
from vqvae_tpu_torch.models import vqvae_baseline as vb
from vqvae_tpu_torch.models.vqvae_baseline import VQVAE, CodebookState
from vqvae_tpu_torch.train import VQVAEEngine
from vqvae_tpu_torch.utils.checkpoint import (codebook_state_from_jax,
                                              vqvae_state_dict_from_jax)

ARCH = dict(in_channels=3, z_channels=8, hidden=16, n_res_blocks=1)
N_CODES, LR = 16, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _models(seed=0):
    jmodel = JaxVQVAE(**ARCH)
    params = _np_tree(jax.jit(jmodel.init)({"params": jax.random.key(seed)},
                                           np.zeros((1, 32, 32, 3),
                                                    np.float32)))
    port = VQVAE(**ARCH)
    port.load_state_dict(vqvae_state_dict_from_jax(params))
    return jmodel, params, port


def _images(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def test_encode_decode_match_jax():
    jmodel, params, port = _models()
    x = _images()
    z_ref = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        p, v, method=jmodel.encode))(params, x))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
    assert z.shape == z_ref.shape == (6, 8, 8, 8)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-5, atol=1e-6)
    rec_ref = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        p, v, method=jmodel.decode))(params, z_ref))
    with torch.no_grad():
        rec = port.decode(torch.from_numpy(z_ref))
    assert rec.shape == rec_ref.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(rec.numpy(), rec_ref, rtol=1e-5, atol=1e-6)
    assert np.abs(rec.numpy()).max() <= 1.0  # the tanh head


def _codebook(embed, cluster_size=None, embed_avg=None):
    embed = np.asarray(embed, np.float32)
    cs = (np.zeros(embed.shape[0], np.float32) if cluster_size is None
          else np.asarray(cluster_size, np.float32))
    avg = embed if embed_avg is None else np.asarray(embed_avg, np.float32)
    return (jvb.CodebookState(jnp.asarray(embed), jnp.asarray(cs),
                              jnp.asarray(avg)),
            codebook_state_from_jax({"embed": embed, "cluster_size": cs,
                                     "embed_avg": avg}))


def test_quantize_indices_identical():
    rng = np.random.default_rng(1)
    embed = rng.normal(size=(N_CODES, 8)).astype(np.float32)
    embed[5] = embed[3]  # a tie: the first index wins on both sides
    z_e = rng.normal(size=(4, 8, 8, 8)).astype(np.float32)
    z_e[0, 0, 0] = embed[3]
    jcb, cb = _codebook(embed)
    zq_ref, idx_ref = jvb.quantize(jcb, jnp.asarray(z_e))
    zq, idx = vb.quantize(cb, torch.from_numpy(z_e))
    assert idx.shape == (4, 8, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(zq_ref))
    assert int(idx[0, 0, 0]) == 3


@pytest.mark.parametrize("case", ["plain", "clamp", "nan"])
def test_ema_update_matches_jax(case):
    rng = np.random.default_rng(2)
    embed = rng.normal(size=(N_CODES, 8)).astype(np.float32)
    cs = rng.uniform(0, 3, N_CODES).astype(np.float32)
    avg = rng.normal(size=(N_CODES, 8)).astype(np.float32)
    z_e = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    if case == "clamp":  # huge sums over tiny counts: the +-2 clamp
        cs[:] = 0.0
        avg[:4] = 1e9
        avg[4:8] = -1e9
    if case == "nan":  # inf / inf and 0 / 0 give NaN: mapped to 0
        avg[0] = np.inf
        cs[:] = 0.0
    jcb, cb = _codebook(embed, cs, avg)
    _, idx = jvb.quantize(jcb, jnp.asarray(z_e))
    ref = jvb.ema_update(jcb, jnp.asarray(z_e), idx, decay=0.9, eps=1e-5)
    got = vb.ema_update(cb, torch.from_numpy(z_e),
                        torch.from_numpy(np.asarray(idx)).long(), decay=0.9,
                        eps=1e-5)
    for key in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    e = got.embed.numpy()
    assert np.isfinite(e).all() and np.abs(e).max() <= 2.0
    if case == "clamp":
        assert (e[:4] == 2.0).all() and (e[4:8] == -2.0).all()


def test_straight_through_and_commitment_values_and_gradients():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)

    def jax_fn(za, zq):
        return (jvb.straight_through(za, zq) ** 2).sum() \
            + jvb.commitment_loss(za, zq, beta=0.25)

    ref = jax_fn(a, b)
    ga_ref, gb_ref = jax.grad(jax_fn, argnums=(0, 1))(a, b)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    st = vb.straight_through(ta, tb)
    np.testing.assert_array_equal(st.detach().numpy(),
                                  np.asarray(jvb.straight_through(a, b)))
    out = (st ** 2).sum() + vb.commitment_loss(ta, tb, beta=0.25)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga_ref),
                               rtol=1e-6, atol=1e-7)
    # nothing flows to the (stopped) codes
    assert tb.grad is None or float(tb.grad.abs().max()) == 0.0
    assert float(np.abs(np.asarray(gb_ref)).max()) == 0.0


def test_reseed_dead_codes_one_row_bank_and_noops():
    embed = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    cs = np.array([10.0, 0.0, 10.0, 1.0], np.float32)
    jcb, cb = _codebook(embed, cs)
    bank = np.array([[7.0, -3.0]], np.float32)  # one row: picks are all 0
    ref, n_ref = jvb.reseed_dead_codes(jax.random.key(0), jcb,
                                       jnp.asarray(bank), min_count=5.0)
    got, n = vb.reseed_dead_codes(torch.Generator().manual_seed(0), cb,
                                  torch.from_numpy(bank), min_count=5.0)
    assert n == int(n_ref) == 2
    for key in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    for bank in (np.zeros((0, 2), np.float32), np.zeros((3, 7), np.float32)):
        got, n = vb.reseed_dead_codes(torch.Generator(), cb,
                                      torch.from_numpy(bank), 5.0)
        assert n == 0 and got is cb


@pytest.mark.parametrize("case,expect", [("uniform", 8.0), ("single", 1.0)])
def test_perplexity_extremes(case, expect):
    idx = np.arange(8) if case == "uniform" else np.zeros(8, np.int64)
    ref = float(jvb.perplexity(jnp.asarray(idx, jnp.int32), 8))
    got = float(vb.perplexity(torch.from_numpy(idx), 8))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_codebook_create_is_distinct_copy():
    cb = CodebookState.create(torch.Generator().manual_seed(0), 4, 3)
    assert cb.embed.shape == (4, 3) and cb.cluster_size.shape == (4,)
    assert torch.equal(cb.embed, cb.embed_avg)
    assert cb.embed.data_ptr() != cb.embed_avg.data_ptr()


# -- one engine step against JAX's jitted step --------------------------------

def _engines():
    jeng = JaxEngine(JaxVQVAE(**ARCH), n_codes=N_CODES, lr=LR,
                     grad_clip=1.0, bank_size=64, seed=0)
    state, jcb, jbank = jeng.init_state((32, 32, 3))
    port = VQVAE(**ARCH)
    port.load_state_dict(vqvae_state_dict_from_jax(_np_tree(state.params)))
    eng = VQVAEEngine(port, n_codes=N_CODES, lr=LR, grad_clip=1.0,
                      bank_size=64, seed=0, device="cpu")
    cb = codebook_state_from_jax(_np_tree(jcb))
    bank = torch.zeros(64, ARCH["z_channels"])
    return jeng, (state, jcb, jbank), eng, cb, bank


def _batch(nan=False):
    x = _images(6, seed=4)
    mask = np.ones(6, np.float32)
    x[4:] = 0.0
    mask[4:] = 0.0
    if nan:
        x[1, 3, 3, 0] = np.nan
    return x, mask


def _check_params(eng, state, lr=LR):
    want = vqvae_state_dict_from_jax(_np_tree(state.params))
    n_par = n_close = 0
    for key, p in eng.model.named_parameters():
        got, ref = p.detach().numpy(), want[key].numpy()
        dp = np.abs(got - ref)
        assert (dp <= 1e-4 * np.abs(ref) + 2.0 * lr + 1e-7).all(), key
        n_close += int((dp <= 1e-4 * np.abs(ref) + 1e-7).sum())
        n_par += ref.size
    assert n_close >= 0.99 * n_par


def _check_codebook(cb, jcb, rtol=1e-5):
    for key in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(cb, key).numpy(),
                                   np.asarray(getattr(jcb, key)), rtol=rtol,
                                   atol=1e-6, err_msg=key)


def test_engine_step_matches_jax():
    jeng, (state0, jcb, jbank), eng, cb, bank = _engines()
    x, mask = _batch()
    z_e = np.asarray(jax.jit(lambda p, v: jeng.model.apply(
        {"params": p}, v, method=jeng.model.encode))(state0.params, x))
    state, jcb1, jbank, jm = jeng._train_step(state0, jcb, jbank, x, mask,
                                              jax.random.key(1))
    cb1, bank, m = eng.train_step(cb, bank, torch.from_numpy(x),
                                  torch.from_numpy(mask),
                                  torch.Generator().manual_seed(1))
    for key in ("loss", "rec", "vq", "q_mse", "perplex", "usage", "dead"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    _check_params(eng, state)
    _check_codebook(cb1, jcb1)
    assert eng.opt.count == 1
    # the bank rolled in min(256, 384 latents, 64 rows) of the batch's
    # latents, drawn without replacement
    flat = z_e.reshape(-1, 8)
    d = ((bank.numpy()[:, None] - flat[None]) ** 2).sum(-1)
    assert bank.shape == (64, 8) and (d.min(1) < 1e-8).all()


def test_nan_guard_matches_jax():
    jeng, (state, jcb, jbank), eng, cb, bank = _engines()
    x, mask = _batch()
    state, jcb, jbank, _ = jeng._train_step(state, jcb, jbank, x, mask,
                                            jax.random.key(1))
    cb, bank, _ = eng.train_step(cb, bank, torch.from_numpy(x),
                                 torch.from_numpy(mask),
                                 torch.Generator().manual_seed(1))
    before = [p.detach().clone() for p in eng.model.parameters()]
    x_nan, _ = _batch(nan=True)
    state2, jcb2, _, jm = jeng._train_step(state, jcb, jbank, x_nan, mask,
                                           jax.random.key(2))
    cb2, _, m = eng.train_step(cb, bank, torch.from_numpy(x_nan),
                               torch.from_numpy(mask),
                               torch.Generator().manual_seed(2))
    assert not np.isfinite(float(jm["loss"]))
    assert not np.isfinite(float(m["loss"]))
    # the codebook is kept, on both sides
    _check_codebook(cb2, jcb)
    for key in ("embed", "cluster_size", "embed_avg"):
        assert torch.equal(getattr(cb2, key), getattr(cb, key))
        np.testing.assert_array_equal(np.asarray(getattr(jcb2, key)),
                                      np.asarray(getattr(jcb, key)))
    # Adam's count advanced, and the parameters moved by the decayed
    # first moments as optax moves them
    count = [c for c in jax.tree_util.tree_leaves(state2.opt_state)
             if np.asarray(c).dtype == np.int32]
    assert int(np.asarray(count[0])) == 2
    assert eng.opt.count == 2
    assert all(int(s["step"]) == 2
               for s in eng.opt.opt.state.values())
    _check_params(eng, state2)
    assert any(not torch.equal(p.detach(), q)
               for p, q in zip(eng.model.parameters(), before))


def test_metric_sums_weight_by_valid_rows():
    sums = np.array([2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0, 2.0], np.float32)
    assert VQVAEEngine.metrics_from_sums(torch.from_numpy(sums)) == \
        pytest.approx(JaxEngine.__new__(JaxEngine)._metrics_from_sums(sums))
