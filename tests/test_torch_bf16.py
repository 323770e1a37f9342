"""Port parity: ``model.dtype: bfloat16`` (bf16 compute, float32
parameters) for the VAE and the transformer prior, against flax with
``dtype=jnp.bfloat16`` from the same weights (jitted, as the JAX training
step runs it), on seeds 0-4.

Measured gaps (``python tests/test_torch_bf16.py`` prints them per seed);
each limit is 3x the largest gap over the five seeds:

- logits: max |port - flax| over the tensor's largest magnitude;
- loss: relative;
- gradients: ||port - flax|| / ||flax|| per tensor. Tensors whose true
  gradient is 0 carry only rounding residue and are left out: the conv
  biases that feed a BatchNorm, and the attention key biases (a key bias
  shifts every logit of a query row alike, which the softmax cancels).
  The VAE's output bias sums the pixel gradients, which cancel, so its
  relative gap is far larger than the other tensors': it has its own
  limit.

Both sides round every layer's output to bf16, but not at the same
points: XLA fuses a jitted graph and rounds inside some fusions (its
softmax keeps exp in float32, rounds each step of the sum to bf16 and
divides in float32) and sums float32 reductions in its own order (the
BatchNorm statistics' E[x^2]). One value rounded the other way changes
many values downstream by one bf16 unit, so the port agrees with flax's
bf16 only to bf16's own resolution, about as closely as the float32
port does. The control therefore shows the cast inside the port: the
hidden activations are bf16 while the parameters and the returned
logits stay float32, and the bf16 logits differ from the float32 port's
by more than 1e-3 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.models import Transformer as JaxTransformer
from vqvae_tpu.models.transformer import cross_entropy_loss as jax_ce
from vqvae_tpu.models.vae import elbo_loss as jax_elbo
from vqvae_tpu_torch.models import VAE, BatchNorm, Transformer
from vqvae_tpu_torch.models.transformer import cross_entropy_loss
from vqvae_tpu_torch.utils.checkpoint import (load_vae_state_dict,
                                              transformer_state_dict_from_jax,
                                              vae_state_dict_from_jax)

ENC, DEC = (8, 16, 32), (32, 16, 8)
TF_CFG = dict(num_classes=10, num_tokens=32, embed_dim=32, n_layers=2,
              n_head=2, max_seq_len=16, dropout=0.0)
SEEDS = range(5)
# 3x the largest gap measured over seeds 0-4 (see the module notes)
VAE_LIMITS = {"logits": 2.8e-2, "loss": 3.6e-4, "grad": 3.7e-1,
              "grad_out_bias": 7.8e-1}
TF_LIMITS = {"logits": 2.8e-2, "loss": 6.3e-5, "grad": 9.4e-2}
CAST_MIN = 1e-3  # the bf16 port's logits against the float32 port's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _logit_gaps(got, ref):
    d = got - ref
    return (float(np.abs(d).max() / np.abs(ref).max()), _rel(got, ref))


def vae_gaps(seed: int, topology: str):
    """{"bfloat16": ..., "float32": ...}: each port dtype against flax's
    bf16 VAE (train mode, z = mu, a batch of 8 with 2 padding rows)."""
    cfg = dict(in_channels=1, enc_channels=ENC, dec_channels=DEC,
               latent_dim=6, recon_loss="mse", output_image_size=28,
               norm_type="batch", topology=topology)
    model = JaxVAE(**cfg, dtype=jnp.bfloat16)
    variables = _np(model.init({"params": jax.random.key(seed)},
                               np.zeros((1, 28, 28, 1), np.float32)))
    rng = np.random.default_rng(seed)
    x = rng.random((8, 28, 28, 1), dtype=np.float32)
    mask = np.ones(8, np.float32)
    x[6:], mask[6:] = 0.0, 0.0

    @jax.jit
    def loss_fn(params):
        (logits, mu, logvar, _), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            None, True, mutable=["batch_stats"])
        total, _, _ = jax_elbo(
            x, logits, mu, logvar, recon_loss="mse", mse_use_sigmoid=True,
            topology=topology, beta=1.0, mask=mask,
            free_bits=model.free_bits, capacity_max=model.capacity_max,
            capacity_anneal_steps=model.capacity_anneal_steps,
            capacity_mode=model.capacity_mode, step=0,
            spatial_free_bits=None)
        return total, logits

    (total, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    logits, total = np.asarray(logits), float(total)
    sd = vae_state_dict_from_jax(variables, topology, ENC, DEC)
    want_g = vae_state_dict_from_jax(
        {"params": _np(grads), "batch_stats": variables["batch_stats"]},
        topology, ENC, DEC)
    out = {}
    for dt in ("bfloat16", "float32"):
        port = load_vae_state_dict(VAE(**cfg, dtype=dt), sd).train()
        acts = []
        hooks = [m.register_forward_hook(lambda m, i, o: acts.append(o.dtype))
                 for m in port.modules() if isinstance(m, BatchNorm)]
        p_logits, mu, logvar, _ = port(torch.from_numpy(x))
        for h in hooks:
            h.remove()
        p_total, _, _ = port.loss(torch.from_numpy(x), p_logits, mu, logvar,
                                  beta=1.0, mask=torch.from_numpy(mask),
                                  step=0)
        p_total.backward()
        pre_norm = {f"{n.rsplit('.', 1)[0]}.{int(n.rsplit('.', 1)[1]) - 1}"
                    ".bias" for n, m in port.named_modules()
                    if isinstance(m, BatchNorm)}
        out_bias = ("decoder.deconv_layers.6.bias" if topology == "spatial"
                    else "decoder.output_layer.bias")
        grads_gap = {k: _rel(p.grad.numpy(), want_g[k].numpy())
                     for k, p in port.named_parameters()
                     if k not in pre_norm and k != out_bias}
        out[dt] = {
            "logits": _logit_gaps(p_logits.detach().numpy(), logits),
            "loss": abs(p_total.item() - total) / abs(total),
            "grad": max(grads_gap.values()),
            "grad_out_bias": _rel(dict(port.named_parameters())[out_bias]
                                  .grad.numpy(), want_g[out_bias].numpy()),
            "logits_raw": p_logits.detach().numpy(),
            "act_dtypes": set(acts),
            "logits_dtype": p_logits.dtype,
            "param_dtypes": {p.dtype for p in port.parameters()},
        }
    return out


def tf_gaps(seed: int):
    """{"bfloat16": ..., "float32": ...}: each port dtype against flax's
    bf16 transformer (dropout 0, label smoothing 0.1, 2 padding rows)."""
    model = JaxTransformer(**TF_CFG, dtype=jnp.bfloat16)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 32, (8, 15)).astype(np.int32)
    y = rng.integers(0, 32, (8, 15)).astype(np.int32)
    lab = rng.integers(0, 10, 8).astype(np.int32)
    mask = np.ones(8, np.float32)
    mask[6:] = 0.0
    params = _np(model.init({"params": jax.random.key(seed)}, x,
                            y=lab)["params"])

    @jax.jit
    def loss_fn(p):
        logits = model.apply({"params": p}, x, y=lab)
        return jax_ce(logits, y, mask=mask, label_smoothing=0.1), logits

    (total, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    logits, total = np.asarray(logits), float(total)
    want_g = transformer_state_dict_from_jax(_np(grads))
    out = {}
    for dt in ("bfloat16", "float32"):
        port = Transformer(**TF_CFG, dtype=dt)
        port.load_state_dict(transformer_state_dict_from_jax(params))
        p_logits = port(torch.from_numpy(x).long(),
                        y=torch.from_numpy(lab).long())
        p_total = cross_entropy_loss(p_logits, torch.from_numpy(y).long(),
                                     mask=torch.from_numpy(mask),
                                     label_smoothing=0.1)
        p_total.backward()
        out[dt] = {
            "logits": _logit_gaps(p_logits.detach().numpy(), logits),
            "loss": abs(p_total.item() - total) / abs(total),
            "grad": max(_rel(p.grad.numpy(), want_g[k].numpy())
                        for k, p in port.named_parameters()
                        if not k.endswith("attn.key.bias")),
            "logits_dtype": p_logits.dtype,
            "logits_raw": p_logits.detach().numpy(),
        }
    return out


def _cast_gap(gaps):
    a, b = gaps["bfloat16"]["logits_raw"], gaps["float32"]["logits_raw"]
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_vae_bf16_matches_flax(topology, seed):
    gaps = vae_gaps(seed, topology)
    bf16, f32 = gaps["bfloat16"], gaps["float32"]
    assert bf16["logits"][0] <= VAE_LIMITS["logits"], bf16["logits"]
    assert bf16["loss"] <= VAE_LIMITS["loss"], bf16["loss"]
    assert bf16["grad"] <= VAE_LIMITS["grad"], bf16["grad"]
    assert bf16["grad_out_bias"] <= VAE_LIMITS["grad_out_bias"]
    # control: the cast happens
    assert _cast_gap(gaps) > CAST_MIN
    assert bf16["act_dtypes"] == {torch.bfloat16}
    assert f32["act_dtypes"] == {torch.float32}
    assert bf16["logits_dtype"] == torch.float32
    assert bf16["param_dtypes"] == {torch.float32}


@pytest.mark.parametrize("seed", SEEDS)
def test_transformer_bf16_matches_flax(seed):
    gaps = tf_gaps(seed)
    bf16, f32 = gaps["bfloat16"], gaps["float32"]
    assert bf16["logits"][0] <= TF_LIMITS["logits"], bf16["logits"]
    assert bf16["loss"] <= TF_LIMITS["loss"], bf16["loss"]
    assert bf16["grad"] <= TF_LIMITS["grad"], bf16["grad"]
    # control: the cast happens
    assert bf16["logits_dtype"] == f32["logits_dtype"] == torch.float32
    assert _cast_gap(gaps) > CAST_MIN


if __name__ == "__main__":  # the measured gaps behind the limits
    torch.set_num_threads(1)
    for topo in ("spatial", "flat"):
        for s in SEEDS:
            gaps = vae_gaps(s, topo)
            for dt, g in gaps.items():
                print(f"vae {topo} seed {s} {dt}: logits {g['logits'][0]:.3e}"
                      f" (norm {g['logits'][1]:.3e}) loss {g['loss']:.3e} "
                      f"grad {g['grad']:.3e} "
                      f"out-bias grad {g['grad_out_bias']:.3e}")
            print(f"vae {topo} seed {s} bf16 vs float32 port: "
                  f"{_cast_gap(gaps):.3e}")
    for s in SEEDS:
        gaps = tf_gaps(s)
        for dt, g in gaps.items():
            print(f"transformer seed {s} {dt}: logits {g['logits'][0]:.3e} "
                  f"(norm {g['logits'][1]:.3e}) loss {g['loss']:.3e} "
                  f"grad {g['grad']:.3e}")
        print(f"transformer seed {s} bf16 vs float32 port: "
              f"{_cast_gap(gaps):.3e}")
