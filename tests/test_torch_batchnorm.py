"""Port parity: the port's ``models.vae.BatchNorm`` in training mode
against flax's ``nn.BatchNorm``, and against itself across torch's
thread counts.

Shapes: each BatchNorm input of the spatial FashionMNIST preset
(``configs/fashionmnist/spatial/geodesic``, encoder 64/128/256, decoder
256/128/64) and of the flat one (``configs/fashionmnist/vanilla/
geodesic``), at a batch of 32 (the thread checks) or 8 (flax), in the
layout the model hands each norm (channels-last after the encoder's
convolutions of an NHWC input). Inputs, scales, shifts, running
statistics and upstream gradients are seeded ``default_rng`` draws.

- bit for bit at 1, 2 and 4 torch threads, in the contiguous and the
  channels-last layout: the output, the running statistics and the
  gradients of the input, scale and shift. torch's own batch norm kernel
  fails this on a channels-last input (its sums follow the thread count),
  which made the VAE's parity with JAX depend on it;
- float32 against flax (the same input, the gradient of ``sum(y * g)``):
  output and input gradient within rtol 1e-6 or 2e-6 of the tensor's
  largest magnitude (flax sums the statistics in float32 in XLA's order
  and normalizes in float32; the port rounds float64 results once;
  measured at most 7.5e-7 of it); the running statistics within rtol
  1e-6 or 1e-6 of the largest value (measured at most 1.2e-7);
- bfloat16 input against flax with ``dtype=bfloat16``: each rounds a
  float32 result to bf16 (the port's rounded from float64), so an output
  differs only where the two float32 results round to neighbouring bf16
  values: by at most one bf16 unit of
  the larger (at most 2^-7 of it) plus the float32 gap, on at most 1 % of
  the elements (measured 0.065 %); the input gradient within 2^-6 of its
  largest magnitude (measured 0.0064); the running statistics as in
  float32. The model-level bf16 limits are ``tests/test_torch_bf16.py``'s.

On the CPU the norm takes the plain version
(``ops.batchnorm.batch_norm_train_reference``) and launches no kernel;
the kernels' grid (``grid_parts``) fills an H100's 132 SMs at every norm
shape of the presets' batch of 256. The kernels themselves are held
against the plain version on the card by
``tests/test_torch_batchnorm_cuda.py``.

``PYTHONPATH=. python tests/test_torch_batchnorm.py`` prints the measured
gaps.
"""
import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.models import VAE
from vqvae_tpu_torch.models.vae import BatchNorm
from vqvae_tpu_torch.ops.batchnorm import (batch_norm_train,
                                           batch_norm_train_reference,
                                           grid_parts)
from vqvae_tpu_torch.utils import profiling

PRESETS = {"spatial": "configs/fashionmnist/spatial/geodesic/vae.yaml",
           "flat": "configs/fashionmnist/vanilla/geodesic/vae.yaml"}
MOMENTUM, EPS = 0.99, 1e-5


@contextlib.contextmanager
def _torch_threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _norm_inputs(topology, batch):
    """[((batch, C, H, W), channels_last)] of every BatchNorm input of the
    preset's VAE: the shape and whether the layer before hands it over
    in the channels-last layout (the convolutions of an NHWC input do)."""
    arch = dict(load_config(PRESETS[topology])["model"])
    arch.pop("beta", None)
    model = VAE(**arch).train()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append((
        (batch, *args[0].shape[1:]),
        args[0].is_contiguous(memory_format=torch.channels_last)
        and not args[0].is_contiguous())))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(2, model.output_image_size,
                          model.output_image_size, model.in_channels))
    for h in hooks:
        h.remove()
    assert len(seen) == 5
    return seen


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    f32 = np.float32
    return {"x": rng.normal(0.3, 2.0, shape).astype(f32),
            "g": rng.normal(0.0, 1.0, shape).astype(f32),
            "scale": rng.normal(1.0, 0.2, c).astype(f32),
            "bias": rng.normal(0.0, 0.2, c).astype(f32),
            "mean": rng.normal(0.0, 0.5, c).astype(f32),
            "var": rng.uniform(0.5, 2.0, c).astype(f32)}


def _port(inp, dtype=torch.float32, channels_last=False):
    """(y, running mean, running var, dx, dscale, dbias) as numpy float32."""
    c = inp["scale"].shape[0]
    bn = BatchNorm(c, eps=EPS, momentum=MOMENTUM).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["var"]))
    x = torch.from_numpy(inp["x"]).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    y = bn(x)
    assert y.dtype == dtype
    (y.float() * torch.from_numpy(inp["g"])).sum().backward()
    return [t.detach().float().numpy() for t in
            (y, bn.running_mean, bn.running_var, x.grad, bn.weight.grad,
             bn.bias.grad)]


def _flax(inp, dtype=jnp.float32):
    """The same outputs from flax's ``nn.BatchNorm`` (NHWC)."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=MOMENTUM,
                       epsilon=EPS, dtype=dtype, param_dtype=jnp.float32)
    variables = {"params": {"scale": inp["scale"], "bias": inp["bias"]},
                 "batch_stats": {"mean": inp["mean"], "var": inp["var"]}}
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1)).astype(dtype)
    g = jnp.asarray(inp["g"].transpose(0, 2, 3, 1))

    def f(x):
        y, new = bn.apply(variables, x, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, new["batch_stats"])

    (_, (y, stats)), dx = jax.jit(jax.value_and_grad(f, has_aux=True))(x)
    nchw = (0, 3, 1, 2)
    return [np.asarray(y.astype(jnp.float32)).transpose(nchw),
            np.asarray(stats["mean"]), np.asarray(stats["var"]),
            np.asarray(dx.astype(jnp.float32)).transpose(nchw)]


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_batchnorm_training_is_bit_identical_across_threads(topology):
    for i, (shape, _) in enumerate(_norm_inputs(topology, 32)):
        inp = _inputs(shape, seed=i)
        for channels_last in (False, True):
            with _torch_threads(1):
                ref = _port(inp, channels_last=channels_last)
            for n in (2, 4):
                with _torch_threads(n):
                    got = _port(inp, channels_last=channels_last)
                for name, a, b in zip(("y", "running_mean", "running_var",
                                       "dx", "dscale", "dbias"), got, ref):
                    assert np.array_equal(a, b), \
                        (shape, channels_last, n, name)


def _close_stats(got, want, shape):
    for name, g, w in zip(("running_mean", "running_var"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=f"{shape} {name}")


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_batchnorm_training_matches_flax(topology):
    for i, (shape, cl) in enumerate(_norm_inputs(topology, 8)):
        inp = _inputs(shape, seed=10 + i)
        got, want = _port(inp, channels_last=cl), _flax(inp)
        for k, name in ((0, "y"), (3, "dx")):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=2e-6 * np.abs(want[k]).max(),
                                       err_msg=f"{shape} {name}")
        _close_stats(got[1:3], want[1:3], shape)


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_batchnorm_bf16_input_matches_flax(topology):
    for i, (shape, cl) in enumerate(_norm_inputs(topology, 8)):
        inp = _inputs(shape, seed=20 + i)
        got, want = (_port(inp, torch.bfloat16, channels_last=cl),
                     _flax(inp, jnp.bfloat16))
        y, w_y = got[0], want[0]
        gap = np.abs(y - w_y)
        assert (gap > 0).mean() <= 0.01, shape
        unit = 2.0 ** -7 * np.maximum(np.abs(y), np.abs(w_y))
        assert (gap <= unit + 1e-6 * np.abs(w_y).max()).all(), shape
        assert np.abs(got[3] - want[3]).max() <= \
            2.0 ** -6 * np.abs(want[3]).max(), shape
        _close_stats(got[1:3], want[1:3], shape)


@pytest.mark.parametrize("topology", ["spatial", "flat"])
def test_cpu_input_takes_the_plain_path(topology):
    """A CPU input runs the plain version, bit for bit, and neither
    launches a kernel nor records the kernels' counter."""
    profiling.reset_spans()
    try:
        for i, (shape, cl) in enumerate(_norm_inputs(topology, 8)):
            inp = _inputs(shape, seed=30 + i)
            before = batch_norm_train.launches
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                got = _port(inp, channels_last=cl)
            assert batch_norm_train.launches == before
            assert not [r for r in profiling.spans()
                        if r.name == "vqvae.vae.batchnorm_kernel"]
            x = torch.from_numpy(inp["x"])
            if cl:
                x = x.contiguous(memory_format=torch.channels_last)
            x.requires_grad_()
            w = torch.from_numpy(inp["scale"]).requires_grad_()
            b = torch.from_numpy(inp["bias"]).requires_grad_()
            rm = torch.from_numpy(inp["mean"].copy())
            rv = torch.from_numpy(inp["var"].copy())
            y = batch_norm_train_reference(x, w, b, rm, rv,
                                           torch.zeros((), dtype=torch.long),
                                           EPS, MOMENTUM)
            (y * torch.from_numpy(inp["g"])).sum().backward()
            for name, a, want in zip(
                    ("y", "running_mean", "running_var", "dx", "dscale",
                     "dbias"), got, (y, rm, rv, x.grad, w.grad, b.grad)):
                assert np.array_equal(a, want.detach().numpy()), \
                    (shape, name)
    finally:
        profiling.reset_spans()


@pytest.mark.parametrize("channels_last", [False, True])
def test_kernel_grid_fills_the_card(channels_last):
    """At the presets' batch of 256, every norm's launch spans at least
    one block per SM of an H100 (132), each thread walks at least four
    values, and the grid's second dimension stays in CUDA's range."""
    shapes = {s[1:] for t in ("spatial", "flat")
              for s, _ in _norm_inputs(t, 256)}
    for c, h, w in shapes:
        parts = grid_parts(256, c, h * w, channels_last, 132)
        columns = -(-c // 32) if channels_last else c
        assert 132 <= columns * parts, (c, h, w)
        per_thread = 256 * h * w / (parts * (8 if channels_last else 256))
        assert per_thread >= 4 and parts <= 65535, (c, h, w)
    assert grid_parts(1, 1, 1, channels_last, 132) == 1


if __name__ == "__main__":  # the measured gaps behind the bounds
    for topology in ("spatial", "flat"):
        for i, (shape, cl) in enumerate(_norm_inputs(topology, 8)):
            got, want = _port(_inputs(shape, 10 + i), channels_last=cl), \
                _flax(_inputs(shape, 10 + i))
            rel = [np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
                   for k in range(4)]
            print(f"{topology} {shape} float32: y {rel[0]:.3e} dx "
                  f"{rel[3]:.3e} running mean {rel[1]:.3e} var {rel[2]:.3e}"
                  " of the largest")
            inp = _inputs(shape, 20 + i)
            got = _port(inp, torch.bfloat16, channels_last=cl)
            want = _flax(inp, jnp.bfloat16)
            gap = np.abs(got[0] - want[0])
            dx = np.abs(got[3] - want[3]).max() / np.abs(want[3]).max()
            print(f"{topology} {shape} bfloat16: {(gap > 0).mean():.3%} of y "
                  f"differ; dx {dx:.3e} of the largest")
