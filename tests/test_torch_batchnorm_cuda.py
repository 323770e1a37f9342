"""The training BatchNorm's kernels (``csrc/batchnorm.cu``) against their
plain PyTorch version on the card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one. The file imports no JAX: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_batchnorm_cuda.py``.

Shapes: every BatchNorm input of the spatial FashionMNIST and CIFAR-10
presets and of the flat FashionMNIST one, at their batch of 256, in the
NCHW and the channels-last layout, and with dy in the other layout than x.
Both versions keep float64 statistics and round each result once to
float32; they sum in another order, so they differ in the last float64
bits, which a rounding of y or dx to float32 shows on a few elements:

- y and dx within rtol 1e-6 or 1e-6 of the tensor's largest magnitude;
- dscale, dbias and the running statistics within rtol 1e-6;
- a launch repeats itself bit for bit;
- four launches a norm and a training step;
- the mesh's sums (a stub ``all_reduce_sum`` that scales what it is
  given) reach the kernels between the two of each direction.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.models import VAE
from vqvae_tpu_torch.models.vae import BatchNorm
from vqvae_tpu_torch.ops import batchnorm as bn
from vqvae_tpu_torch.ops.batchnorm import (batch_norm_train,
                                           batch_norm_train_reference)

PRESETS = ("configs/fashionmnist/spatial/geodesic/vae.yaml",
           "configs/cifar10/spatial/geodesic/vae.yaml",
           "configs/fashionmnist/vanilla/geodesic/vae.yaml")
BATCH, MOMENTUM, EPS = 256, 0.99, 1e-5


def _norm_shapes():
    """Every distinct (C, H, W) a BatchNorm of the presets' VAEs sees."""
    seen = []
    for preset in PRESETS:
        arch = dict(load_config(preset)["model"])
        arch.pop("beta", None)
        model = VAE(**arch).train()
        hooks = [m.register_forward_pre_hook(
            lambda m, args: seen.append(tuple(args[0].shape[1:])))
            for m in model.modules() if isinstance(m, BatchNorm)]
        with torch.no_grad():
            model(torch.zeros(2, model.output_image_size,
                              model.output_image_size, model.in_channels))
        for h in hooks:
            h.remove()
    return sorted(set(seen))


SHAPES = _norm_shapes()
# (x channels-last, dy channels-last)
LAYOUTS = [(False, False), (True, True), (True, False), (False, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels vs plain version)")
    return torch.device("cuda")


def _inputs(chw, seed, dev):
    rng = np.random.default_rng(seed)
    c = chw[0]
    shape = (BATCH, *chw)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return {"x": t(rng.normal(0.3, 2.0, shape)),
            "g": t(rng.normal(0.0, 1.0, shape)),
            "scale": t(rng.normal(1.0, 0.2, c)),
            "bias": t(rng.normal(0.0, 0.2, c)),
            "mean": t(rng.normal(0.0, 0.5, c)),
            "var": t(rng.uniform(0.5, 2.0, c))}


def _fmt(t, channels_last):
    return t.contiguous(memory_format=torch.channels_last
                        if channels_last else torch.contiguous_format)


def _run(fn, inp, x_cl, g_cl, mesh=None):
    """(y, dx, dscale, dbias, running mean, running var, tracked) of one
    training forward and backward of ``fn``."""
    weight = inp["scale"].clone().requires_grad_()
    bias = inp["bias"].clone().requires_grad_()
    rm, rv = inp["mean"].clone(), inp["var"].clone()
    tracked = torch.zeros((), dtype=torch.int64, device=rm.device)
    x = _fmt(inp["x"], x_cl).requires_grad_()
    y = fn(x, weight, bias, rm, rv, tracked, EPS, MOMENTUM, mesh)
    dx, dw, db = torch.autograd.grad(y, (x, weight, bias),
                                     _fmt(inp["g"], g_cl))
    torch.cuda.synchronize()
    return (y.detach(), dx, dw, db, rm, rv, tracked)


def _agree(got, want, where):
    y, dx, dw, db, rm, rv, tracked = got
    for name, a, b in (("y", y, want[0]), ("dx", dx, want[1])):
        torch.testing.assert_close(
            a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()),
            msg=lambda m: f"{where} {name}: {m}")
    for name, a, b in (("dscale", dw, want[2]), ("dbias", db, want[3]),
                       ("running_mean", rm, want[4]),
                       ("running_var", rv, want[5])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"{where} {name}: {m}")
    assert int(tracked) == int(want[6]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("chw", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("x_cl,g_cl", LAYOUTS,
                         ids=["nchw", "cl", "cl-nchw", "nchw-cl"])
def test_kernels_match_the_plain_version_on_card(cuda_device, chw, x_cl,
                                                 g_cl):
    inp = _inputs(chw, sum(chw), cuda_device)
    before = batch_norm_train.launches
    got = _run(batch_norm_train, inp, x_cl, g_cl)
    assert batch_norm_train.launches == before + 4
    want = _run(batch_norm_train_reference, inp, x_cl, g_cl)
    assert batch_norm_train.launches == before + 4
    _agree(got, want, (chw, x_cl, g_cl))
    assert got[0].is_contiguous(memory_format=torch.channels_last
                                if x_cl else torch.contiguous_format)
    assert got[1].is_contiguous(memory_format=torch.channels_last
                                if g_cl else torch.contiguous_format)


@pytest.mark.cuda
@pytest.mark.parametrize("x_cl,g_cl", LAYOUTS[:3],
                         ids=["nchw", "cl", "cl-nchw"])
def test_kernels_repeat_themselves_bit_for_bit(cuda_device, x_cl, g_cl):
    for chw in SHAPES:
        inp = _inputs(chw, 7, cuda_device)
        first = _run(batch_norm_train, inp, x_cl, g_cl)
        for _ in range(2):
            again = _run(batch_norm_train, inp, x_cl, g_cl)
            for a, b in zip(first, again):
                assert torch.equal(a, b), (chw, x_cl, g_cl)


@pytest.mark.cuda
def test_mesh_sums_pass_between_the_kernels(cuda_device, monkeypatch):
    """A stub ``all_reduce_sum`` scales each entry it is given: the
    kernels and the plain version must see the same scaled statistics
    and gradient sums, which move y, dx and the running statistics."""
    mesh = object()
    seen = []

    def stub(t, m):
        assert m is mesh
        seen.append((t.dtype, t.numel()))
        i = torch.arange(t.numel(), device=t.device, dtype=t.dtype)
        return t * (1.0 + 0.05 * torch.cos(i)).reshape(t.shape)

    for chw in (SHAPES[0], SHAPES[-1]):
        inp = _inputs(chw, 3, cuda_device)
        plain = _run(batch_norm_train_reference, inp, True, True)
        monkeypatch.setattr(bn, "all_reduce_sum", stub)
        got = _run(batch_norm_train, inp, True, True, mesh)
        c = chw[0]
        assert seen == [(torch.float64, 2 * c + 1), (torch.float64, 2 * c)]
        want = _run(batch_norm_train_reference, inp, True, True, mesh)
        monkeypatch.undo()
        seen.clear()
        _agree(got, want, chw)
        assert not torch.allclose(got[0], plain[0])
        assert not torch.allclose(got[1], plain[1])
        assert not torch.allclose(got[2], plain[2])  # xhat moved
        assert not torch.allclose(got[4], plain[4])
        # dbias is this rank's sum of dy: the stub leaves it
        torch.testing.assert_close(got[3], plain[3], rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_model_norms_run_the_kernels_on_card(cuda_device):
    """A training step of the spatial preset's VAE on the card: each norm
    launches its four kernels; bf16 inputs are normalized in float32."""
    arch = dict(load_config(PRESETS[0])["model"])
    arch.pop("beta", None)
    model = VAE(**arch).to(cuda_device).train()
    x = torch.rand(8, 28, 28, 1, device=cuda_device)
    before = batch_norm_train.launches
    out = model(x)
    sum(o.float().sum() for o in out if torch.is_tensor(o)).backward()
    torch.cuda.synchronize()
    assert batch_norm_train.launches == before + 4 * 5
    norm = BatchNorm(16).to(cuda_device).train()
    xb = torch.randn(4, 16, 5, 5, device=cuda_device, dtype=torch.bfloat16)
    y = norm(xb)
    assert y.dtype == torch.bfloat16
    ref = BatchNorm(16).to(cuda_device).train()
    want = batch_norm_train_reference(
        xb.float(), ref.weight, ref.bias, ref.running_mean, ref.running_var,
        ref.num_batches_tracked, ref.eps, ref.flax_momentum)
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(),
                               rtol=2.0 ** -7, atol=1e-6)
