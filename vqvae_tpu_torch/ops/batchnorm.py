"""Training-mode batch normalization with flax's statistics: the VAE's
``BatchNorm`` (``models/vae.py``) in training mode.

``batch_norm_train`` normalizes a (N, C, H, W) input by its batch
statistics as flax's ``nn.BatchNorm`` does: the per-channel count, sum and
sum of squares in float64, summed over ``mesh``'s ranks (the identity
without a process group); flax's fast biased variance ``max(E[x^2] -
E[x]^2, 0)``; ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and its
gradient in float64, rounded once to float32; the running statistics moved
in place by ``m * running + (1 - m) * batch`` in float32 (flax's momentum
``m``) and ``num_batches_tracked`` by one.

On a CUDA tensor it launches the hand-written Hopper kernels in
``csrc/batchnorm.cu`` (built with ``nvcc`` at first use, bound with ctypes,
launched on the current stream): statistics and normalization forward,
gradient sums and input gradient backward, with the mesh's sums between
the two of each; four launches a norm and a training step. On a CPU tensor
it runs ``batch_norm_train_reference``, the plain PyTorch version, whose
output is bit for bit the same at any thread count (its float64 sums of
float32 values carry no rounding that float32 can see). The kernels sum in
another order, so they agree with it to the last float64 bits, which a
float32 rounding of y or dx shows on a few elements. Each kernel launch
repeats itself bit for bit (no floating-point atomics).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .._build import load_cuda_library
from ..parallel.mesh import all_reduce_sum
from ..utils.profiling import count, span

# the kernels' blocks (csrc/batchnorm.cu): channels-last blocks are 32
# channels x 8 rows, NCHW blocks 256 threads over one channel
_TILE, _LANES, _THREADS = 32, 8, 256
# blocks a launch aims at, per SM of the card
_BLOCKS_PER_SM = 4
# the least values a thread walks (fewer parts on small inputs)
_MIN_PER_THREAD = 4

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_CD, _CF = ctypes.c_double, ctypes.c_float
_SIGNATURES = {
    "bn_forward_stats": ([_VP] + [_CI] * 5 + [_VP] * 4, _CI),
    "bn_forward_apply": ([_VP, _VP] + [_CI] * 5 + [_VP] * 3
                         + [_CD, _CF, _CF] + [_VP] * 5, _CI),
    "bn_backward_sums": ([_VP, _VP] + [_CI] * 6 + [_VP] * 7, _CI),
    "bn_backward_input": ([_VP, _VP, _VP] + [_CI] * 6 + [_VP] * 5, _CI),
    "bn_error_string": ([_CI], ctypes.c_char_p),
}


def build() -> str:
    """Build (or reuse) the kernel library; returns nvcc's output."""
    return load_cuda_library("batchnorm.cu", _SIGNATURES)[1]


def _library() -> ctypes.CDLL:
    return load_cuda_library("batchnorm.cu", _SIGNATURES)[0]


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, eps: float,
                     momentum: float, mesh=None) -> torch.Tensor:
    """y of x's dtype: x (N, C, H, W) normalized by its batch statistics
    (see the module's notes), with ``momentum`` flax's (0.99). A half
    precision x is normalized in float32. CUDA tensors launch the kernels
    (``batch_norm_train.launches`` counts them); other tensors run the
    plain version."""
    xf = x.float()
    args = (weight, bias, running_mean, running_var, num_batches_tracked,
            eps, momentum, mesh)
    if xf.device.type == "cuda":
        y = _TrainNormKernel.apply(xf, *args)
    else:
        y = batch_norm_train_reference(xf, *args)
    return y.to(x.dtype)


batch_norm_train.launches = 0


# ---- the plain version ---------------------------------------------------

def _channel_sums(*ts: torch.Tensor) -> torch.Tensor:
    """(len(ts), C): each float64 (B, C, H, W) tensor summed over B, H and
    W. A float32 value or the product of two enters exactly, and the sum
    of a batch carries no rounding that float32 can see, so the statistics
    do not depend on the order of summation (the thread count, the
    device)."""
    return torch.stack([t.sum((0, 2, 3)) for t in ts])


class _TrainNorm(torch.autograd.Function):
    """flax's training-mode normalization ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` of a float32 ``xf`` by its batch statistics
    (float64 ``mean`` and ``inv`` = rsqrt(var + eps), ``xd`` = ``xf`` in
    float64), with the gradient that autograd would take through flax's
    statistics, in closed form: ``dx = scale * inv * (dy - E[dy] - xhat *
    E[dy * xhat])``, the expectations over the global batch of ``n`` rows
    (summed over ``mesh``'s ranks); the scale and shift get this rank's
    sums. Both are evaluated in float64 and rounded once to float32: in
    float32, ``x - mean`` and ``dy - E[dy] - ...`` cancel where a channel's
    mean is large next to its spread, and expose the rounding of their
    terms."""

    @staticmethod
    def forward(ctx, xf, xd, mean, inv, weight, bias, n, mesh):
        ctx.save_for_backward(xf, mean, inv, weight, n)
        ctx.mesh = mesh
        mul = inv * weight.double()
        return torch.addcmul((bias.double() - mean * mul)[:, None, None],
                             xd, mul[:, None, None]).float()

    @staticmethod
    def backward(ctx, dy):
        with span("vqvae.vae.batchnorm_backward"):
            xf, mean, inv, weight, n = ctx.saved_tensors
            dy = dy.double()
            xhat = torch.addcmul((-mean * inv)[:, None, None], xf.double(),
                                 inv[:, None, None])
            local = _channel_sums(dy, dy * xhat)
            sdy, sdyx = all_reduce_sum(local, ctx.mesh) / n
            mul = weight.double() * inv
            dx = torch.addcmul((-mul * sdy)[:, None, None], dy,
                               mul[:, None, None])
            dx = torch.addcmul(dx, xhat, (-mul * sdyx)[:, None, None])
            db, dw = local.float()
            return dx.float(), None, None, None, dw, db, None, None


def batch_norm_train_reference(xf, weight, bias, running_mean, running_var,
                               num_batches_tracked, eps, momentum,
                               mesh=None) -> torch.Tensor:
    """Plain PyTorch version of ``batch_norm_train`` on a float32 ``xf``,
    on any device."""
    with torch.no_grad():
        c = xf.shape[1]
        xd = xf.double()
        stats = all_reduce_sum(torch.cat([
            _channel_sums(xd, xd * xd).reshape(-1),
            xd.new_full((1,), float(xf.numel() // max(c, 1)))]), mesh)
        n = torch.clamp_min(stats[2 * c], 1.0)
        mean = stats[:c] / n
        var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
        m = momentum
        running_mean.copy_(m * running_mean + (1.0 - m) * mean.float())
        running_var.copy_(m * running_var + (1.0 - m) * var.float())
        num_batches_tracked.add_(1)
    return _TrainNorm.apply(xf, xd, mean, torch.rsqrt(var + eps), weight,
                            bias, n, mesh)


# ---- the kernels ---------------------------------------------------------

def _layout(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(t, channels-last?): t itself when NCHW-contiguous or channels-last,
    else an NCHW copy."""
    if t.is_contiguous():
        return t, False
    if t.is_contiguous(memory_format=torch.channels_last):
        return t, True
    return t.contiguous(), False


def grid_parts(n: int, c: int, s: int, channels_last: bool, sms: int) -> int:
    """Blocks of a launch along the N*H*W values of a channel (grid.y):
    about ``_BLOCKS_PER_SM`` blocks per SM over the grid's columns (tiles
    of 32 channels, or single channels in NCHW), each thread walking at
    least ``_MIN_PER_THREAD`` values."""
    columns = -(-c // _TILE) if channels_last else c
    per_block = _MIN_PER_THREAD * (_LANES if channels_last else _THREADS)
    return max(1, min(-(-_BLOCKS_PER_SM * sms // columns),
                      -(-n * s // per_block), 65535))


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# the tickets of each (device, stream): zeroed once, left zero by every
# launch, so the launches of one stream share them in turn
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, columns: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < columns:
        t = torch.zeros(max(columns, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _check(rc: int, what: str, shape) -> None:
    batch_norm_train.launches += 1
    if rc != 0:
        raise RuntimeError(
            f"batchnorm kernel launch failed ({what}): "
            f"{_library().bn_error_string(rc).decode()} (code {rc}; shape "
            f"{tuple(shape)})")


def _dims(x: torch.Tensor, params) -> Tuple[int, int, int]:
    if x.ndim != 4:
        raise ValueError(f"batch_norm_train takes (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if x.numel() >= 2**31 or x.numel() == 0:
        raise ValueError(f"batch_norm_train: {x.numel()} elements (the "
                         f"kernels take 1 to 2^31 - 1)")
    for p in params:
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise TypeError(f"batch_norm_train: parameters and running "
                            f"statistics must be contiguous float32 ({c},) "
                            f"on {x.device}")
    return n, c, h * w


class _TrainNormKernel(torch.autograd.Function):
    """``batch_norm_train`` on CUDA: the kernels of ``csrc/batchnorm.cu``,
    with ``all_reduce_sum`` over ``mesh`` between the two of each
    direction."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, tracked,
                eps, momentum, mesh):
        n, c, s = _dims(x, (weight, bias, running_mean, running_var))
        x, cl = _layout(x)
        dev = x.device
        lib = _library()
        f64 = dict(dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            parts = grid_parts(n, c, s, cl, _sms(dev.index))
            partial = torch.empty(parts * 2 * c, **f64)
            stats = torch.empty(2 * c + 1, **f64)
            tickets = _tickets(dev, stream, c)
            _check(lib.bn_forward_stats(
                x.data_ptr(), n, c, s, int(cl), parts, partial.data_ptr(),
                tickets.data_ptr(), stats.data_ptr(), stream),
                "statistics", x.shape)
            stats = all_reduce_sum(stats, mesh)
            y = torch.empty_like(x)
            saved = torch.empty(2 * c, **f64)
            _check(lib.bn_forward_apply(
                x.data_ptr(), y.data_ptr(), n, c, s, int(cl), parts,
                stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                float(eps), float(momentum), 1.0 - momentum,
                running_mean.data_ptr(), running_var.data_ptr(),
                tracked.data_ptr(), saved.data_ptr(), stream),
                "normalization", x.shape)
        ctx.save_for_backward(x, weight, stats, saved)
        ctx.mesh, ctx.cl = mesh, cl
        count("vqvae.vae.batchnorm_kernel")
        return y

    @staticmethod
    def backward(ctx, dy):
        with span("vqvae.vae.batchnorm_backward"):
            x, weight, stats, saved = ctx.saved_tensors
            n, c, s = _dims(x, ())
            dy, dy_cl = _layout(dy.float())
            dev = x.device
            lib = _library()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                parts = grid_parts(n, c, s, dy_cl, _sms(dev.index))
                partial = torch.empty(parts * 2 * c, dtype=torch.float64,
                                      device=dev)
                local = torch.empty(2 * c, dtype=torch.float64, device=dev)
                dw = torch.empty(c, dtype=torch.float32, device=dev)
                db = torch.empty(c, dtype=torch.float32, device=dev)
                _check(lib.bn_backward_sums(
                    dy.data_ptr(), x.data_ptr(), n, c, s, int(dy_cl),
                    int(ctx.cl), parts, saved.data_ptr(), partial.data_ptr(),
                    _tickets(dev, stream, c).data_ptr(), local.data_ptr(),
                    dw.data_ptr(), db.data_ptr(), stream),
                    "gradient sums", x.shape)
                total = all_reduce_sum(local, ctx.mesh)
                dx = torch.empty_like(dy)
                _check(lib.bn_backward_input(
                    dy.data_ptr(), x.data_ptr(), dx.data_ptr(), n, c, s,
                    int(dy_cl), int(ctx.cl), parts, stats.data_ptr(),
                    total.data_ptr(), saved.data_ptr(), weight.data_ptr(),
                    stream), "input gradient", x.shape)
            count("vqvae.vae.batchnorm_kernel")
            return dx, dw, db, None, None, None, None, None, None
