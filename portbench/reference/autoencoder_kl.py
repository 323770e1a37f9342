"""Plain PyTorch reference of FLUX.1's KL autoencoder, in float32.

Written from Rombach et al. 2022 (CompVis/latent-diffusion,
``ldm/modules/diffusionmodules/model.py`` and
``ldm/modules/distributions/distributions.py``) and FLUX.1 [dev]'s
``vae/config.json``, not from the program; functional, on a dict of
weights whose names are diffusers' ``AutoencoderKL``'s:

- Normalize: GroupNorm over ``norm_num_groups`` groups, eps 1e-6, written
  out (biased variance over each group's channels and pixels); the
  nonlinearity x * sigmoid(x);
- ResnetBlock: h = conv1(silu(norm1(x))), h = conv2(silu(norm2(h))),
  x + h, x through a 1x1 conv (``conv_shortcut``, LDM's ``nin_shortcut``)
  where the width changes;
- AttnBlock: one head over the grid, q, k, v and the output as linear maps
  of the normalized input (LDM's 1x1 convs), softmax(q k^T / sqrt(C)) v,
  the input added;
- Downsample: pad the right and bottom by one, 3x3 conv of stride 2;
  Upsample: nearest x2 (each pixel repeated), 3x3 conv;
- Encoder: conv_in, per level ``layers_per_block`` ResNet blocks and a
  Downsample but at the last, mid (ResNet, attention, ResNet), norm,
  nonlinearity, conv_out to 2 x ``latent_channels`` (mean, log-variance);
  Decoder: conv_in, mid, per level from the widest ``layers_per_block``
  + 1 ResNet blocks and an Upsample but at the last, norm, nonlinearity,
  conv_out;
- DiagonalGaussian: the log-variance clamped to [-30, 20], z = mean + eps
  * exp(logvar / 2);
- the loss of LDM's ``LPIPSWithDiscriminator`` as far as it applies: the
  reconstruction |x - x_hat| summed over each image, plus ``kl_weight``
  times 0.5 * sum(mean^2 + var - 1 - logvar) over each image, both over
  the real rows of the batch (``mask``).

Departures from LDM's training objective (PERF.md says the same):

- the LPIPS term is left out: its weights are not in the repository (the
  port's ``eval/lpips.py`` needs ``data/lpips_alex.npz``);
- the PatchGAN discriminator is left out: LDM turns it on only at step
  50,001 (``disc_start``);
- the optimizer is AdamW (0.9, 0.999, weight decay 0; ``reference/adamw.py``)
  rather than LDM's Adam (0.5, 0.9); a step does the same work.

LDM's learned output log-variance (``logvar``, initialized at 0) is not in
its autoencoder's optimizer, so it stays 0 and the reconstruction term is
|x - x_hat| as here.

Initial weights follow PyTorch's module defaults: conv and linear weights
and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (fan_in = in channels x
kernel area), norm scales 1 and shifts 0. Gradients come from autograd,
the batch taken ``chunk`` images at a time (the loss is a sum over
images and GroupNorm normalizes each image alone, so the chunks' sums are
the batch's), in full float32: the TF32 flags are off unless ``tf32``.
Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..inputs import Spec, weights
from . import precision

GN_EPS = 1e-6
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0

Tensors = Dict[str, torch.Tensor]


def specs(cfg: Dict) -> List[Spec]:
    """Every weight with PyTorch's default initialization."""
    widths = list(cfg["block_out_channels"])
    layers, lat = cfg["layers_per_block"], cfg["latent_channels"]
    out: List[Spec] = []

    def uniform(name, shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        out.append((f"{name}.weight", shape, "uniform", (-b, b)))
        out.append((f"{name}.bias", (shape[0],), "uniform", (-b, b)))

    def conv(name, cin, cout, k=3):
        uniform(name, (cout, cin, k, k), cin * k * k)

    def norm(name, ch):
        out.append((f"{name}.weight", (ch,), "ones", None))
        out.append((f"{name}.bias", (ch,), "zeros", None))

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, 1)

    def mid(name, ch):
        resnet(f"{name}.resnets.0", ch, ch)
        norm(f"{name}.attentions.0.group_norm", ch)
        for p in ("to_q", "to_k", "to_v", "to_out.0"):
            uniform(f"{name}.attentions.0.{p}", (ch, ch), ch)
        resnet(f"{name}.resnets.1", ch, ch)

    conv("encoder.conv_in", cfg["in_channels"], widths[0])
    cin = widths[0]
    for i, w in enumerate(widths):
        for j in range(layers):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin, w)
            cin = w
        if i < len(widths) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", w, w)
    mid("encoder.mid_block", cin)
    norm("encoder.conv_norm_out", cin)
    conv("encoder.conv_out", cin, 2 * lat)
    rev = widths[::-1]
    conv("decoder.conv_in", lat, rev[0])
    mid("decoder.mid_block", rev[0])
    cin = rev[0]
    for i, w in enumerate(rev):
        for j in range(layers + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin, w)
            cin = w
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", w, w)
    norm("decoder.conv_norm_out", cin)
    conv("decoder.conv_out", cin, cfg["out_channels"])
    return out


def initial_state(cfg: Dict, seed: int, tag: int, device) -> Tensors:
    """The weights as a state dict, drawn from ``seed``."""
    return weights(specs(cfg), seed, tag, device)


def group_norm(h: torch.Tensor, s: Tensors, name: str, groups: int):
    b, c, hh, ww = h.shape
    g = h.reshape(b, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + GN_EPS)).reshape(b, c, hh, ww)
    return (y * s[f"{name}.weight"][:, None, None]
            + s[f"{name}.bias"][:, None, None])


def silu(h: torch.Tensor) -> torch.Tensor:
    return h * torch.sigmoid(h)


def conv(h, s: Tensors, name: str, stride: int = 1, padding: int = 1):
    return F.conv2d(h, s[f"{name}.weight"], s[f"{name}.bias"], stride,
                    padding)


def linear(t, s: Tensors, name: str):
    return t @ s[f"{name}.weight"].T + s[f"{name}.bias"]


def resnet(h, s: Tensors, name: str, groups: int):
    x = h
    h = conv(silu(group_norm(h, s, f"{name}.norm1", groups)), s,
             f"{name}.conv1")
    h = conv(silu(group_norm(h, s, f"{name}.norm2", groups)), s,
             f"{name}.conv2")
    if f"{name}.conv_shortcut.weight" in s:
        x = conv(x, s, f"{name}.conv_shortcut", padding=0)
    return x + h


def attention(h, s: Tensors, name: str, groups: int):
    b, c, hh, ww = h.shape
    t = group_norm(h, s, f"{name}.group_norm", groups)
    t = t.reshape(b, c, hh * ww).transpose(1, 2)
    q, k, v = (linear(t, s, f"{name}.{p}") for p in ("to_q", "to_k",
                                                      "to_v"))
    w = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
    o = linear(w @ v, s, f"{name}.to_out.0")
    return h + o.transpose(1, 2).reshape(b, c, hh, ww)


def mid(h, s: Tensors, name: str, groups: int):
    h = resnet(h, s, f"{name}.resnets.0", groups)
    h = attention(h, s, f"{name}.attentions.0", groups)
    return resnet(h, s, f"{name}.resnets.1", groups)


def encode(cfg: Dict, s: Tensors, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) -> mean, clamped log-variance (B, h, w, latent)."""
    groups, layers = cfg["norm_num_groups"], cfg["layers_per_block"]
    n_levels = len(cfg["block_out_channels"])
    h = conv(x.permute(0, 3, 1, 2), s, "encoder.conv_in")
    for i in range(n_levels):
        for j in range(layers):
            h = resnet(h, s, f"encoder.down_blocks.{i}.resnets.{j}", groups)
        if i < n_levels - 1:
            h = conv(F.pad(h, (0, 1, 0, 1)), s,
                     f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     stride=2, padding=0)
    h = mid(h, s, "encoder.mid_block", groups)
    h = conv(silu(group_norm(h, s, "encoder.conv_norm_out", groups)), s,
             "encoder.conv_out")
    mean, logvar = h.permute(0, 2, 3, 1).chunk(2, dim=-1)
    return mean, torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX)


def decode(cfg: Dict, s: Tensors, z: torch.Tensor) -> torch.Tensor:
    """z (B, h, w, latent) -> images (B, H, W, C)."""
    groups, layers = cfg["norm_num_groups"], cfg["layers_per_block"]
    n_levels = len(cfg["block_out_channels"])
    h = conv(z.permute(0, 3, 1, 2), s, "decoder.conv_in")
    h = mid(h, s, "decoder.mid_block", groups)
    for i in range(n_levels):
        for j in range(layers + 1):
            h = resnet(h, s, f"decoder.up_blocks.{i}.resnets.{j}", groups)
        if i < n_levels - 1:
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = conv(h, s, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    h = conv(silu(group_norm(h, s, "decoder.conv_norm_out", groups)), s,
             "decoder.conv_out")
    return h.permute(0, 2, 3, 1)


def train_loss(cfg: Dict, s: Tensors, x, mask, eps, n) -> torch.Tensor:
    """The loss's share of the rows ``x`` (noise ``eps``, (B, h, w,
    latent)) in a batch of ``n`` real rows."""
    mean, logvar = encode(cfg, s, x)
    x_hat = decode(cfg, s, mean + eps * torch.exp(0.5 * logvar))
    recon = ((x_hat - x).abs().sum((1, 2, 3)) * mask).sum()
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    kl = (kl.sum((1, 2, 3)) * mask).sum()
    return (recon + cfg["vae_train"]["kl_weight"] * kl) / n


def gradients(cfg: Dict, params: Tensors, x, mask, eps, chunk: int = 4,
              tf32: bool = False) -> Tuple[torch.Tensor, Tensors]:
    """(loss, gradient of each of ``params``, weights that require it) of
    the batch, ``chunk`` images at a time."""
    names = list(params)
    n = torch.clamp_min(mask.sum(), 1.0)
    loss, grads = torch.zeros((), device=x.device), None
    with precision(tf32):
        for i in range(0, x.shape[0], chunk):
            part = train_loss(cfg, params, x[i:i + chunk],
                              mask[i:i + chunk], eps[i:i + chunk], n)
            g = torch.autograd.grad(part, [params[k] for k in names])
            loss = loss + part.detach()
            grads = list(g) if grads is None else [
                a + b for a, b in zip(grads, g)]
    return loss, dict(zip(names, grads))
