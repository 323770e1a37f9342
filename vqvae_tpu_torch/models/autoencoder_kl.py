"""The KL-regularized autoencoder of latent diffusion (``AutoencoderKL``),
as FLUX.1 configures it, with the interface ``VAEEngine`` trains.

The Encoder/Decoder of Rombach et al. 2022 (CompVis/latent-diffusion,
``ldm/modules/diffusionmodules/model.py``), in float32 and NCHW inside:

- ResNet block: GroupNorm, SiLU, 3x3 conv, GroupNorm, SiLU, 3x3 conv, plus
  the input (through a 1x1 conv where the width changes);
- down sampler: pad the right and bottom by one, 3x3 conv of stride 2;
  up sampler: nearest x2, 3x3 conv;
- mid block: ResNet block, one single-head self-attention over the grid
  (GroupNorm, linear q, k and v, softmax(q k^T / sqrt(C)) v by
  ``scaled_dot_product_attention``, a linear out, the input added), ResNet
  block;
- the encoder ends in GroupNorm, SiLU and a 3x3 conv to mean and
  log-variance (``double_z``), the log-variance clamped to [-30, 20]; the
  decoder starts with a 3x3 conv from the latent and ends in GroupNorm,
  SiLU and a 3x3 conv to the image.

GroupNorm takes ``norm_num_groups`` groups and eps 1e-6. There are no
quant convs (FLUX.1's ``use_quant_conv`` and ``use_post_quant_conv`` are
false). The state-dict names are diffusers' ``AutoencoderKL``'s
(``encoder.down_blocks.0.resnets.0.norm1.weight``,
``encoder.mid_block.attentions.0.to_q.weight``,
``decoder.up_blocks.0.upsamplers.0.conv.weight``, ...), so its published
weights load with ``load_state_dict``.

Images are NHWC in [-1, 1] (``signed_images``); ``encode`` returns NHWC
mean and log-variance grids, ``decode`` NHWC images; the training loss is
LDM's reconstruction term |x - x_hat| summed per image with the KL term
weighted by ``beta`` (``elbo_loss``'s ``l1`` branch). ``init_weights``
draws PyTorch's module defaults from a generator.

Spans (``utils/profiling``): ``vqvae.kl.encode``, ``vqvae.kl.decode`` and
``vqvae.kl.attention`` (each mid-block attention), and the counter
``vqvae.kl.attention_tokens`` (batch x grid height x width, per attention
call).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import count, span
from .vae import GroupNorm, elbo_loss, reparameterize

LOGVAR_RANGE = (-30.0, 20.0)
NORM_EPS = 1e-6


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=NORM_EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps=NORM_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Single-head self-attention over the grid with a residual."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=NORM_EPS)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vqvae.kl.attention"):
            b, c, h, w = x.shape
            count("vqvae.kl.attention_tokens", b * h * w)
            t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
            # (B, 1 head, tokens, C): the scale is 1 / sqrt(C)
            q, k, v = (f(t)[:, None] for f in (self.to_q, self.to_k,
                                                self.to_v))
            o = self.to_out[0](F.scaled_dot_product_attention(q, k, v)[:, 0])
            return x + o.transpose(1, 2).reshape(b, c, h, w)


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """A down (``DownEncoderBlock2D``) or up (``UpDecoderBlock2D``) level:
    ``n`` ResNet blocks, then its sampler, if any."""

    def __init__(self, cin: int, cout: int, n: int, groups: int,
                 sampler: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(cin if i == 0 else cout, cout, groups)
            for i in range(n))
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for s in getattr(self, "downsamplers", getattr(self, "upsamplers",
                                                        ())):
            x = s(x)
        return x


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups),
                                      ResnetBlock2D(ch, ch, groups)])
        self.attentions = nn.ModuleList([Attention(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class Encoder(nn.Module):
    def __init__(self, in_channels: int, widths: Sequence[int],
                 layers_per_block: int, latent_channels: int, groups: int):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, widths[0], 3, padding=1)
        last = len(widths) - 1
        self.down_blocks = nn.ModuleList(
            _Level(widths[max(i - 1, 0)], w, layers_per_block, groups,
                   None if i == last else "down")
            for i, w in enumerate(widths))
        self.mid_block = MidBlock(widths[-1], groups)
        self.conv_norm_out = GroupNorm(groups, widths[-1], eps=NORM_EPS)
        self.conv_out = nn.Conv2d(widths[-1], 2 * latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, out_channels: int, widths: Sequence[int],
                 layers_per_block: int, latent_channels: int, groups: int):
        super().__init__()
        rev = list(reversed(widths))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], groups)
        last = len(rev) - 1
        self.up_blocks = nn.ModuleList(
            _Level(rev[max(i - 1, 0)], w, layers_per_block + 1, groups,
                   None if i == last else "up")
            for i, w in enumerate(rev))
        self.conv_norm_out = GroupNorm(groups, rev[-1], eps=NORM_EPS)
        self.conv_out = nn.Conv2d(rev[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """FLUX.1's ``AutoencoderKL`` (defaults: its ``vae/config.json``)."""

    apply_sigmoid = False
    signed_images = True  # pixels in [-1, 1]
    recon_loss = "l1"
    topology = "spatial"

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 16,
                 norm_num_groups: int = 32):
        super().__init__()
        widths = tuple(block_out_channels)
        self.latent_dim = latent_channels
        self.encoder = Encoder(in_channels, widths, layers_per_block,
                               latent_channels, norm_num_groups)
        self.decoder = Decoder(out_channels, widths, layers_per_block,
                               latent_channels, norm_num_groups)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) -> mean, clamped log-variance (B, h, w, latent)."""
        with span("vqvae.kl.encode"):
            moments = self.encoder(x.permute(0, 3, 1, 2).contiguous())
            mu, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
            return mu, torch.clamp(logvar, *LOGVAR_RANGE)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, h, w, latent) -> images (B, H, W, C)."""
        with span("vqvae.kl.decode"):
            out = self.decoder(z.permute(0, 3, 1, 2).contiguous())
            return out.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise_rows: Optional[Tuple[int, int]] = None):
        """x (B, H, W, C) -> (x_hat, mu, logvar, z), as ``VAE.forward``."""
        mu, logvar = self.encode(x)
        z = mu if generator is None else reparameterize(
            mu, logvar, generator, rows=noise_rows)
        return self.decode(z), mu, logvar, z

    def loss(self, x, x_hat, mu, logvar, *, beta: float,
             mask: Optional[torch.Tensor] = None, step: int = 0, mesh=None):
        """|x - x_hat| summed per image plus ``beta`` times the KL, over
        the real rows (``elbo_loss``)."""
        return elbo_loss(x, x_hat, mu, logvar, recon_loss="l1",
                         mse_use_sigmoid=False, topology="spatial",
                         beta=beta, mask=mask, mesh=mesh)

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        """PyTorch's module defaults drawn from ``generator`` (on its own
        device): conv and linear weights and biases U(-1/sqrt(fan_in),
        1/sqrt(fan_in)), fan_in = in channels x kernel area; norm scales
        1 and shifts 0."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    w = mod.weight
                    bound = 1.0 / math.sqrt(w[0].numel())
                    for p in (w, mod.bias):
                        p.copy_(torch.empty(p.shape, device=generator.device)
                                .uniform_(-bound, bound, generator=generator))
                elif isinstance(mod, nn.GroupNorm):
                    mod.reset_parameters()
        return self
