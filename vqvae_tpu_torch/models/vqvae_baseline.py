"""End-to-end EMA VQ-VAE baseline — the port of
``vqvae_tpu/models/vqvae_baseline.py``.

Encoder: a 32 -> 16 -> 8 stride-2 stem (4x4 convs, padding 1), a 3x3 conv
to ``z_channels``, ``n_res`` ResBlocks (ReLU, 3x3, ReLU, 1x1, residual)
and a 1x1 out conv. Decoder: a 1x1 conv, the ResBlocks, ReLU, two 4x4
stride-2 transposed convs and a 1x1 conv under a tanh head in [-1, 1].
flax's ``ConvTranspose(4, strides 2, padding ((2, 2), (2, 2)))`` is
torch's ``ConvTranspose2d(k=4, s=2, padding=1)`` with the kernel flipped
spatially (``utils/checkpoint.vqvae_state_dict_from_jax`` does the flip).
Modules compute in NCHW; ``encode`` / ``decode`` keep the JAX package's
NHWC layout.

The EMA codebook is plain state beside the model (``CodebookState``: three
tensors), updated by pure functions as in JAX: ``quantize`` (a torch
product and argmin of ``|x|^2 - 2 x.e + |e|^2``, the JAX formula; ties take
the first index), ``ema_update`` (Laplace smoothing, NaN and clamp
guards), ``straight_through``, ``commitment_loss``, ``reseed_dead_codes``
and ``perplexity``. Randomness comes from explicit ``torch.Generator``s.
Under a data-parallel ``mesh`` ``ema_update`` sums the codes' counts and
latent sums over ranks, so every rank keeps the global batch's codebook.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Tuple

import torch
from torch import nn

from ..parallel.mesh import all_reduce_sum


class ResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv_1 = nn.Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_0(torch.relu(x))
        return x + self.conv_1(torch.relu(h))


class VQEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, hidden: int = 256,
                 z_channels: int = 128, n_res: int = 2):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, hidden // 2, 4, stride=2,
                                padding=1)
        self.conv_1 = nn.Conv2d(hidden // 2, hidden, 4, stride=2, padding=1)
        self.conv_2 = nn.Conv2d(hidden, z_channels, 3, padding=1)
        self.res = nn.ModuleList(ResBlock(z_channels) for _ in range(n_res))
        self.conv_3 = nn.Conv2d(z_channels, z_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv_0(x))
        h = self.conv_2(torch.relu(self.conv_1(h)))
        for blk in self.res:
            h = blk(h)
        return self.conv_3(h)


class VQDecoder(nn.Module):
    def __init__(self, out_channels: int = 3, hidden: int = 256,
                 z_channels: int = 128, n_res: int = 2):
        super().__init__()
        self.conv_0 = nn.Conv2d(z_channels, z_channels, 1)
        self.res = nn.ModuleList(ResBlock(z_channels) for _ in range(n_res))
        self.convt_0 = nn.ConvTranspose2d(z_channels, hidden, 4, stride=2,
                                          padding=1)
        self.convt_1 = nn.ConvTranspose2d(hidden, hidden // 2, 4, stride=2,
                                          padding=1)
        self.conv_1 = nn.Conv2d(hidden // 2, out_channels, 1)

    def forward(self, z_q: torch.Tensor) -> torch.Tensor:
        h = self.conv_0(z_q)
        for blk in self.res:
            h = blk(h)
        h = torch.relu(self.convt_0(torch.relu(h)))
        h = torch.relu(self.convt_1(h))
        return torch.tanh(self.conv_1(h))


class VQVAE(nn.Module):
    """Encoder/decoder pair; quantization happens outside, on a
    ``CodebookState``. ``encode`` / ``decode`` take and give NHWC."""

    def __init__(self, in_channels: int = 3, z_channels: int = 128,
                 hidden: int = 256, n_res_blocks: int = 2):
        super().__init__()
        self.in_channels = in_channels
        self.z_channels = z_channels
        self.hidden = hidden
        self.n_res_blocks = n_res_blocks
        self.enc = VQEncoder(in_channels, hidden, z_channels, n_res_blocks)
        self.dec = VQDecoder(in_channels, hidden, z_channels, n_res_blocks)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.enc(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.dec(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Quantization-free passthrough."""
        return self.decode(self.encode(x))


@dataclass
class CodebookState:
    """The EMA codebook: ``embed`` (K, C), ``cluster_size`` (K,) and
    ``embed_avg`` (K, C)."""

    embed: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor

    @staticmethod
    def create(generator: torch.Generator, n_codes: int, code_dim: int,
               device=None) -> "CodebookState":
        """Standard-normal codes drawn by ``generator`` on its own device
        (then moved to ``device``); ``embed_avg`` is a distinct copy."""
        embed = torch.randn((n_codes, code_dim), generator=generator,
                            device=generator.device)
        embed = embed.to(device if device is not None else embed.device)
        return CodebookState(embed=embed,
                             cluster_size=torch.zeros(n_codes,
                                                      device=embed.device),
                             embed_avg=embed.clone())

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def to(self, device) -> "CodebookState":
        return CodebookState(**{k: v.to(device)
                                for k, v in self.as_dict().items()})


def quantize(cb: CodebookState, z_e: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest code. z_e (B, H, W, C) -> (z_q (B, H, W, C), idx (B, H, W))."""
    B, H, W, C = z_e.shape
    flat = z_e.reshape(-1, C).float()
    e = cb.embed
    d = ((flat ** 2).sum(1, keepdim=True)
         - 2.0 * flat @ e.T
         + (e ** 2).sum(1))
    idx = torch.argmin(d, dim=1)
    return e[idx].reshape(B, H, W, C), idx.reshape(B, H, W)


def ema_update(cb: CodebookState, z_e: torch.Tensor, idx: torch.Tensor,
               decay: float = 0.99, eps: float = 1e-5,
               mesh=None) -> CodebookState:
    """One EMA codebook update with Laplace smoothing and the NaN / clamp
    guards; under a ``mesh`` the counts and sums of the global batch."""
    n_codes, code_dim = cb.embed.shape
    flat = z_e.reshape(-1, code_dim).float()
    flat_idx = idx.reshape(-1)
    counts = torch.bincount(flat_idx, minlength=n_codes).float()
    embed_sum = torch.zeros_like(cb.embed).index_add_(0, flat_idx, flat)
    both = all_reduce_sum(torch.cat([counts[:, None], embed_sum], 1), mesh)
    counts, embed_sum = both[:, 0], both[:, 1:]

    cluster_size = cb.cluster_size * decay + counts * (1.0 - decay)
    embed_avg = cb.embed_avg * decay + embed_sum * (1.0 - decay)

    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + n_codes * eps) * n
    denom = torch.clamp_min(smoothed, eps)[:, None]
    embed = torch.nan_to_num(embed_avg / denom, nan=0.0, posinf=1.0,
                             neginf=-1.0)
    return CodebookState(embed=torch.clamp(embed, -2.0, 2.0),
                         cluster_size=cluster_size, embed_avg=embed_avg)


def straight_through(z_e: torch.Tensor, z_q: torch.Tensor) -> torch.Tensor:
    return z_e + (z_q - z_e).detach()


def commitment_loss(z_e: torch.Tensor, z_q: torch.Tensor,
                    beta: float = 0.25) -> torch.Tensor:
    """beta * mse(stop_grad(z_q), z_e)."""
    return beta * torch.mean((z_q.detach() - z_e.float()) ** 2)


def reseed_dead_codes(generator: torch.Generator, cb: CodebookState,
                      sample_bank: torch.Tensor, min_count: float = 5.0
                      ) -> Tuple[CodebookState, int]:
    """Replace the codes whose EMA count is under ``min_count`` by bank
    latents drawn (with replacement) by ``generator``; their count becomes
    ``min_count``. A bank of another width, or an empty one, changes
    nothing. Returns (new state, number of codes reseeded)."""
    n_codes, code_dim = cb.embed.shape
    n_bank = sample_bank.shape[0]
    if sample_bank.shape[-1] != code_dim or n_bank == 0:
        return cb, 0
    dead = cb.cluster_size < min_count
    picks = torch.randint(0, n_bank, (n_codes,), generator=generator,
                          device=generator.device).to(sample_bank.device)
    new_vecs = sample_bank[picks].float()
    embed = torch.where(dead[:, None], new_vecs, cb.embed)
    embed_avg = torch.where(dead[:, None], new_vecs, cb.embed_avg)
    cluster_size = torch.where(dead, torch.full_like(cb.cluster_size,
                                                     min_count),
                               cb.cluster_size)
    return (CodebookState(embed, cluster_size, embed_avg),
            int(dead.sum()))


def perplexity(idx: torch.Tensor, n_codes: int) -> torch.Tensor:
    hist = torch.bincount(idx.reshape(-1), minlength=n_codes).float()
    p = hist / torch.clamp_min(hist.sum(), 1.0)
    ent = -(p * torch.log(torch.clamp_min(p, 1e-12))).sum()
    return torch.exp(ent)
