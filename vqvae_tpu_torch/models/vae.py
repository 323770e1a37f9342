"""Convolutional VAEs (flat-latent and spatial-grid) as torch modules.

The port of ``vqvae_tpu/models/vae.py`` (encoder, decoder and ``decode``;
losses and training come with the VAE-training slice). Submodules carry
the reference implementation's state-dict names, so a reference
``{'model_state_dict', 'epoch'}`` checkpoint loads with ``load_state_dict``
unchanged:

- encoder: ``encoder.conv_layers.{3i}`` (+ norm at ``3i+1``),
  ``encoder.fc_mu`` / ``encoder.fc_logvar`` (1x1 convs when spatial,
  linears over the C-major flatten when flat);
- spatial decoder: ``decoder.conv_in``, ``decoder.deconv_layers.{0,1,3,4,6}``;
- flat decoder: ``decoder.fc``, ``decoder.deconv1/2`` and
  ``decoder.output_layer``.

Modules compute in NCHW; the public ``encode``/``decode`` keep the JAX
package's NHWC layout, so spatial latents are (B, 4, 4, C) on both sides.
Transposed-conv geometry: the flax padding ``(lo, hi)`` of the JAX
decoder is torch's ``(k-1-p, k-1-p+op)``, so the 28-px spatial head is
``ConvTranspose2d(k=4, s=2, p=3)``, the 32-px head ``p=1`` and the trunk
``k4 s2 p1``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


def _norm(norm_type: str, ch: int) -> nn.Module:
    """Norm layer matching the JAX package's factory: batch / group (<=32
    groups dividing the channel count) / none."""
    norm_type = (norm_type or "none").lower()
    if norm_type == "batch":
        return nn.BatchNorm2d(ch, eps=1e-5)
    if norm_type == "group":
        groups = max(1, min(32, ch))
        while ch % groups != 0 and groups > 1:
            groups -= 1
        return nn.GroupNorm(groups, ch, eps=1e-6)  # flax GroupNorm epsilon
    return nn.Identity()


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 1,
                 channels: Sequence[int] = (32, 64, 128),
                 latent_dim: int = 16, norm_type: str = "none",
                 topology: str = "flat"):
        super().__init__()
        self.topology = topology
        layers, cin = [], in_channels
        for ch in channels:
            layers += [nn.Conv2d(cin, ch, 3, stride=2, padding=1),
                       _norm(norm_type, ch), nn.ReLU()]
            cin = ch
        self.conv_layers = nn.Sequential(*layers)
        if topology == "spatial":
            self.fc_mu = nn.Conv2d(cin, latent_dim, 1)
            self.fc_logvar = nn.Conv2d(cin, latent_dim, 1)
        else:
            self.fc_mu = nn.Linear(cin * 16, latent_dim)
            self.fc_logvar = nn.Linear(cin * 16, latent_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) -> (mu, logvar), NHWC grids when spatial."""
        h = self.conv_layers(x.permute(0, 3, 1, 2))
        if self.topology == "spatial":
            return (self.fc_mu(h).permute(0, 2, 3, 1),
                    self.fc_logvar(h).permute(0, 2, 3, 1))
        h = h.flatten(1)  # C-major, as the reference flattens
        return self.fc_mu(h), self.fc_logvar(h)


class Decoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (128, 64, 32),
                 latent_dim: int = 16, out_channels: int = 1,
                 output_image_size: int = 28, norm_type: str = "none",
                 topology: str = "flat"):
        super().__init__()
        self.topology = topology
        chs = tuple(channels)
        if output_image_size not in (28, 32):
            raise ValueError(f"Unsupported output size: {output_image_size}")
        if topology == "spatial":
            # 4 -> 8 -> 16 -> {28, 32}: two k4s2p1 deconvs, then the head
            self.conv_in = nn.Conv2d(latent_dim, chs[0], 1)
            layers, cin = [], chs[0]
            for ch in chs[1:3]:
                layers += [nn.ConvTranspose2d(cin, ch, 4, stride=2, padding=1),
                           _norm(norm_type, ch), nn.ReLU()]
                cin = ch
            head_pad = 1 if output_image_size == 32 else 3
            layers.append(nn.ConvTranspose2d(cin, out_channels, 4, stride=2,
                                             padding=head_pad))
            self.deconv_layers = nn.Sequential(*layers)
        else:
            # 4 -> {7, 8} -> {14, 16} -> {28, 32}
            op = 1 if output_image_size == 32 else 0
            self.fc = nn.Linear(latent_dim, chs[0] * 16)
            self.deconv1 = nn.Sequential(
                nn.ConvTranspose2d(chs[0], chs[1], 3, stride=2, padding=1,
                                   output_padding=op),
                _norm(norm_type, chs[1]), nn.ReLU())
            self.deconv2 = nn.Sequential(
                nn.ConvTranspose2d(chs[1], chs[2], 4, stride=2, padding=1),
                _norm(norm_type, chs[2]), nn.ReLU())
            self.output_layer = nn.ConvTranspose2d(chs[2], out_channels, 4,
                                                   stride=2, padding=1)
        self._ch0 = chs[0]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, H, W, latent) spatial or (B, latent) flat -> NHWC logits."""
        if self.topology == "spatial":
            h = self.deconv_layers(self.conv_in(z.permute(0, 3, 1, 2)))
        else:
            h = self.fc(z).view(-1, self._ch0, 4, 4)
            h = self.output_layer(self.deconv2(self.deconv1(h)))
        return h.permute(0, 2, 3, 1)


class VAE(nn.Module):
    """Unified conv VAE. ``topology`` selects flat vs spatial latents."""

    def __init__(self, in_channels: int = 1,
                 enc_channels: Sequence[int] = (32, 64, 128),
                 dec_channels: Sequence[int] = (128, 64, 32),
                 latent_dim: int = 16, recon_loss: str = "bce",
                 output_image_size: int = 28, norm_type: str = "none",
                 mse_use_sigmoid: bool = True, topology: str = "flat"):
        super().__init__()
        if recon_loss not in ("bce", "mse"):
            raise ValueError(f"recon_loss must be bce or mse, got {recon_loss}")
        self.in_channels = in_channels
        self.enc_channels = tuple(enc_channels)
        self.dec_channels = tuple(dec_channels)
        self.latent_dim = latent_dim
        self.recon_loss = recon_loss
        self.output_image_size = output_image_size
        self.norm_type = (norm_type or "none").lower()
        self.mse_use_sigmoid = mse_use_sigmoid
        self.topology = topology
        self.encoder = Encoder(in_channels, enc_channels, latent_dim,
                               norm_type, topology)
        self.decoder = Decoder(dec_channels, latent_dim, in_channels,
                               output_image_size, norm_type, topology)

    def encode(self, x: torch.Tensor):
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
