"""Convolutional VAEs (flat-latent and spatial-grid) as torch modules.

The port of ``vqvae_tpu/models/vae.py``: encoder, decoder, the training
forward with ``reparameterize``, ``elbo_loss`` on every branch, and
``flax_init_``, which draws the flax default initialization. Submodules
carry the reference implementation's state-dict names, so a reference
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

BatchNorm follows flax, not torch (``BatchNorm``): training takes the
batch statistics from the per-channel count, sum and sum of squares with
flax's fast variance ``max(E[x^2] - E[x]^2, 0)``, the padded rows of a
last batch counted as they are there, and the running statistics move by
flax's momentum 0.99 (torch's 0.01) towards that biased variance. The
statistics, the normalization and its gradient are evaluated in float64
and rounded once to float32.

``dtype`` (flax's): the parameters stay float32 and every conv, dense and
transposed conv computes in ``dtype`` (``models/cast.py``); the norms
normalize in float32 and return ``dtype``, with float32 running
statistics; the encoder returns float32 mu and logvar and the decoder
float32 logits, as the JAX model casts them.

Data parallelism (``parallel.Mesh``): ``set_batchnorm_mesh`` makes every
BatchNorm sum its count, sum and sum of squares over the global batch, as
flax's statistics run under a sharded ``jit``; without a process group
that sum is the identity, so one process and a mesh run the same code.
``elbo_loss(..., mesh=)`` divides by the global ``mask.sum()`` with the
capacity term on the global KL.

``decode_to_image``: sigmoid(decoder(z)) flattened to (B, pixels), the map
whose Jacobian defines the pullback metric.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.mesh import all_reduce_sum, global_value
from .cast import (Conv2d, ConvTranspose2d, Linear, resolve_dtype,
                   set_compute_dtype)

# flax's truncated-normal variance scaling divides the target std by the
# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` with ``nn.BatchNorm2d``'s state-dict names.

    Training (one path for one process and a mesh,
    ``ops.batchnorm.batch_norm_train``: hand-written kernels on a card, the
    plain version on the CPU): the per-channel count, sum and sum of
    squares in float64, summed over ``self.mesh``'s ranks when one is set
    (``set_batchnorm_mesh``), and flax's fast biased variance ``max(E[x^2]
    - E[x]^2, 0)``; then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    and its gradient (it reaches every rank's rows), rounded to float32 and
    cast to the input's dtype; ``running = m * running + (1 - m) * batch``
    with flax's momentum ``m`` = 0.99 and the float32 mean and variance
    (torch's update would use momentum 0.1 and the unbiased variance).

    Eval mode: ``nn.BatchNorm2d``'s for float32; a half precision input is
    normalized by the running statistics in float32 and cast back.
    """

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__(ch, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum
        self.mesh = None  # set_batchnorm_mesh: global training statistics

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._forward_train(x)
        if x.dtype == torch.float32:
            return super().forward(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean[:, None, None])
                * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)

    def _forward_train(self, x: torch.Tensor) -> torch.Tensor:
        with span("vqvae.vae.batchnorm"):
            return batch_norm_train(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.num_batches_tracked, self.eps,
                self.flax_momentum, self.mesh)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``; a half precision input is normalized in float32
    and the result cast back."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return super().forward(x.float()).to(x.dtype)
        return super().forward(x)


def set_batchnorm_mesh(model: nn.Module, mesh) -> nn.Module:
    """Every ``BatchNorm`` of ``model`` takes its training statistics over
    ``mesh``'s global batch (``None``: this process's batch)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.mesh = mesh
    return model


def _norm(norm_type: str, ch: int) -> nn.Module:
    """Norm layer matching the JAX package's factory: batch / group (<=32
    groups dividing the channel count) / none."""
    norm_type = (norm_type or "none").lower()
    if norm_type == "batch":
        return BatchNorm(ch, eps=1e-5)
    if norm_type == "group":
        groups = max(1, min(32, ch))
        while ch % groups != 0 and groups > 1:
            groups -= 1
        return GroupNorm(groups, ch, eps=1e-6)  # flax GroupNorm epsilon
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
            layers += [Conv2d(cin, ch, 3, stride=2, padding=1),
                       _norm(norm_type, ch), nn.ReLU()]
            cin = ch
        self.conv_layers = nn.Sequential(*layers)
        if topology == "spatial":
            self.fc_mu = Conv2d(cin, latent_dim, 1)
            self.fc_logvar = Conv2d(cin, latent_dim, 1)
        else:
            self.fc_mu = Linear(cin * 16, latent_dim)
            self.fc_logvar = Linear(cin * 16, latent_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) -> (mu, logvar), NHWC grids when spatial."""
        h = self.conv_layers(x.permute(0, 3, 1, 2))
        if self.topology == "spatial":
            return (self.fc_mu(h).permute(0, 2, 3, 1).float(),
                    self.fc_logvar(h).permute(0, 2, 3, 1).float())
        h = h.flatten(1)  # C-major, as the reference flattens
        return self.fc_mu(h).float(), self.fc_logvar(h).float()


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
            self.conv_in = Conv2d(latent_dim, chs[0], 1)
            layers, cin = [], chs[0]
            for ch in chs[1:3]:
                layers += [ConvTranspose2d(cin, ch, 4, stride=2, padding=1),
                           _norm(norm_type, ch), nn.ReLU()]
                cin = ch
            head_pad = 1 if output_image_size == 32 else 3
            layers.append(ConvTranspose2d(cin, out_channels, 4, stride=2,
                                          padding=head_pad))
            self.deconv_layers = nn.Sequential(*layers)
        else:
            # 4 -> {7, 8} -> {14, 16} -> {28, 32}
            op = 1 if output_image_size == 32 else 0
            self.fc = Linear(latent_dim, chs[0] * 16)
            self.deconv1 = nn.Sequential(
                ConvTranspose2d(chs[0], chs[1], 3, stride=2, padding=1,
                                output_padding=op),
                _norm(norm_type, chs[1]), nn.ReLU())
            self.deconv2 = nn.Sequential(
                ConvTranspose2d(chs[1], chs[2], 4, stride=2, padding=1),
                _norm(norm_type, chs[2]), nn.ReLU())
            self.output_layer = ConvTranspose2d(chs[2], out_channels, 4,
                                                stride=2, padding=1)
        self._ch0 = chs[0]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, H, W, latent) spatial or (B, latent) flat -> NHWC logits."""
        if self.topology == "spatial":
            h = self.deconv_layers(self.conv_in(z.permute(0, 3, 1, 2)))
        else:
            h = self.fc(z).view(-1, self._ch0, 4, 4)
            h = self.output_layer(self.deconv2(self.deconv1(h)))
        return h.permute(0, 2, 3, 1).float()


class VAE(nn.Module):
    """Unified conv VAE. ``topology`` selects flat vs spatial latents."""

    signed_images = False  # pixels in [0, 1] (or standardized)

    def __init__(self, in_channels: int = 1,
                 enc_channels: Sequence[int] = (32, 64, 128),
                 dec_channels: Sequence[int] = (128, 64, 32),
                 latent_dim: int = 16, recon_loss: str = "bce",
                 output_image_size: int = 28, norm_type: str = "none",
                 mse_use_sigmoid: bool = True, topology: str = "flat",
                 free_bits: float = 0.5, capacity_max: float = 15.0,
                 capacity_anneal_steps: int = 50_000,
                 capacity_mode: str = "abs",
                 spatial_free_bits: Optional[float] = None,
                 dtype="float32"):
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
        # training-only: the loss's regularization (flat free bits and
        # capacity annealing; spatial free bits, off by default)
        self.free_bits = free_bits
        self.capacity_max = capacity_max
        self.capacity_anneal_steps = capacity_anneal_steps
        self.capacity_mode = capacity_mode
        self.spatial_free_bits = spatial_free_bits
        self.encoder = Encoder(in_channels, enc_channels, latent_dim,
                               norm_type, topology)
        self.decoder = Decoder(dec_channels, latent_dim, in_channels,
                               output_image_size, norm_type, topology)
        self.compute_dtype = resolve_dtype(dtype)
        set_compute_dtype(self, dtype)

    def encode(self, x: torch.Tensor):
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise_rows: Optional[Tuple[int, int]] = None):
        """x (B, H, W, C) -> (logits, mu, logvar, z); z is sampled with
        ``generator`` (on its own device) when one is given, else z = mu.
        ``noise_rows`` (start, total): x holds rows ``start:start + B`` of
        a global batch of ``total`` rows, whose noise is drawn whole."""
        mu, logvar = self.encoder(x)
        z = mu if generator is None else reparameterize(
            mu, logvar, generator, rows=noise_rows)
        return self.decoder(z), mu, logvar, z

    @property
    def apply_sigmoid(self) -> bool:
        return self.recon_loss == "bce" or self.mse_use_sigmoid

    def loss(self, x, x_logits, mu, logvar, *, beta: float,
             mask: Optional[torch.Tensor] = None, step: int = 0,
             mesh=None):
        """``elbo_loss`` with this model's loss settings."""
        return elbo_loss(
            x, x_logits, mu, logvar, recon_loss=self.recon_loss,
            mse_use_sigmoid=self.mse_use_sigmoid, topology=self.topology,
            beta=beta, mask=mask, free_bits=self.free_bits,
            capacity_max=self.capacity_max,
            capacity_anneal_steps=self.capacity_anneal_steps,
            capacity_mode=self.capacity_mode, step=step,
            spatial_free_bits=self.spatial_free_bits, mesh=mesh)


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight as flax's defaults do: lecun-normal truncated
    kernels (std sqrt(1/fan_in) / 0.8796, cut at two std; fan_in =
    kh*kw*in for convs and transposed convs alike, ``in`` for dense) and
    zero biases; norm scales 1 and shifts 0. The bits differ from JAX's
    (another generator); the distributions do not."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                if isinstance(mod, nn.Linear):
                    fan_in = w.shape[1]
                else:  # Conv2d (O, I, kh, kw); ConvTranspose2d (I, O, ...)
                    cin = w.shape[0 if isinstance(mod, nn.ConvTranspose2d)
                                  else 1]
                    fan_in = cin * w.shape[2] * w.shape[3]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                # drawn where the generator lives, so every device gets
                # the same weights from one seed
                w.copy_(nn.init.trunc_normal_(
                    torch.empty(w.shape, device=generator.device), 0.0,
                    std, -2.0 * std, 2.0 * std, generator=generator))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
                mod.reset_parameters()
    return model


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: torch.Generator,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """mu + eps * exp(logvar / 2), eps ~ N(0, 1) drawn by ``generator`` on
    its own device and moved to mu's. The engine's generators live on the
    model's device; a CPU generator gives every device the same noise, as
    checks of the card against the CPU need. ``rows`` (start, total): mu
    holds rows ``start:start + B`` of a batch of ``total``; the noise of
    the whole batch is drawn and those rows taken, so a rank of a
    data-parallel group draws what one process would."""
    std = torch.exp(0.5 * logvar)
    shape = mu.shape if rows is None else (rows[1], *mu.shape[1:])
    eps = torch.randn(shape, generator=generator, dtype=mu.dtype,
                      device=generator.device)
    if rows is not None:
        eps = eps[rows[0]:rows[0] + mu.shape[0]]
    return mu + eps.to(mu.device) * std


def decode_to_image(model: VAE, z: torch.Tensor) -> torch.Tensor:
    """sigmoid(model.decode(z)) flattened to (B, pixels): the map whose
    Jacobian defines the pullback metric (``ops.riemannian``)."""
    img = torch.sigmoid(model.decode(z))
    return img.reshape(img.shape[0], -1)


def elbo_loss(
    x: torch.Tensor,
    x_logits: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    *,
    recon_loss: str,
    mse_use_sigmoid: bool,
    topology: str,
    beta: float,
    mask: Optional[torch.Tensor] = None,
    free_bits: Optional[float] = None,
    capacity_max: float = 0.0,
    capacity_anneal_steps: int = 0,
    capacity_mode: str = "abs",
    step: int = 0,
    spatial_free_bits: Optional[float] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ELBO with the reference's reduction: per-sample sums, divided by
    the effective batch size ``mask.sum()`` (``mask`` (B,) drops padded
    rows). Returns (total, recon, kl) scalars. Under a ``mesh`` the sums
    and ``mask.sum()`` are the global batch's (``parallel.global_value``:
    the global value, this rank's share of the gradient).

    Recon is BCE-with-logits, MSE (on sigmoid(logits) when
    ``mse_use_sigmoid``) or L1 on the outputs (``"l1"``); KL is per-dim,
    clamped below by ``free_bits`` (flat) or ``spatial_free_bits``
    (spatial, opt-in). Flat models with
    ``capacity_max`` and ``capacity_anneal_steps`` > 0 regularize
    |KL - C(step)| ("abs") or max(KL - C(step), 0) ("clipped"), with C
    ramping linearly to ``capacity_max``.
    """
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    axes = tuple(range(1, x.ndim))
    if recon_loss == "bce":
        lg = x_logits
        per = torch.clamp_min(lg, 0) - lg * x + torch.log1p(
            torch.exp(-lg.abs()))
    elif recon_loss == "l1":  # LDM's |x - x_hat| (``AutoencoderKL``)
        per = (x_logits - x).abs()
    else:
        pred = torch.sigmoid(x_logits) if mse_use_sigmoid else x_logits
        per = (pred - x) ** 2
    recon_sum = (per.sum(axes) * mask).sum()

    kl_per = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    if topology == "flat" and free_bits is not None:
        kl_per = torch.clamp_min(kl_per, free_bits)
    elif topology == "spatial" and spatial_free_bits is not None:
        kl_per = torch.clamp_min(kl_per, spatial_free_bits)
    kl_sum = (kl_per.sum(tuple(range(1, mu.ndim))) * mask).sum()
    n = mask.sum()
    recon_sum, kl_sum, n = global_value(torch.stack([recon_sum, kl_sum, n]),
                                        mesh)
    denom = torch.clamp_min(n, 1.0)
    recon = recon_sum / denom
    kl = kl_sum / denom

    if topology == "flat" and capacity_max > 0 and capacity_anneal_steps > 0:
        progress = min(1.0, step / max(1, capacity_anneal_steps))
        target = capacity_max * progress
        if capacity_mode == "abs":
            kl_reg = (kl - target).abs()
        else:  # "clipped"
            kl_reg = torch.clamp_min(kl - target, 0.0)
        total = recon + beta * kl_reg
    else:
        total = recon + beta * kl
    return total, recon, kl


# last: importing ``utils`` imports this module's ``VAE`` (utils/checkpoint)
from ..ops.batchnorm import batch_norm_train  # noqa: E402
from ..utils.profiling import span  # noqa: E402
