"""Plain PyTorch reference of the spatial convolutional VAE, in float32.

Written from the model's description, not from the program: three
k3 s2 p1 convolutions with BatchNorm and ReLU, 1x1 heads for mu and
logvar on the 4x4 grid, z = mu + eps * exp(logvar / 2), a 1x1 conv in, two
k4 s2 p1 transposed convolutions with BatchNorm and ReLU and a k4 s2 head
(padding 3 for 28 px, 1 for 32 px). BatchNorm follows flax: in training
the batch's biased statistics over (B, H, W) with the fast variance
max(E[x^2] - E[x]^2, 0), evaluated in float64 and rounded once to float32,
the gradient flowing through the statistics; running statistics move by
momentum 0.99; in evaluation the running statistics normalize. The ELBO
sums each image's squared error (on sigmoid(logits) where the
configuration says so) and its KL per latent element (clamped below by
``spatial_free_bits`` where set) and divides by the real rows of the
batch (``mask``).

Parameter names are the reference checkpoint format that the port loads
(``encoder.conv_layers.{0,3,6}``, norms at ``{1,4,7}``, ``encoder.fc_mu``,
``encoder.fc_logvar``, ``decoder.conv_in``, ``decoder.deconv_layers.{0,3,6}``,
norms at ``{1,4}``); kernels in torch's layouts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..inputs import Spec, weights

BN_EPS = 1e-5
BN_MOMENTUM = 0.99
ENC_NORMS = ("encoder.conv_layers.1", "encoder.conv_layers.4",
             "encoder.conv_layers.7")
DEC_NORMS = ("decoder.deconv_layers.1", "decoder.deconv_layers.4")


def head_pad(image: int) -> int:
    return 1 if image == 32 else 3


def specs(cfg: Dict) -> List[Spec]:
    """Weight specs in flax's default init: truncated lecun-normal
    kernels (fan in = in channels x kernel area), zero biases, norm scales
    1 and shifts 0."""
    v = cfg["vae"]
    c, lat = v["in_channels"], v["latent_dim"]
    enc, dec = v["enc_channels"], v["dec_channels"]
    out: List[Spec] = []

    def kernel(name, shape, fan_in):
        out.append((f"{name}.weight", shape, "lecun", fan_in))
        out.append((f"{name}.bias", (shape[0] if "deconv" not in name
                                     else shape[1],), "zeros", None))

    def norm(name, ch):
        out.append((f"{name}.weight", (ch,), "ones", None))
        out.append((f"{name}.bias", (ch,), "zeros", None))

    cin = c
    for i, ch in enumerate(enc):
        kernel(f"encoder.conv_layers.{3 * i}", (ch, cin, 3, 3), cin * 9)
        norm(ENC_NORMS[i], ch)
        cin = ch
    kernel("encoder.fc_mu", (lat, cin, 1, 1), cin)
    kernel("encoder.fc_logvar", (lat, cin, 1, 1), cin)
    kernel("decoder.conv_in", (dec[0], lat, 1, 1), lat)
    cin = dec[0]
    for j, ch in enumerate(dec[1:3]):
        kernel(f"decoder.deconv_layers.{3 * j}", (cin, ch, 4, 4), cin * 16)
        norm(DEC_NORMS[j], ch)
        cin = ch
    kernel("decoder.deconv_layers.6", (cin, c, 4, 4), cin * 16)
    return out


def norm_channels(cfg: Dict) -> Dict[str, int]:
    v = cfg["vae"]
    chans = list(v["enc_channels"]) + list(v["dec_channels"][1:3])
    return dict(zip(ENC_NORMS + DEC_NORMS, chans))


def initial_state(cfg: Dict, seed: int, tag: int, device,
                  random_stats: bool = False) -> Dict[str, torch.Tensor]:
    """Weights and norm buffers as a state dict. ``random_stats`` (a
    decoder used in evaluation, as the codebook stage's): running means
    N(0, 0.1^2) and variances U(0.5, 1.5) instead of 0 and 1; norm scales
    U(0.5, 1.5) and shifts N(0, 0.1^2)."""
    sp = specs(cfg)
    chans = norm_channels(cfg)
    if random_stats:
        sp = [(n, s, "uniform", (0.5, 1.5)) if n.endswith(".weight")
              and n.rsplit(".", 1)[0] in chans else
              (n, s, "normal", 0.1) if n.endswith(".bias")
              and n.rsplit(".", 1)[0] in chans else (n, s, i, a)
              for n, s, i, a in sp]
        for name, ch in chans.items():
            sp.append((f"{name}.running_mean", (ch,), "normal", 0.1))
            sp.append((f"{name}.running_var", (ch,), "uniform", (0.5, 1.5)))
    else:
        for name, ch in chans.items():
            sp.append((f"{name}.running_mean", (ch,), "zeros", None))
            sp.append((f"{name}.running_var", (ch,), "ones", None))
    sd = weights(sp, seed, tag, device)
    for name in chans:
        sd[f"{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
    return sd


def _bn(h: torch.Tensor, s: Dict[str, torch.Tensor], name: str,
        train: bool, stats: Optional[Dict[str, torch.Tensor]]):
    w, b = s[f"{name}.weight"], s[f"{name}.bias"]
    if not train:
        inv = torch.rsqrt(s[f"{name}.running_var"] + BN_EPS) * w
        return ((h - s[f"{name}.running_mean"][:, None, None])
                * inv[:, None, None] + b[:, None, None])
    hd = h.double()
    mean = hd.mean((0, 2, 3))
    var = torch.clamp_min((hd * hd).mean((0, 2, 3)) - mean * mean, 0.0)
    y = ((hd - mean[:, None, None])
         * (torch.rsqrt(var + BN_EPS) * w.double())[:, None, None]
         + b.double()[:, None, None]).float()
    if stats is not None:
        m = BN_MOMENTUM
        with torch.no_grad():
            stats[f"{name}.running_mean"] = (
                m * s[f"{name}.running_mean"] + (1 - m) * mean.float())
            stats[f"{name}.running_var"] = (
                m * s[f"{name}.running_var"] + (1 - m) * var.float())
    return y


def encode(s, x: torch.Tensor, train: bool, stats=None):
    """x (B, H, W, C) -> mu, logvar (B, 4, 4, latent)."""
    h = x.permute(0, 3, 1, 2)
    for i, name in enumerate(ENC_NORMS):
        conv = f"encoder.conv_layers.{3 * i}"
        h = F.conv2d(h, s[f"{conv}.weight"], s[f"{conv}.bias"], stride=2,
                     padding=1)
        h = torch.relu(_bn(h, s, name, train, stats))
    mu = F.conv2d(h, s["encoder.fc_mu.weight"], s["encoder.fc_mu.bias"])
    lv = F.conv2d(h, s["encoder.fc_logvar.weight"],
                  s["encoder.fc_logvar.bias"])
    return mu.permute(0, 2, 3, 1), lv.permute(0, 2, 3, 1)


def decode(s, z: torch.Tensor, image: int, train: bool, stats=None
           ) -> torch.Tensor:
    """z (B, h, w, latent) -> logits (B, H, W, C)."""
    h = F.conv2d(z.permute(0, 3, 1, 2), s["decoder.conv_in.weight"],
                 s["decoder.conv_in.bias"])
    for j, name in enumerate(DEC_NORMS):
        conv = f"decoder.deconv_layers.{3 * j}"
        h = F.conv_transpose2d(h, s[f"{conv}.weight"], s[f"{conv}.bias"],
                               stride=2, padding=1)
        h = torch.relu(_bn(h, s, name, train, stats))
    h = F.conv_transpose2d(h, s["decoder.deconv_layers.6.weight"],
                           s["decoder.deconv_layers.6.bias"], stride=2,
                           padding=head_pad(image))
    return h.permute(0, 2, 3, 1)


def elbo(cfg: Dict, x, logits, mu, logvar, mask, beta: float = 1.0
         ) -> torch.Tensor:
    v = cfg["vae"]
    pred = torch.sigmoid(logits) if v["mse_use_sigmoid"] else logits
    recon = (((pred - x) ** 2).sum((1, 2, 3)) * mask).sum()
    kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    if v.get("spatial_free_bits") is not None:
        kl = torch.clamp_min(kl, v["spatial_free_bits"])
    kl = (kl.sum((1, 2, 3)) * mask).sum()
    n = torch.clamp_min(mask.sum(), 1.0)
    return recon / n + beta * (kl / n)


def train_loss(cfg: Dict, s: Dict[str, torch.Tensor], x, mask,
               eps: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """The training step's loss from state ``s`` on batch ``x`` with
    noise ``eps`` (B, 4, 4, latent); returns (loss, new running stats)."""
    stats: Dict[str, torch.Tensor] = {}
    mu, logvar = encode(s, x, True, stats)
    z = mu + eps * torch.exp(0.5 * logvar)
    logits = decode(s, z, cfg["vae"]["image_size"], True, stats)
    return elbo(cfg, x, logits, mu, logvar, mask), stats


def calibrate_decoder(s: Dict[str, torch.Tensor], cfg: Dict,
                      z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``s`` with each decoder norm's running statistics set to the
    (biased) statistics of its input over latents ``z`` (N, latent), each
    decoded as a 1x1 grid, layer by layer: the running statistics a
    decoder trained on such latents would carry into evaluation."""
    out = dict(s)
    with torch.no_grad():
        h = F.conv2d(z[:, :, None, None], s["decoder.conv_in.weight"],
                     s["decoder.conv_in.bias"])
        for j, name in enumerate(DEC_NORMS):
            conv = f"decoder.deconv_layers.{3 * j}"
            h = F.conv_transpose2d(h, s[f"{conv}.weight"], s[f"{conv}.bias"],
                                   stride=2, padding=1)
            hd = h.double()
            mean = hd.mean((0, 2, 3))
            var = torch.clamp_min((hd * hd).mean((0, 2, 3)) - mean * mean,
                                  0.0)
            out[f"{name}.running_mean"] = mean.float()
            out[f"{name}.running_var"] = var.float()
            h = torch.relu(_bn(h, out, name, False, None))
    return out
