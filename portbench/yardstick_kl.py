"""The work of FLUX.1's KL autoencoder, counted from a configuration's
shapes (the published keys of ``vae/config.json``: ``in_channels``,
``out_channels``, ``block_out_channels``, ``layers_per_block``,
``latent_channels``; the image side from ``data.image_shape``).

Nothing here reads the program, and the conventions are ``yardstick.py``'s:
a convolution counts the multiply-adds whose tap lands inside its input
(the zero padding, and the padded row and column before a down sampler's
stride-2 conv, are no work); a linear map 2 x rows x in x out; attention
4 x tokens^2 x width a head (q k^T and the weighted sum of v); a backward
pass twice its forward; evaluation passes count their forward. GroupNorm,
SiLU and the residual additions carry no counted FLOPs.

Bytes, for the rooflines, count each input byte read once and each output
byte written once (float32):

- attention (``scaled_dot_product_attention`` alone): forward reads q, k,
  v and writes the output and a log-sum-exp per token; backward reads q,
  k, v, the output, its gradient and the log-sum-exp and writes the
  gradients of q, k and v;
- GroupNorm: forward reads x and writes y; backward reads the output's
  gradient and x and writes x's gradient (the statistics and the affine
  parameters are a few numbers a group or a channel, left out).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

from .yardstick import F32_FLOPS, HBM_BYTES_PER_S

F32 = 4


def taps_1d(n_in: int, k: int, stride: int, pad_lo: int, pad_hi: int
            ) -> int:
    """Pairs (output position, tap) of a convolution whose input index
    ``o * stride - pad_lo + t`` lies inside the input."""
    n_out = (n_in + pad_lo + pad_hi - k) // stride + 1
    return sum(1 for o in range(n_out) for t in range(k)
               if 0 <= o * stride - pad_lo + t < n_in)


class Shapes(NamedTuple):
    """One image's work: convs (in, out, kernel side, kept taps), linear
    maps (rows, in, out), attention calls (tokens, width) and GroupNorms
    (channels, pixels)."""

    convs: List
    linears: List
    attention: List
    norms: List


def image_side(cfg: Dict) -> int:
    return int(cfg["data"]["image_shape"][0])


def latent_grid(cfg: Dict) -> int:
    n = image_side(cfg)
    for _ in cfg["block_out_channels"][1:]:
        n = (n + 1 - 3) // 2 + 1
    return n


def shapes(cfg: Dict) -> Shapes:
    widths = list(cfg["block_out_channels"])
    layers, lat = cfg["layers_per_block"], cfg["latent_channels"]
    out = Shapes([], [], [], [])

    def conv(cin, cout, n, k=3):
        pad = k // 2
        out.convs.append((cin, cout, k, taps_1d(n, k, 1, pad, pad) ** 2))

    def resnet(cin, cout, n):
        out.norms.append((cin, n * n))
        conv(cin, cout, n)
        out.norms.append((cout, n * n))
        conv(cout, cout, n)
        if cin != cout:
            conv(cin, cout, n, 1)

    def mid(ch, n):
        resnet(ch, ch, n)
        out.norms.append((ch, n * n))
        out.linears.extend([(n * n, ch, ch)] * 4)
        out.attention.append((n * n, ch))
        resnet(ch, ch, n)

    n = image_side(cfg)
    conv(cfg["in_channels"], widths[0], n)
    cin = widths[0]
    for i, w in enumerate(widths):
        for _ in range(layers):
            resnet(cin, w, n)
            cin = w
        if i < len(widths) - 1:
            out.convs.append((w, w, 3, taps_1d(n, 3, 2, 0, 1) ** 2))
            n = (n + 1 - 3) // 2 + 1
    mid(cin, n)
    out.norms.append((cin, n * n))
    conv(cin, 2 * lat, n)
    rev = widths[::-1]
    conv(lat, rev[0], n)
    mid(rev[0], n)
    cin = rev[0]
    for i, w in enumerate(rev):
        for _ in range(layers + 1):
            resnet(cin, w, n)
            cin = w
        if i < len(rev) - 1:
            n *= 2
            conv(w, w, n)
    out.norms.append((cin, n * n))
    conv(cin, cfg["out_channels"], n)
    return out


def param_count(cfg: Dict) -> int:
    """Weights and biases of every conv and linear, and each GroupNorm's
    scale and shift."""
    s = shapes(cfg)
    return (sum(cin * cout * k * k + cout for cin, cout, k, _ in s.convs)
            + sum(i * o + o for _, i, o in s.linears)
            + sum(2 * c for c, _ in s.norms))


def forward_flops(cfg: Dict) -> float:
    """Forward FLOPs of one image through the encoder and the decoder."""
    s = shapes(cfg)
    return (sum(2.0 * cin * cout * taps for cin, cout, _, taps in s.convs)
            + sum(2.0 * r * i * o for r, i, o in s.linears)
            + attention_flops(cfg))


def attention_flops(cfg: Dict) -> float:
    """Forward FLOPs of one image's attention calls (one head each)."""
    return sum(4.0 * n * n * c for n, c in shapes(cfg).attention)


def attention_bytes(cfg: Dict, backward: bool) -> float:
    """Bytes of one image's attention calls, forward or backward."""
    per = (8 if backward else 4) * F32
    return sum(per * n * c + F32 * n for n, c in shapes(cfg).attention)


def groupnorm_bytes(cfg: Dict, backward: bool) -> float:
    """Bytes of one image's GroupNorms, forward or backward."""
    return (3 if backward else 2) * F32 * sum(
        c * p for c, p in shapes(cfg).norms)


def attention_bound_seconds(cfg: Dict, train_images: int,
                            eval_images: int) -> float:
    """The least time one H100 needs for the attention of ``train_images``
    training images (forward and backward) and ``eval_images`` evaluated
    ones: the FLOPs at the float32 peak or the bytes at the HBM rate,
    whichever is larger."""
    fwd = attention_flops(cfg)
    flops = (3 * train_images + eval_images) * fwd
    moved = ((train_images + eval_images) * attention_bytes(cfg, False)
             + train_images * attention_bytes(cfg, True))
    return max(flops / F32_FLOPS, moved / HBM_BYTES_PER_S)


def groupnorm_bound_seconds(cfg: Dict, train_images: int,
                            eval_images: int) -> float:
    """GroupNorm's bytes of ``train_images`` training images (forward and
    backward) and ``eval_images`` evaluated ones at the HBM rate."""
    moved = ((train_images + eval_images) * groupnorm_bytes(cfg, False)
             + train_images * groupnorm_bytes(cfg, True))
    return moved / HBM_BYTES_PER_S
