"""Published peaks and the work each stage does, counted from shapes.

Nothing here reads the program: the counts come from a configuration's
sizes, so a later change to the program cannot move the yardstick.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): the port
keeps TF32 off (``vqvae_tpu_torch.device.resolve_device``), so its float32
arithmetic runs on the CUDA cores and ``F32_FLOPS`` is the peak a step's
MFU is held against. ``TF32_FLOPS`` is the lowest precision the port's
rules let a filter use (K1's selection), so K1's bound takes it.

Convolutions count the multiply-adds that reach a kept output: a tap that
lands in the padding or is cropped from a transposed convolution's output
is no work. A backward pass counts twice its forward.
"""
from __future__ import annotations

from typing import Dict, Sequence

F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def conv_taps_1d(n_in: int, k: int, stride: int, pad: int) -> int:
    """Pairs (output position, tap) of a convolution whose input index
    ``o * stride - pad + t`` lies inside the input."""
    return sum(1 for o in range(conv_out(n_in, k, stride, pad))
               for t in range(k)
               if 0 <= o * stride - pad + t < n_in)


def deconv_taps_1d(n_in: int, k: int, stride: int, pad: int) -> int:
    """Pairs (input position, tap) of a transposed convolution whose output
    index ``i * stride - pad + t`` lies inside the output."""
    n_out = deconv_out(n_in, k, stride, pad)
    return sum(1 for i in range(n_in) for t in range(k)
               if 0 <= i * stride - pad + t < n_out)


def conv_out(n_in: int, k: int, stride: int, pad: int) -> int:
    return (n_in + 2 * pad - k) // stride + 1


def deconv_out(n_in: int, k: int, stride: int, pad: int) -> int:
    return (n_in - 1) * stride - 2 * pad + k


def spatial_decoder_flops(latent: int, dec: Sequence[int], out_ch: int,
                          image: int, grid: int) -> float:
    """Forward FLOPs of the spatial decoder on one ``grid`` x ``grid``
    latent: a 1x1 conv in, two k4 s2 p1 transposed convs, then the k4 s2
    head (padding 3 for 28 px, 1 for 32 px)."""
    head_pad = 1 if image == 32 else 3
    flops = 2.0 * latent * dec[0] * grid * grid
    n, cin = grid, dec[0]
    for cout, pad in ((dec[1], 1), (dec[2], 1), (out_ch, head_pad)):
        flops += 2.0 * cin * cout * deconv_taps_1d(n, 4, 2, pad) ** 2
        n, cin = deconv_out(n, 4, 2, pad), cout
    return flops


def vae_forward_flops(cfg: Dict) -> float:
    """Forward FLOPs of one image through the spatial VAE of ``cfg["vae"]``:
    three k3 s2 p1 convs, the two 1x1 heads (mu, logvar), the decoder."""
    v = cfg["vae"]
    n, cin, flops = v["image_size"], v["in_channels"], 0.0
    for cout in v["enc_channels"]:
        flops += 2.0 * cin * cout * conv_taps_1d(n, 3, 2, 1) ** 2
        n, cin = conv_out(n, 3, 2, 1), cout
    flops += 2 * 2.0 * cin * v["latent_dim"] * n * n
    return flops + spatial_decoder_flops(v["latent_dim"], v["dec_channels"],
                                         v["in_channels"], v["image_size"], n)


def knn_distance_flops(n_query: int, n_rows: int, dim: int) -> float:
    """One distance product per query-row pair: D products and D sums."""
    return 2.0 * n_query * n_rows * dim


def riemannian_flops(cfg: Dict, edges: int) -> float:
    """The decoder JVPs of ``edges`` edge lengths: two endpoints an edge,
    each a JVP (the forward and its tangent: twice the forward) of the
    decoder on a 1x1 latent grid."""
    v = cfg["vae"]
    one = spatial_decoder_flops(v["latent_dim"], v["dec_channels"],
                                v["in_channels"], v["image_size"], 1)
    return edges * 2 * 2.0 * one


def k1_bound_seconds(n_query: int, n_rows: int, dim: int, k: int) -> float:
    """The least time one H100 needs for an exact kNN of ``n_query`` rows
    against ``n_rows``: one distance product per pair at the TF32 peak, or
    each input byte read once and each of the k (index, distance) results
    written once at the HBM rate, whichever is larger."""
    ops = knn_distance_flops(n_query, n_rows, dim) / TF32_FLOPS
    moved = ((n_query + n_rows) * dim * 4 + n_query * k * 8) / HBM_BYTES_PER_S
    return max(ops, moved)
