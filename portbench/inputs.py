"""Everything a run feeds both sides, made from ``--seed`` on the device in
a few large calls: images, latents and weights.

One seed gives the same tensors on one device; each kind of input draws
from a generator of its own, ``generator(device, seed, tag)``, so adding
an input never shifts another. Seeds are any non-negative integer (taken
modulo 2**64); the driver's exceed 32 bits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2430, 0.2610)
# flax's truncated-normal scaling: std of a unit normal cut at [-2, 2]
TRUNC_STD = 0.87962566103423978


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed from ``seed`` and integer ``tags``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *map(int, tags)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def images(n: int, shape: Sequence[int], normalized: bool, seed: int,
           tag: int, device, chunk: int = 8192
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, H, W, C) float32 images and (n,) int64 labels: each of 10
    classes draws oriented bands at its own angle and frequency under a
    blob of its own width, with per-image angle, phase, scale, tint and
    pixel noise. Grayscale sets lie in [0, 1]; ``normalized`` sets are
    standardized by CIFAR-10's channel statistics."""
    h, w, c = shape
    g = generator(device, seed, tag)
    labels = torch.randint(0, 10, (n,), generator=g, device=device)
    u = torch.rand((n, 3 + c), generator=g, device=device)
    noise = torch.randn((n, h, w, c), generator=g, device=device)
    yy = torch.linspace(-0.5, 0.5, h, device=device)[:, None]
    xx = torch.linspace(-0.5, 0.5, w, device=device)[None, :]
    out = torch.empty((n, h, w, c), device=device)
    for s in range(0, n, chunk):
        lab = labels[s:s + chunk].float()[:, None, None]
        uu = u[s:s + chunk]
        ang = lab * math.pi / 10 + (uu[:, 0, None, None] - 0.5) * 0.6
        phase = uu[:, 1, None, None] * 2 * math.pi
        scale = 0.8 + 0.4 * uu[:, 2, None, None]
        proj = torch.cos(ang) * xx + torch.sin(ang) * yy
        tex = 0.5 + 0.5 * torch.sin(2 * math.pi * (3.0 + 0.7 * lab) * scale
                                    * proj + phase)
        blob = torch.exp(-(xx ** 2 + yy ** 2) / (0.08 + 0.02 * lab))
        tint = 0.4 + 0.6 * uu[:, 3:, None, None]              # (b, c, 1, 1)
        img = (tex * blob)[..., None] * tint.permute(0, 2, 3, 1)
        out[s:s + chunk] = torch.clamp(img + 0.05 * noise[s:s + chunk],
                                       0.0, 1.0)
    if normalized:
        mean = torch.tensor(CIFAR10_MEAN[:c], device=device)
        std = torch.tensor(CIFAR10_STD[:c], device=device)
        out = (out - mean) / std
    return out, labels


def clustered_latents(images_n: int, grid: int, dim: int, lobes: int,
                      center_std: float, noise_std: float, seed: int,
                      tag: int, device) -> torch.Tensor:
    """(images_n, grid, grid, dim) float32 latents whose grid cells are
    drawn around ``lobes`` Gaussian centres (std ``center_std``) with
    ``noise_std`` noise: lobes that overlap, so the kNN graph is about one
    component, as a trained VAE's latents make it (``bench.py``'s
    ``make_latents``, rewritten for the device)."""
    g = generator(device, seed, tag)
    centers = torch.randn((lobes, dim), generator=g, device=device) \
        * center_std
    n = images_n * grid * grid
    lab = torch.randint(0, lobes, (n,), generator=g, device=device)
    z = centers[lab] + torch.randn((n, dim), generator=g, device=device) \
        * noise_std
    return z.reshape(images_n, grid, grid, dim)


# a weight spec: (name, shape, init, arg): init "lecun" (arg: fan in;
# flax's truncated lecun normal), "normal" (arg: std), "uniform" (arg:
# (low, high)), "zeros", "ones"
Spec = Tuple[str, Tuple[int, ...], str, object]


def weights(specs: List[Spec], seed: int, tag: int, device
            ) -> Dict[str, torch.Tensor]:
    """The tensors of ``specs``: one truncated-normal, one normal and one
    uniform draw for all leaves of each kind, split and scaled."""
    g = generator(device, seed, tag)
    sizes = {k: sum(math.prod(s) for _, s, i, _ in specs if i == k)
             for k in ("lecun", "normal", "uniform")}
    pools = {
        "lecun": torch.nn.init.trunc_normal_(
            torch.empty(sizes["lecun"], device=device), 0.0, 1.0, -2.0, 2.0,
            generator=g),
        "normal": torch.randn(sizes["normal"], generator=g, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device),
    }
    used = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, init, arg in specs:
        if init in pools:
            n = math.prod(shape)
            raw = pools[init][used[init]:used[init] + n].view(shape)
            used[init] += n
            if init == "lecun":
                t = raw * (math.sqrt(1.0 / arg) / TRUNC_STD)
            elif init == "normal":
                t = raw * arg
            else:
                t = arg[0] + (arg[1] - arg[0]) * raw
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = t.contiguous()
    return out
