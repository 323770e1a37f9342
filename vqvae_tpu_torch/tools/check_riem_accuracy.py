"""The Riemannian engines' accuracy against a CPU f32 truth.

The port of ``tools/check_riem_accuracy.py``: on ``bench.py``-style
latents and ``bench_riemannian``'s seeded decoder (1 channel at 28 px, or
``--channels 3 --size 32 --dim 32``), ``--edges`` random node pairs
(numpy ``default_rng(11)``, as JAX) go through the conv decoder's JVP on
the CPU in float32 (the truth), then on ``--device`` through the conv
engine with endpoints gathered on the device (``conv_indexed``) and the
linearized decoder (``mlp``). Each is scored by the largest, the 99.9th
percentile and the mean relative error against the truth.

Run: ``python -m vqvae_tpu_torch.tools.check_riem_accuracy [--nodes 983040]
[--edges 65536] [--batch 4096] [--channels 1 --size 28 --dim 16]
[--device cpu]``; prints one JSON object.
"""
from __future__ import annotations

import argparse
import copy
import json
from typing import Dict

import numpy as np

from ..device import resolve_device
from ..ops.riemannian import (build_mlp_decode_fn,
                              edge_lengths_riemannian_indexed,
                              make_decoder_image_fn)
from .bench_fit import make_latents
from .bench_riemannian import bench_decoder


def run(nodes: int = 983040, dim: int = 16, edges: int = 65536,
        batch: int = 4096, channels: int = 1, size: int = 28,
        device=None) -> Dict:
    """The scores of both engines on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    z = make_latents(nodes, dim=dim, seed=0)
    model = bench_decoder(dim, channels, size, device=dev)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, nodes, size=edges)
    cols = rng.integers(0, nodes, size=edges)
    cpu_model = copy.deepcopy(model).to("cpu")
    truth = edge_lengths_riemannian_indexed(
        make_decoder_image_fn(cpu_model, "spatial"), z, rows, cols,
        batch_size=batch, device="cpu")
    scale = np.maximum(np.abs(truth), 1e-6)
    res = {}
    for name, fn in (("conv_indexed", make_decoder_image_fn(model,
                                                            "spatial")),
                     ("mlp", build_mlp_decode_fn(model))):
        got = edge_lengths_riemannian_indexed(fn, z, rows, cols,
                                              batch_size=batch, device=dev)
        rel = np.abs(got - truth) / scale
        res[name] = {"max_rel": float(rel.max()),
                     "p999_rel": float(np.quantile(rel, 0.999)),
                     "mean_rel": float(rel.mean())}
    return {"edges": edges, "channels": channels, "size": size,
            "device": dev.type, "results": res}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=983040)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--edges", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--size", type=int, default=28)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.nodes, args.dim, args.edges, args.batch, args.channels,
              args.size, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
