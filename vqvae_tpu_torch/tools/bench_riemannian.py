"""The Riemannian edge-length engines side by side, in one process.

The port of ``tools/bench_riemannian.py``: ``bench.py``-style clustered
latents (``--nodes`` x ``--dim``, seed 0), a union kNN graph on them
(``--knn``, connectivity, approximate), its undirected edges, and a
seeded random spatial VAE at the FashionMNIST preset's widths (encoder
64/128/256, decoder 256/128/64, batch norm), 1 channel at 28 px or
``--channels 3 --size 32 --dim 32`` for CIFAR-10's decoder. Engines
(``--engines``, the first is the reference of the others):

- ``mlp``: the linearized decoder, endpoints gathered on the device
  (``edge_lengths_riemannian_auto(engine="mlp")``);
- ``indexed``: the conv decoder's JVP, endpoints gathered on the device
  (``engine="edgewise"`` of ``edge_lengths_riemannian_auto``);
- ``edgewise``: the conv decoder's JVP on preformed endpoint arrays
  (``edge_lengths_riemannian``: JAX's ``fused`` engine);
- ``nodal``: per-node pullback metrics (``engine="nodal"``);
- ``bf16``: ``edgewise`` with the decoder computing in bfloat16
  (``models.cast``; parameters stay float32).

JAX's ``edgewise`` there was the unfused two-JVP variant; the port
always evaluates both endpoints in one JVP, so ``unfused`` is refused.

For each engine: the best wall seconds of ``--runs`` calls after a
warm-up, the largest relative difference from the first engine, and the
call's ``RIEM_STATS`` record (engine, samples, JVP FLOPs per sample,
seconds; built here for the endpoint-array engines, which do not record),
with its FLOPs and the time they take at the f32 peak ``PEAK_F32``.
``--batches`` sweeps the first engine's batch size instead.

Run: ``python -m vqvae_tpu_torch.tools.bench_riemannian [--nodes 196608]
[--dim 16] [--knn 10] [--batch 4096] [--engines mlp,indexed,nodal]
[--runs 2] [--channels 1 --size 28] [--batches 4096,16384]
[--device cpu]``; prints one JSON object.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.cast import set_compute_dtype
from ..ops import build_knn_graph, edge_lengths_riemannian
from ..ops import riemannian as riem
from ..utils.checkpoint import build_vae
from .bench_fit import make_latents

# H100 SXM's published dense f32 peak outside the tensor cores (700 W)
PEAK_F32 = 67e12
ENGINES = ("mlp", "indexed", "edgewise", "nodal", "bf16")


def bench_decoder(dim: int = 16, channels: int = 1, size: int = 28,
                  seed: int = 0, device=None):
    """A seeded random spatial VAE at the presets' widths, in eval mode on
    ``device`` (default the GPU)."""
    dev = resolve_device(device)
    torch.manual_seed(seed)
    model = build_vae({"in_channels": channels, "output_image_size": size,
                       "latent_dim": dim, "enc_channels": (64, 128, 256),
                       "dec_channels": (256, 128, 64), "recon_loss": "mse",
                       "norm_type": "batch", "topology": "spatial"})
    return model.to(dev).eval()


def graph_edges(z: np.ndarray, knn: int, device=None):
    """The undirected edges (rows < cols) of a union kNN graph of ``z``."""
    W, _ = build_knn_graph(z, k=knn, metric="euclidean", mode="connectivity",
                           sym="union", approx=True, device=device)
    rows, cols = W.nonzero()
    keep = rows < cols
    return rows[keep], cols[keep]


def engine_decoder(engine: str, model):
    """The decode function an engine runs (built once: the mlp engine's
    linearization is cached on it)."""
    if engine == "bf16":
        model = set_compute_dtype(copy.deepcopy(model), "bfloat16")
    return riem.make_decoder_image_fn(model, "spatial")


def engine_call(engine: str, decode_fn, z, rows, cols, batch: int):
    """One engine's lengths and its ``RIEM_STATS``-style record."""
    if engine in ("mlp", "indexed", "nodal"):
        n = len(riem.RIEM_STATS)
        out = riem.edge_lengths_riemannian_auto(
            decode_fn, z, rows, cols, batch_size=batch,
            engine="edgewise" if engine == "indexed" else engine)
        return out, {**riem.RIEM_STATS[n], "engine": engine}
    t0 = time.perf_counter()
    out = edge_lengths_riemannian(decode_fn, z[rows], z[cols],
                                  batch_size=batch)
    return out, {"engine": engine, "samples": 2 * len(rows),
                 "jvp_flops_per_sample":
                     riem.conv_decoder_jvp_flops_per_sample(decode_fn.model),
                 "seconds": time.perf_counter() - t0}


def check_engines(engines: Sequence[str]) -> list:
    for e in engines:
        if e == "unfused":
            raise ValueError(
                "engine 'unfused' (JAX's two-JVP edgewise variant) has no "
                "counterpart: the port evaluates both endpoints in one JVP")
        if e not in ENGINES:
            raise ValueError(f"unknown engine {e!r}; expected {ENGINES}")
    return list(engines)


def run(nodes: int = 196608, dim: int = 16, knn: int = 10,
        batch: int = 4096, engines: Sequence[str] = ("mlp", "indexed"),
        runs: int = 2, channels: int = 1, size: int = 28,
        batches: Optional[Sequence[int]] = None, z=None, rows=None,
        cols=None, device=None) -> Dict:
    """The comparison on ``device`` (default the GPU); ``z`` / ``rows`` /
    ``cols`` give the latents and edges instead of the generated ones."""
    dev = resolve_device(device)
    engines = check_engines(engines)
    if z is None:
        z = make_latents(nodes, dim=dim, seed=0)
    if rows is None:
        rows, cols = graph_edges(z, knn, dev)
    z = np.asarray(z, np.float32)
    model = bench_decoder(z.shape[1], channels, size, device=dev)
    head = {"nodes": int(len(z)), "edges": int(len(rows)),
            "dim": int(z.shape[1]), "channels": channels, "size": size,
            "device": dev.type}

    def best(engine, bs):
        fn = engine_decoder(engine, model)
        times, out, rec = [], None, None
        for r in range(runs + 1):  # run 0 warms up
            t0 = time.perf_counter()
            out, rec = engine_call(engine, fn, z, rows, cols, bs)
            if r:
                times.append(time.perf_counter() - t0)
        return min(times), out, rec

    if batches:
        res = {f"bs{bs}": best(engines[0], int(bs))[0] for bs in batches}
        return {**head, "engine": engines[0], "results": res}
    results, records, ref = {}, {}, None
    for engine in engines:
        secs, lengths, rec = best(engine, batch)
        if ref is None:
            ref = lengths
        else:
            results[f"{engine}_max_rel_diff"] = float(np.max(
                np.abs(lengths - ref) / np.maximum(np.abs(ref), 1e-6)))
        results[engine] = secs
        flops = rec["jvp_flops_per_sample"]
        if flops is not None:
            rec["flops"] = flops * rec["samples"]
            rec["f32_peak_seconds"] = rec["flops"] / PEAK_F32
        records[engine] = rec
    return {**head, "batch": batch, "results": results, "records": records}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=196608)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--knn", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--batches", default=None,
                    help="comma list of batch sizes to sweep (the first "
                         "engine only)")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--engines", default="mlp,indexed",
                    help=f"comma list of {', '.join(ENGINES)}")
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--size", type=int, default=28)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.nodes, args.dim, args.knn, args.batch,
              args.engines.split(","), args.runs, args.channels, args.size,
              [int(b) for b in args.batches.split(",")] if args.batches
              else None, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
