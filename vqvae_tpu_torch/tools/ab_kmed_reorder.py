"""``fit_kmedoids`` with the BFS node reorder off and on, in ABBA order.

The port of ``tools/ab_kmed_reorder.py``: on a geodesic graph (a saved
CSR ``--graph``, or the bench shape: ``bench.py``-style latents, a union
kNN graph with ``--knn`` neighbours, Riemannian lengths through
``bench_riemannian``'s seeded decoder, its largest component), one
warm-up fit with the reorder on, then A (off), B (on), B, A:
``fit_kmedoids(K, init="kpp_parallel", seed=42, assume_symmetric=True)``
with ``reorder`` off or on. Each record: the stage's seconds, the ELL
sweeps and solver seconds (``ELL_STATS``), the reorder, device-graph,
pass and sampling seconds (``KMED_STATS``) and the QE.

Run: ``python -m vqvae_tpu_torch.tools.ab_kmed_reorder [--nodes 983040]
[--knn 10] [--codes 512] [--graph <npz>] [--out <json>] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import sparse

from ..device import resolve_device
from ..ops import (edge_lengths_riemannian_auto, fit_kmedoids,
                   largest_connected_component, symmetric_csr_from_edges)
from ..ops.ell import ELL_STATS
from ..ops.kmedoids import KMED_STATS
from ..ops.riemannian import make_decoder_image_fn
from .bench_fit import make_latents
from .bench_riemannian import bench_decoder, graph_edges

ORDER = ((True, "warmup"), (False, "A1"), (True, "B1"), (True, "B2"),
         (False, "A2"))


def bench_graph(nodes: int, knn: int, device=None) -> sparse.csr_matrix:
    """The bench-shape geodesic graph's largest component."""
    dev = resolve_device(device)
    z = make_latents(nodes, dim=16, seed=0)
    rows, cols = graph_edges(z, knn, dev)
    decode_fn = make_decoder_image_fn(bench_decoder(16, device=dev),
                                      "spatial")
    lengths = edge_lengths_riemannian_auto(decode_fn, z, rows, cols,
                                           batch_size=4096)
    W = symmetric_csr_from_edges(rows, cols, np.asarray(lengths, np.float32),
                                 nodes)
    mask = largest_connected_component(W)
    return W[mask][:, mask].tocsr() if mask.sum() < nodes else W


def one(W, K: int, reorder: bool, tag: str, dev) -> Dict:
    e0, k0 = len(ELL_STATS), len(KMED_STATS)
    t0 = time.perf_counter()
    _, _, qe = fit_kmedoids(W, K=K, init="kpp_parallel", seed=42,
                            reorder=reorder, assume_symmetric=True,
                            device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter() - t0
    ell = ELL_STATS[e0:]
    km = KMED_STATS[k0:][-1] if len(KMED_STATS) > k0 else {}
    rec = {"tag": tag, "reorder": reorder, "kmed_seconds": t,
           "sweeps": sum(e["iters"] for e in ell),
           "solver_s": sum(e["seconds"] for e in ell),
           "reorder_s": km.get("reorder_seconds", 0.0),
           "device_graph_s": km.get("device_graph_seconds", 0.0),
           "pass_s": sum(km.get("pass_seconds", [])),
           "sample_s": km.get("sample_seconds", 0.0),
           "qe": float(qe)}
    print("[ab]", json.dumps(rec), flush=True)
    return rec


def run(W: Optional[sparse.csr_matrix] = None, nodes: int = 983040,
        knn: int = 10, K: int = 512, device=None) -> Dict:
    """The A/B on ``device`` (default the GPU), on ``W`` or the bench
    graph."""
    dev = resolve_device(device)
    if W is None:
        W = bench_graph(nodes, knn, dev)
    recs: List[Dict] = [one(W, K, reorder, tag, dev)
                        for reorder, tag in ORDER]
    return {"nodes": int(W.shape[0]), "nnz": int(W.nnz), "K": K,
            "device": dev.type, "runs": recs[1:]}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=983040)
    ap.add_argument("--knn", type=int, default=10)
    ap.add_argument("--codes", type=int, default=512)
    ap.add_argument("--graph", default=None, help="a saved CSR .npz")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    W = sparse.load_npz(args.graph).tocsr() if args.graph else None
    out = run(W, args.nodes, args.knn, args.codes, device=args.device)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
