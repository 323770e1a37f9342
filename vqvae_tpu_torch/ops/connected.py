"""Connected components by min-label propagation with pointer jumping —
the port of ``vqvae_tpu/ops/connected.py``.

Every node starts with its own index as its label. A sweep takes, for
each node, the smallest label over its incident edges (a scatter ``amin``
over both edge directions), keeps the smaller of that and its own, then
jumps pointers twice (``labels = labels[labels]``) to shortcut chains.
The loop ends after a sweep that changes no label; each sweep ends with
one host read. The fixed point labels each component by its smallest
node index, whatever the order of the edges.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device

# one record per call: sweeps, wall seconds, directed edges, nodes
CC_STATS: list = []


@torch.no_grad()
def _cc(src: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    t0 = time.perf_counter()
    labels = torch.arange(n_nodes, dtype=torch.int64, device=src.device)
    changed, sweeps = True, 0
    while changed:
        prop = torch.full_like(labels, n_nodes)  # larger than any label
        prop.scatter_reduce_(0, dst, labels[src], "amin")
        new = torch.minimum(labels, prop)
        new = new[new]
        new = new[new]
        changed = bool((new != labels).any())  # one host read a sweep
        labels = new
        sweeps += 1
    CC_STATS.append({"sweeps": sweeps, "seconds": time.perf_counter() - t0,
                     "edges": int(src.shape[0]), "nodes": n_nodes})
    return labels


def connected_components_device(W_or_edges, n_nodes: int | None = None,
                                device=None) -> np.ndarray:
    """Labels (N,) int32 of the undirected connected components, each the
    smallest node index of its component.

    ``W_or_edges``: a scipy sparse matrix or a ``(src, dst)`` pair of
    index arrays (``n_nodes`` defaults to the largest index + 1).
    ``device`` None means CUDA (raises without it)."""
    from scipy import sparse

    dev = resolve_device(device)
    if sparse.issparse(W_or_edges):
        coo = W_or_edges.tocoo()
        src = np.concatenate([coo.row, coo.col]).astype(np.int64)
        dst = np.concatenate([coo.col, coo.row]).astype(np.int64)
        n_nodes = W_or_edges.shape[0]
    else:
        s, d = W_or_edges
        src = np.concatenate([s, d]).astype(np.int64)
        dst = np.concatenate([d, s]).astype(np.int64)
        if n_nodes is None:
            n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    labels = _cc(torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
                 int(n_nodes))
    return labels.cpu().numpy().astype(np.int32)
