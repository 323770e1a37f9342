"""Directed edge-list graphs — the part of ``vqvae_tpu/ops/shortest_paths.py``
that the k-medoids and backend layers accept as input.

The edge-list Bellman-Ford engine and the builders of this type are not
ported yet (``ROADMAP.md`` queue 1): the codebook stage relaxes on the
bucketed ELL engine (``ops/ell.py``), and the backend refuses an
``EdgeList`` by name instead of treating it as an unknown graph type.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class EdgeList(NamedTuple):
    """Static-shape directed edge list (numpy)."""

    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    w: np.ndarray    # (E,) float32 (+inf for padding)
    n_nodes: int
    dst_sorted: bool = False  # True when edges are sorted by destination
