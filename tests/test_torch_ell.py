"""Port parity: the bucketed Gauss-Seidel ELL shortest-path engine.

The relaxation's fixed point is exact (every entry is the minimum over
paths of the left-to-right f32 path sum), so the port's distances must be
bit-identical to the JAX engine's whatever the bucket layout, chunking or
sweep order, and agree with scipy's Dijkstra within 1e-6 relative.
"""
import numpy as np
import pytest
import torch
from scipy import sparse
from scipy.sparse.csgraph import dijkstra

from vqvae_tpu.ops import build_knn_graph as jax_build_knn_graph
from vqvae_tpu.ops.ell import BucketedGraph as JaxBucketedGraph
from vqvae_tpu.ops.ell import (
    multi_source_shortest_paths_ell as jax_multi_source)
from vqvae_tpu_torch.ops import ell
from vqvae_tpu_torch.ops.backend import multi_source_distances


def _both(W, sources, monkeypatch, cap_grow=1.5, min_rows=8192, chunk=8192):
    monkeypatch.setenv("VQVAE_TPU_ELL_CAPGROW", str(cap_grow))
    monkeypatch.setenv("VQVAE_TPU_ELL_MINROWS", str(min_rows))
    monkeypatch.setenv("VQVAE_TPU_ELL_CHUNK", str(chunk))
    monkeypatch.setattr(ell, "ROW_CHUNK", chunk)
    ref = np.asarray(jax_multi_source(JaxBucketedGraph.from_csr(W),
                                      np.asarray(sources)))
    g = ell.BucketedGraph.from_csr(W, device="cpu", cap_grow=cap_grow,
                                   min_rows=min_rows)
    out = ell.multi_source_shortest_paths_ell(g, sources).numpy()
    np.testing.assert_array_equal(out, ref)
    oracle = dijkstra(W, directed=False, indices=sources).T
    np.testing.assert_allclose(out, oracle, rtol=1e-6, atol=1e-6)
    return out, g


def test_line_graph(line_graph, monkeypatch):
    out, _ = _both(line_graph, [0], monkeypatch)
    np.testing.assert_array_equal(out[:, 0], [0, 1, 2, 3])


def test_triangle(triangle_graph, monkeypatch):
    _both(triangle_graph, [0, 2], monkeypatch)


def test_disconnected(disconnected_two_lines, monkeypatch):
    out, _ = _both(disconnected_two_lines, [0], monkeypatch)
    assert np.isinf(out[3:, 0]).all()


@pytest.mark.parametrize("cap_grow,min_rows,chunk", [
    (1.5, 8192, 8192), (1.5, 1, 16), (2.0, 1, 32), (1.25, 4, 8)])
def test_knn_graph_across_cap_ladders(random_latents, monkeypatch, cap_grow,
                                      min_rows, chunk):
    W, _ = jax_build_knn_graph(random_latents, k=6, sym="union")
    W = W.astype(np.float32)
    _, g = _both(W, [0, 17, 55, 123], monkeypatch, cap_grow, min_rows, chunk)
    if min_rows == 1:
        assert sum(nb.shape[0] > 0 for nb in g.nbrs) > 1  # several buckets


def test_skewed_degrees(monkeypatch):
    # star with a tail: the hub has a high degree, leaves degree 1
    n = 70
    rows = np.concatenate([np.zeros(n - 11, int), np.arange(59, 69)])
    cols = np.concatenate([np.arange(1, n - 10), np.arange(60, 70)])
    w = np.random.RandomState(0).uniform(0.5, 2.0, rows.size)
    W = sparse.csr_matrix((w.astype(np.float32), (rows, cols)), shape=(n, n))
    W = W.maximum(W.T)
    _both(W, [5, 69], monkeypatch, min_rows=1, chunk=16)


def test_warm_start_reaches_same_fixed_point(random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=6, sym="union")
    g = ell.BucketedGraph.from_csr(W, device="cpu")
    sources = np.asarray([3, 71, 150])
    cold = ell.multi_source_shortest_paths_ell(g, sources)
    # upper bounds: distances to a superset's nearest source, each source's
    # own column at 0
    sup = ell.multi_source_shortest_paths_ell(g, np.arange(0, 200, 40))
    d0 = sup.amin(dim=1, keepdim=True).expand(-1, 3).clone()
    d0[torch.from_numpy(sources), torch.arange(3)] = 0.0
    warm = ell.multi_source_shortest_paths_ell(g, sources, d0=d0)
    np.testing.assert_array_equal(warm.numpy(),
                                  np.minimum(cold.numpy(), d0.numpy()))


def test_host_and_device_backends_agree(random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=6, sym="mutual")
    sources = np.arange(8)
    host = multi_source_distances(W, sources, "host")
    dev = multi_source_distances(W, sources, "device", device="cpu")
    np.testing.assert_allclose(dev, host, rtol=1e-6)
