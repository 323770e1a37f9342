"""Port parity: kNN graph assembly, symmetric CSR and the LCC.

The port's ``ops/graph.py`` against the JAX package's on the same seeded
latents, through both of its routes: scipy, and the native one-pass
library (forced on small graphs by lowering its entry threshold to 0).
Graph structure and kNN indices must be identical. kNN distance weights
agree within rtol 1e-6: the exact re-rank's f32 sums may round one ulp
apart (the kNN contract allows 1e-5); everything built from given weights
is exact.
"""
import numpy as np
import pytest
from scipy import sparse

from vqvae_tpu.ops import graph as jax_graph
from vqvae_tpu_torch.ops import graph


def _latents(n=400, d=8, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, size=(5, d)).astype(np.float32)
    z = centers[rng.integers(0, 5, size=n)]
    z = z + rng.normal(0, 0.5, size=z.shape).astype(np.float32)
    z[-20:] += 60.0  # a far cluster: a second component in mutual graphs
    z[10] = z[11]    # an exact duplicate: the self-match strip's fallback
    return z.astype(np.float32)


def _assert_same_graph(a, b, rtol=0.0):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=rtol, atol=0)


@pytest.fixture(params=["scipy", "native"])
def route(request, monkeypatch):
    if request.param == "native":
        monkeypatch.setattr(graph, "NATIVE_ASSEMBLE_MIN", 0)
        monkeypatch.setenv("VQVAE_TPU_ASSEMBLE_NATIVE_MIN", "0")
    return request.param


@pytest.mark.parametrize("sym", ["mutual", "union"])
@pytest.mark.parametrize("mode", ["distance", "connectivity"])
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "fused"])
def test_knn_graph_matches_jax(route, sym, mode, approx, monkeypatch):
    # approx: the JAX side's Pallas selection in interpret mode, the port's
    # fused selection through its plain version
    monkeypatch.setenv("VQVAE_TPU_KNN_KERNEL", "pallas" if approx else "xla")
    z = _latents()
    ref, ref_info = jax_graph.build_knn_graph(z, k=6, mode=mode, sym=sym,
                                              approx=approx)
    got, info = graph.build_knn_graph(z, k=6, mode=mode, sym=sym,
                                      approx=approx, device="cpu")
    np.testing.assert_array_equal(info["indices"], ref_info["indices"])
    _assert_same_graph(got, ref, rtol=1e-6)


def test_symmetric_csr_and_lcc_match_jax(route):
    z = _latents()
    W, _ = jax_graph.build_knn_graph(z, k=6, mode="distance", sym="mutual")
    rows, cols = W.nonzero()
    keep = rows < cols
    rows, cols = rows[keep], cols[keep]
    w = np.asarray(W[rows, cols]).ravel().astype(np.float32)
    got = graph.symmetric_csr_from_edges(rows, cols, w, W.shape[0])
    _assert_same_graph(got, jax_graph.symmetric_csr_from_edges(
        rows, cols, w, W.shape[0]))
    mask = graph.largest_connected_component(got)
    np.testing.assert_array_equal(
        mask, jax_graph.largest_connected_component(got))
    assert 0 < mask.sum() < W.shape[0]  # the far cluster is cut off


def test_bfs_node_order_matches_jax():
    W, _ = jax_graph.build_knn_graph(_latents(), k=6, sym="mutual")
    np.testing.assert_array_equal(graph.bfs_node_order(W),
                                  jax_graph.bfs_node_order(W))


def test_native_assembly_rejects_unordered_edges(monkeypatch):
    monkeypatch.setattr(graph, "NATIVE_ASSEMBLE_MIN", 0)
    rows, cols = np.array([2, 0]), np.array([1, 1])
    with pytest.raises(ValueError, match="rows < cols"):
        graph.symmetric_csr_from_edges(rows, cols,
                                       np.ones(2, np.float32), 3)
    assert sparse.issparse(graph.symmetric_csr_from_edges(
        np.array([0, 1]), np.array([1, 2]), np.ones(2, np.float32), 3))
