"""Port parity: the codebook stage's remaining graph engines.

The graph algorithms reach exact fixed points, so each must equal the JAX
package's output exactly on the CPU, on the graphs of
``tests/conftest.py`` (line, triangle, two disconnected lines, a random
kNN graph):

- edge-list Bellman-Ford (``ops/shortest_paths.py``): the ``EdgeList``
  arrays, distances and sweep counts; ``unweighted``, ``d0`` warm starts,
  the single-source and (S, T) forms;
- ``connected_components_device``: labels;
- ``geo_compat``: distances, predecessors (the same native Dijkstra on
  both sides), hop counts and the validation errors;
- k-medoids on an ``EdgeList`` and ``fit_kmedoids_with_connectivity_check``:
  medoids, assignments, QE and the metadata;
- the ELL engine's frontier skipping (``active``): distances, sweeps and
  relaxed chunks, cold and warm;
- ``native.knn_exact`` and the kNN escape hatch above ``device_max`` rows;
- the host kNN (``force_method="host"``) with ties;
- ``analyze_graph_connectivity``.
"""
import numpy as np
import pytest
import torch
from scipy import sparse

import vqvae_tpu.ops.ell as jax_ell_mod
from vqvae_tpu import native as jax_native
from vqvae_tpu.ops import build_knn_graph as jax_build_knn_graph
from vqvae_tpu.ops import geo_compat as jax_geo
from vqvae_tpu.ops.connected import (
    connected_components_device as jax_cc)
from vqvae_tpu.ops.graph import (_build_knn_graph_host as jax_host_knn,
                                 analyze_graph_connectivity as jax_analyze)
from vqvae_tpu.ops.kmedoids import fit_kmedoids as jax_fit_kmedoids
from vqvae_tpu.ops.kmedoids import (
    fit_kmedoids_with_connectivity_check as jax_fit_checked)
from vqvae_tpu.ops.knn import knn_search as jax_knn_search
from vqvae_tpu.ops.shortest_paths import EdgeList as JaxEdgeList
from vqvae_tpu.ops.shortest_paths import (
    distances_between as jax_between,
    multi_source_shortest_paths as jax_msp,
    single_source_shortest_paths as jax_ssp)
from vqvae_tpu_torch import native
from vqvae_tpu_torch.ops import ell, geo_compat
from vqvae_tpu_torch.ops.backend import multi_source_distances
from vqvae_tpu_torch.ops.connected import connected_components_device
from vqvae_tpu_torch.ops.graph import (analyze_graph_connectivity,
                                       build_knn_graph_auto)
from vqvae_tpu_torch.ops.kmedoids import (
    fit_kmedoids, fit_kmedoids_with_connectivity_check)
from vqvae_tpu_torch.ops.knn import knn_search
from vqvae_tpu_torch.ops.shortest_paths import (EdgeList, distances_between,
                                                multi_source_shortest_paths,
                                                single_source_shortest_paths)

GRAPHS = ["line_graph", "triangle_graph", "disconnected_two_lines", "knn"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graph(request, random_latents):
    if request.param == "knn":
        W, _ = jax_build_knn_graph(random_latents, k=6, sym="union")
        return W.astype(np.float32)
    return request.getfixturevalue(request.param)


def _sources(W):
    n = W.shape[0]
    return np.unique(np.asarray([0, n // 2, n - 1, 17 % n]))


def _edge_lists(W, pad=8192):
    return (JaxEdgeList.from_csr(W, pad_multiple=pad),
            EdgeList.from_csr(W, pad_multiple=pad, device="cpu"))


# -- edge-list Bellman-Ford ---------------------------------------------------

@pytest.mark.parametrize("graph", GRAPHS, indirect=True)
@pytest.mark.parametrize("unweighted", [False, True])
def test_bellman_ford_matches_jax(graph, unweighted):
    # a small pad and chunk so the random graph sweeps several chunks
    jel, el = _edge_lists(graph, pad=256)
    for name in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(el, name).numpy(),
                                      np.asarray(getattr(jel, name)))
    assert el.dst_sorted == jel.dst_sorted and el.n_nodes == jel.n_nodes
    src = _sources(graph)
    ref, ref_it = jax_msp(jel, src, unweighted=unweighted, chunk=512,
                          return_iters=True)
    out, it = multi_source_shortest_paths(el, src, unweighted=unweighted,
                                          chunk=512, return_iters=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert it == int(ref_it)
    np.testing.assert_array_equal(
        single_source_shortest_paths(el, int(src[-1]), unweighted).numpy(),
        np.asarray(jax_ssp(jel, int(src[-1]), unweighted)))
    np.testing.assert_array_equal(
        distances_between(el, src[:2], src, unweighted).numpy(),
        np.asarray(jax_between(jel, src[:2], src, unweighted)))


def test_bellman_ford_warm_start_and_max_iters(random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=6, sym="union")
    jel, el = _edge_lists(W, pad=256)
    src = np.asarray([3, 71, 150])
    full = multi_source_shortest_paths(el, src).numpy()
    d0 = full * 1.25 + 0.5
    d0[src, np.arange(3)] = 0.0
    ref, ref_it = jax_msp(jel, src, d0=d0, chunk=512, return_iters=True)
    out, it = multi_source_shortest_paths(el, src, d0=torch.from_numpy(d0),
                                          chunk=512, return_iters=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), full)
    assert it == int(ref_it)
    ref2, it2 = jax_msp(jel, src, chunk=512, max_iters=2, return_iters=True)
    out2, pit2 = multi_source_shortest_paths(el, src, chunk=512, max_iters=2,
                                             return_iters=True)
    np.testing.assert_array_equal(out2.numpy(), np.asarray(ref2))
    assert pit2 == int(it2) == 2
    # the backend dispatches an EdgeList to this engine
    np.testing.assert_array_equal(multi_source_distances(el, src), full)
    with pytest.raises(ValueError, match="host backend"):
        multi_source_distances(el, src, backend="host")


def test_edge_list_validation():
    with pytest.raises(ValueError, match="Negative"):
        EdgeList.from_arrays([0], [1], [-1.0], 2, device="cpu")
    with pytest.raises(TypeError):
        EdgeList.from_csr(np.eye(3), device="cpu")
    with pytest.raises(ValueError, match="square"):
        EdgeList.from_csr(sparse.csr_matrix((2, 3)), device="cpu")
    el = EdgeList.from_csr(sparse.csr_matrix((3, 3), dtype=np.float32),
                           device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        multi_source_shortest_paths(el, np.asarray([], np.int64))


# -- connected components -----------------------------------------------------

@pytest.mark.parametrize("graph", GRAPHS, indirect=True)
def test_connected_components_match_jax(graph):
    np.testing.assert_array_equal(
        connected_components_device(graph, device="cpu"), jax_cc(graph))


def test_connected_components_from_edge_pairs(random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=2, sym="mutual")
    coo = sparse.triu(W).tocoo()
    pair = (coo.row, coo.col)
    got = connected_components_device(pair, n_nodes=W.shape[0], device="cpu")
    np.testing.assert_array_equal(got, jax_cc(pair, n_nodes=W.shape[0]))
    assert len(np.unique(got)) > 1  # several components
    np.testing.assert_array_equal(
        connected_components_device(pair, device="cpu"), jax_cc(pair))


# -- geo_compat ---------------------------------------------------------------

@pytest.mark.parametrize("graph", GRAPHS, indirect=True)
def test_geo_compat_matches_jax(graph):
    src = _sources(graph)
    for unweighted in (False, True):
        d = geo_compat.dijkstra_multi_source(graph, src,
                                             unweighted=unweighted,
                                             device="cpu")
        np.testing.assert_array_equal(
            d, jax_geo.dijkstra_multi_source(graph, src,
                                             unweighted=unweighted))
        assert d.shape == (len(src), graph.shape[0]) and d.dtype == np.float32
    d, p = geo_compat.dijkstra_multi_source(graph, src,
                                            return_predecessors=True)
    jd, jp = jax_geo.dijkstra_multi_source(graph, src,
                                           return_predecessors=True)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(p, jp)
    assert p.dtype == np.int32 and (p[np.arange(len(src)), src] == -9999).all()
    d1, p1 = geo_compat.dijkstra_single_source(graph, int(src[1]),
                                               return_predecessors=True)
    np.testing.assert_array_equal(d1, d[1])
    np.testing.assert_array_equal(p1, p[1])
    np.testing.assert_array_equal(
        geo_compat.distances_between(graph, src[:2], src, device="cpu"),
        jax_geo.distances_between(graph, src[:2], src))


def test_geo_compat_validation():
    for call, exc in ((lambda: geo_compat.ensure_valid_graph(np.eye(2)),
                       TypeError),
                      (lambda: geo_compat.ensure_valid_graph(
                          sparse.csr_matrix((2, 3))), ValueError),
                      (lambda: geo_compat.ensure_valid_graph(
                          sparse.csr_matrix(-np.eye(2))), ValueError),
                      (lambda: geo_compat.dijkstra_multi_source(
                          sparse.eye(2, format="csr"), []), ValueError),
                      (lambda: geo_compat.dijkstra_multi_source(
                          sparse.eye(2, format="csr"), [0], directed=True),
                       NotImplementedError),
                      (lambda: geo_compat.distances_between(
                          sparse.eye(2, format="csr"), [0], []),
                       ValueError)):
        with pytest.raises(exc):
            call()


# -- k-medoids on an EdgeList -------------------------------------------------

@pytest.mark.parametrize("init", ["kpp", "kpp_parallel", "random"])
def test_kmedoids_on_edge_list_matches_jax(random_latents, init):
    W, _ = jax_build_knn_graph(random_latents, k=6, sym="union")
    jel, el = _edge_lists(W.astype(np.float32))
    ref = jax_fit_kmedoids(jel, K=8, init=init, seed=3)
    got = fit_kmedoids(el, K=8, init=init, seed=3)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]
    # and the CSR route gives the same medoids and QE
    csr = fit_kmedoids(W.astype(np.float32), K=8, init=init, seed=3,
                       backend="device", device="cpu")
    np.testing.assert_array_equal(csr[0], got[0])
    assert csr[2] == got[2]


def test_kmedoids_with_connectivity_check(disconnected_two_lines,
                                          random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=2, sym="mutual")
    for graph in (disconnected_two_lines, W.astype(np.float32)):
        ref = jax_fit_checked(graph, K=2, init="kpp", seed=1)
        got = fit_kmedoids_with_connectivity_check(graph, K=2, init="kpp",
                                                   seed=1, device="cpu")
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] and got[3] == ref[3]
    assert got[3]["n_components"] > 1


# -- ELL frontier skipping ----------------------------------------------------

@pytest.mark.parametrize("k,sym,warm", [(6, "union", False),
                                        (6, "union", True),
                                        (3, "mutual", False)])
def test_ell_active_matches_jax(random_latents, monkeypatch, k, sym, warm):
    W, _ = jax_build_knn_graph(random_latents, k=k, sym=sym)
    W = W.astype(np.float32)
    # small buckets and chunks, so a sweep visits many chunks
    for name, val in (("CAPGROW", "1.5"), ("MINROWS", "1"), ("CHUNK", "16"),
                      ("STATS", "1"), ("ACTIVE", "1")):
        monkeypatch.setenv(f"VQVAE_TPU_ELL_{name}", val)
    monkeypatch.setattr(ell, "ROW_CHUNK", 16)
    src = np.asarray([3, 71, 150])
    g = ell.BucketedGraph.from_csr(W, device="cpu", min_rows=1)
    full = ell.multi_source_shortest_paths_ell(g, src).numpy()
    d0 = None
    if warm:
        d0 = full * 1.2 + 0.3
        d0[src, np.arange(3)] = 0.0
    jg = jax_ell_mod.BucketedGraph.from_csr(W)
    n0 = len(jax_ell_mod.ELL_STATS)
    ref, ref_it = jax_ell_mod.multi_source_shortest_paths_ell(
        jg, src, d0=d0, return_iters=True)
    jrec = jax_ell_mod.ELL_STATS[n0:][-1]
    out, it = ell.multi_source_shortest_paths_ell(
        g, src, d0=None if d0 is None else torch.from_numpy(d0),
        active=True, return_iters=True)
    rec = ell.ELL_STATS[-1]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), full)
    assert it == int(ref_it) == rec["iters"]
    for key in ("chunk_visits", "chunk_relaxed", "bytes"):
        assert rec[key] == jrec[key], key
    assert rec["active_frac"] == pytest.approx(jrec["active_frac"])
    if sym == "mutual":  # fragments the sources never reach are skipped
        assert rec["chunk_relaxed"] < rec["chunk_visits"]
    off = ell.multi_source_shortest_paths_ell(g, src)
    assert ell.ELL_STATS[-1]["active_frac"] == 1.0
    np.testing.assert_array_equal(off.numpy(), full)


# -- kNN: native exact, the escape hatch, the host oracle --------------------

def test_knn_exact_and_escape_hatch_match_jax(random_latents, monkeypatch):
    z = random_latents[:120]
    d, i = native.knn_exact(z, 7)
    jd, ji = jax_native.knn_exact(z, 7)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    assert (i[:, 0] == np.arange(120)).all()
    d, i = native.knn_exact(z[:5], 7)  # k past N: +inf and -1
    assert np.isinf(d[:, 5:]).all() and (i[:, 5:] == -1).all()

    monkeypatch.setenv("VQVAE_TPU_KNN_DEVICE_MAX", "100")
    jd, ji = jax_knn_search(z, 7)
    d, i = knn_search(z, 7, device="cpu", device_max=100)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    # below the limit: the device route, the same neighbour sets
    d2, i2 = knn_search(z, 7, device="cpu")
    assert (np.sort(i2, 1) == np.sort(i, 1)).mean() > 0.99
    np.testing.assert_allclose(d2, d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("sym,mode", [("mutual", "distance"),
                                      ("union", "connectivity")])
def test_host_knn_matches_jax_with_ties(metric, sym, mode):
    # integer lattice points with duplicates: many exact ties
    rng = np.random.default_rng(0)
    z = rng.integers(-2, 3, size=(90, 3)).astype(np.float32)
    z[50:60] = z[:10]
    ref_W, ref = jax_host_knn(z, 5, metric, mode, sym)
    W, got = build_knn_graph_auto(z, k=5, metric=metric, mode=mode, sym=sym,
                                  force_method="host", device="cpu")
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    np.testing.assert_array_equal(got["distances"], ref["distances"])
    assert (W != ref_W).nnz == 0


@pytest.mark.parametrize("graph", GRAPHS, indirect=True)
def test_analyze_graph_connectivity_matches_jax(graph):
    assert analyze_graph_connectivity(graph) == jax_analyze(graph)
