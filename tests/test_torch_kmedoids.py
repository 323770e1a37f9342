"""Port parity: graph K-medoids.

Both packages sample with numpy ``default_rng(seed)`` on the host and
relax to exact fixed points, so the same graph and seed must give
identical medoids and assignments and the same QE (rtol 1e-9: one float64
sum of the same squares). ``reorder`` and ``backend`` are pinned on both
sides: the BFS reorder and the host/device choice depend on
``HOST_WORK_THRESHOLD``, which scales with the host's cores.
"""
import numpy as np
import pytest

import vqvae_tpu.ops.kmedoids as jax_kmedoids
from vqvae_tpu.ops import build_knn_graph as jax_build_knn_graph
from vqvae_tpu_torch.ops import kmedoids


@pytest.fixture
def union_graph(random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=6, sym="union")
    return W


@pytest.mark.parametrize("init,backend,reorder,threshold", [
    ("kpp_parallel", "host", False, None),
    ("kpp_parallel", "device", False, None),
    ("kpp_parallel", "auto", True, 0.0),   # BFS reorder + device rounds
    ("kpp", "host", False, None),
    ("random", "device", False, None),
])
def test_fit_matches_jax(union_graph, monkeypatch, init, backend, reorder,
                         threshold):
    if threshold is not None:
        monkeypatch.setattr(jax_kmedoids, "HOST_WORK_THRESHOLD", threshold)
        monkeypatch.setattr(kmedoids, "HOST_WORK_THRESHOLD", threshold)
    ref_m, ref_a, ref_qe = jax_kmedoids.fit_kmedoids(
        union_graph, K=10, init=init, seed=3, backend=backend,
        reorder=reorder)
    m, a, qe = kmedoids.fit_kmedoids(union_graph, K=10, init=init, seed=3,
                                     backend=backend, reorder=reorder,
                                     device="cpu")
    np.testing.assert_array_equal(m, ref_m)
    np.testing.assert_array_equal(a, ref_a)
    np.testing.assert_allclose(qe, ref_qe, rtol=1e-9)


def test_disconnected_graph_matches_jax(random_latents):
    W, _ = jax_build_knn_graph(random_latents, k=3, sym="mutual")
    ref = jax_kmedoids.fit_kmedoids(W, K=12, init="kpp_parallel", seed=7,
                                    backend="device", reorder=False)
    out = kmedoids.fit_kmedoids(W, K=12, init="kpp_parallel", seed=7,
                                backend="device", reorder=False,
                                device="cpu")
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-9)


def test_quantization_error_ignores_unreachable():
    d = np.array([1.0, np.inf, 2.0], np.float32)
    assert kmedoids.compute_quantization_error(d) == 5.0
    assert kmedoids.compute_quantization_error(
        np.full(2, np.inf, np.float32)) == float("inf")
