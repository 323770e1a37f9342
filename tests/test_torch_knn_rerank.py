"""The exact re-rank of the port's kNN on the host, and its tie order.

The re-rank's distances on the CPU come from numpy, outside torch's
intra-op thread pool (``ops/knn.py`` ``_exact_distances``): they must equal,
bit for bit, an independent f64 evaluation of the same f32 multiply-add
chain, at a block size whose (T, C, D) tensors torch would split among its
threads. Exact ties (duplicate points, also across a database tile
boundary) must come out in the JAX package's order.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.knn import knn_search as jax_knn_search
from vqvae_tpu_torch.ops import knn
from vqvae_tpu_torch.ops.knn import knn_search


def _fma_chain_sq(diff: np.ndarray) -> np.ndarray:
    """sum(diff**2) over the last axis, each step rounded once to f32."""
    out = np.zeros(diff.shape[:-1], np.float32)
    for j in range(diff.shape[-1]):
        d = diff[..., j].astype(np.float64)
        out = (out.astype(np.float64) + d * d).astype(np.float32)
    return out


@pytest.fixture
def eight_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("t,c,d", [(400, 11, 8), (1024, 30, 16)])
def test_host_rerank_is_the_f32_chain(t, c, d, eight_threads):
    rng = np.random.default_rng(t + c)
    z = rng.normal(0, 3.0, size=(2048, d)).astype(np.float32)
    q = z[:t] + rng.normal(0, 0.5, size=(t, d)).astype(np.float32)
    idx = rng.integers(0, 2048, size=(t, c)).astype(np.int32)
    got = knn._exact_distances(torch.from_numpy(q), torch.from_numpy(idx),
                               torch.from_numpy(z), "euclidean").numpy()
    want = np.sqrt(np.maximum(_fma_chain_sq(q[:, None, :] - z[idx]), 0.0))
    np.testing.assert_array_equal(got, want)


def test_host_rerank_stays_out_of_torch_ops(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("host re-rank ran a torch elementwise chain")

    monkeypatch.setattr(knn, "dot_last", refuse)
    z = torch.from_numpy(
        np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32))
    idx = torch.arange(300, dtype=torch.int32).view(60, 5)
    for metric in ("euclidean", "cosine"):
        out = knn._exact_distances(z[:60], idx, z, metric)
        assert out.shape == (60, 5) and torch.isfinite(out).all()


@pytest.mark.parametrize("kernel,jax_kernel", [("exact", "xla"),
                                               ("fused", "pallas")])
def test_duplicates_across_a_tile_boundary_keep_jax_order(kernel,
                                                          jax_kernel):
    # exact twins straddling db tiles of 128 rows: equal exact distances,
    # resolved by candidate order on both sides
    rng = np.random.default_rng(4)
    z = rng.normal(0, 1.0, size=(512, 8)).astype(np.float32)
    for a, b in ((127, 128), (255, 256), (10, 300), (383, 129)):
        z[b] = z[a]
    d_ref, i_ref = jax_knn_search(z, k=6, kernel=jax_kernel, db_tile=128)
    d, i = knn_search(z, k=6, kernel=kernel, db_tile=128, bins=128,
                      device="cpu")
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=0)
