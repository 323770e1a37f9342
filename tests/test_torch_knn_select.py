"""Port parity: fused kNN selection (K1 packed / K2 unpacked) and knn_search.

The plain PyTorch version ``fused_select_reference`` is held against the
JAX package's Pallas kernel run in interpret mode, and the port's
``knn_search`` against the JAX ``knn_search(kernel="pallas")`` on the cases
of ``tests/test_pallas_knn.py``. Both sides see the same f32 roundings (the
augmented matmul, and squared norms as left-to-right FMA chains), so
indices must be identical; distances agree within 1e-5. The CUDA kernels
are held against the plain version in ``test_torch_knn_select_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.knn import knn_search as jax_knn_search
from vqvae_tpu.ops.pallas_knn import fused_select as jax_fused_select
from vqvae_tpu_torch.ops.knn import knn_search
from vqvae_tpu_torch.ops.knn_select import (fused_select,
                                            fused_select_reference)


def _latents(n, d=16, seed=0, clusters=12):
    rng = np.random.RandomState(seed)
    centers = rng.randn(clusters, d).astype(np.float32) * 3.0
    z = centers[rng.randint(0, clusters, n)]
    return (z + rng.randn(n, d).astype(np.float32) * 0.3).astype(np.float32)


def _padded(z, rows):
    out = np.zeros((rows, z.shape[1]), np.float32)
    out[:z.shape[0]] = z
    return out


@pytest.mark.parametrize("packed,n,bins,db_tile,metric", [
    (True, 1024, 256, 1024, "euclidean"),
    (True, 1800, 128, 512, "euclidean"),
    (False, 300, 384, 384, "euclidean"),
    (False, 1800, 96, 384, "euclidean"),
    (True, 500, 256, 512, "cosine"),
])
def test_reference_matches_pallas_interpret(packed, n, bins, db_tile, metric):
    z = _latents(n, seed=n)
    if metric == "cosine":
        z = z / (np.linalg.norm(z, axis=1, keepdims=True) + 1e-8)
    zp = _padded(z, -(-n // db_tile) * db_tile)
    q = _padded(z, -(-n // 128) * 128)
    k_sel = 19
    jd, ji = jax_fused_select(
        jnp.asarray(q), jnp.asarray(zp), jnp.int32(n), metric=metric,
        sel_tile=128, db_tile=db_tile, bins=bins, k_sel=k_sel,
        interpret=True, packed=packed)
    td, ti = fused_select_reference(
        torch.from_numpy(q), torch.from_numpy(zp), n, metric=metric,
        bins=bins, k_sel=k_sel, packed=packed)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, :k_sel])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd)[:, :k_sel],
                               rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    z = torch.from_numpy(_latents(256))
    before = fused_select.launches
    a = fused_select(z, z, 256, metric="euclidean", bins=128, k_sel=9,
                     packed=True)
    b = fused_select_reference(z, z, 256, metric="euclidean", bins=128,
                               k_sel=9, packed=True)
    assert fused_select.launches == before  # no kernel launched
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    z = torch.zeros((300, 16))
    with pytest.raises(ValueError):
        fused_select(z, z, 300, metric="euclidean", bins=256, k_sel=9,
                     packed=True)  # 300 rows not a multiple of bins
    z = torch.zeros((384, 16))
    with pytest.raises(ValueError):
        fused_select(z, z, 384, metric="euclidean", bins=384, k_sel=9,
                     packed=True)  # packed needs power-of-two bins


def _compare(z, k, monkeypatch, *, metric="euclidean", db_tile=None,
             bins=None, packed=True):
    monkeypatch.setenv("VQVAE_TPU_KNN_PACKED", "1" if packed else "0")
    if bins is not None:
        monkeypatch.setenv("VQVAE_TPU_KNN_BINS", str(bins))
    d_ref, i_ref = jax_knn_search(z, k=k, metric=metric, kernel="pallas",
                                  db_tile=db_tile)
    d, i = knn_search(z, k=k, metric=metric, kernel="fused", db_tile=db_tile,
                      bins=bins or 1024, packed=packed, device="cpu")
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    return i


@pytest.mark.parametrize("n", [300, 777, 1024])
def test_knn_search_matches_jax_small(n, monkeypatch):
    _compare(_latents(n, seed=1), 11, monkeypatch)


@pytest.mark.parametrize("packed", [True, False])
def test_knn_search_matches_jax_cosine(packed, monkeypatch):
    _compare(_latents(500, seed=2), 8, monkeypatch, metric="cosine",
             packed=packed)


@pytest.mark.parametrize("packed", [True, False])
def test_knn_search_matches_jax_multi_tile(packed, monkeypatch):
    _compare(_latents(1800, seed=3), 11, monkeypatch, db_tile=512,
             packed=packed)


def test_knn_search_matches_jax_binned_collisions(monkeypatch):
    # 4096 rows into 128 bins (top-2 each): neighbors are lost to slot
    # collisions, identically on both sides; recall stays above the bound
    n, k = 4096, 10
    z = _latents(n, seed=4)
    i = _compare(z, k, monkeypatch, db_tile=512, bins=128)
    _, i_exact = knn_search(z, k=k, kernel="exact", device="cpu")
    recall = np.mean([len(set(i_exact[q]).intersection(i[q])) / k
                      for q in range(n)])
    assert 0.95 <= recall < 1.0, recall


@pytest.mark.parametrize("packed", [True, False])
def test_knn_search_matches_jax_duplicates_and_ties(packed, monkeypatch):
    # 50 clusters of 30 near-identical points: selection values tie below
    # the packed truncation and squared distances cancel to ~0
    rng = np.random.RandomState(11)
    centers = rng.randn(50, 16).astype(np.float32) * 5.0
    z = np.repeat(centers, 30, axis=0)
    z += rng.randn(*z.shape).astype(np.float32) * 1e-6
    _compare(z, 11, monkeypatch, db_tile=512, packed=packed)


def test_exact_route_matches_jax_xla(random_latents):
    d_ref, i_ref = jax_knn_search(random_latents, k=7, kernel="xla")
    d, i = knn_search(random_latents, k=7, kernel="exact", device="cpu")
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_small_n_runs_unpacked_selection():
    from vqvae_tpu_torch.ops.knn import KNN_EFFECTIVE

    with pytest.warns(UserWarning, match="packed kNN selection disabled"):
        knn_search(_latents(300), k=5, approx=True, device="cpu")
    assert KNN_EFFECTIVE["bins"] == 384 and not KNN_EFFECTIVE["packed"]

