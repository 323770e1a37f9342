"""IVF kNN and Euclidean k-means on the card against the CPU.

Every test needs a CUDA device (the ``cuda`` marker) and skips without
one. The file imports no JAX, so it runs on a GPU host without it:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_ivf_kmeans_cuda.py``.

- ``fit_kmeans`` on 4,096 clustered rows, K = 32: labels identical except
  at near-tie rows (the two centres' fast-form values within 1e-4
  relative, at most 1 % of the rows), centres within rtol 1e-4 (atol
  1e-5), inertia within rtol 1e-4;
- IVF on 8,192 rows from the CPU's coarse centres carried across: the
  top-4 choices identical except at near-tie rows (at most 8); the search
  from the CPU's layout and probe table identical except at near-tie rows
  (the k-th distances within 1e-6 relative), distances within 1e-5 where
  the indices match; end to end, every row answered, itself first,
  distances sorted and within rtol 1e-5 of the exact distance.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops import fit_kmeans, ivf, knn_search_ivf
from vqvae_tpu_torch.ops.kmeans_euclidean import kmeans_plus_plus_init

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (card vs CPU)")
    return resolve_device("cuda")  # full f32


def _latents(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.2, size=(10, d)).astype(np.float32)
    labels = rng.integers(0, 10, size=n)
    return centers[labels] + rng.normal(0, 1.0, size=(n, d)).astype(
        np.float32)


def test_fit_kmeans_card_matches_cpu(cuda_device):
    z = _latents(4096)
    c_g, l_g, i_g = fit_kmeans(z, 32, seed=42, device=cuda_device)
    c_c, l_c, i_c = fit_kmeans(z, 32, seed=42, device="cpu")
    differ = np.nonzero(l_g != l_c)[0]
    assert len(differ) <= 0.01 * len(z), len(differ)
    for r in differ:
        a = ((z[r] - c_c[l_g[r]]) ** 2).sum()
        b = ((z[r] - c_c[l_c[r]]) ** 2).sum()
        assert abs(a - b) <= 1e-4 * max(a, b), (r, a, b)
    np.testing.assert_allclose(c_g, c_c, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(i_g, i_c, rtol=1e-4)
    init = kmeans_plus_plus_init(z, 32, 42)
    assert init.shape == (32, 16)


def test_ivf_steps_card_match_cpu(cuda_device):
    z = _latents(8192)
    C, cap, P, k, k_sel = 32, 320, 16, 9, 13
    rng = np.random.default_rng(0)
    init = z[rng.choice(len(z), size=C, replace=False)]
    centers = ivf._lloyd_sample(torch.from_numpy(z), torch.from_numpy(init),
                                10)
    cg = ivf._lloyd_sample(torch.from_numpy(z).to(cuda_device),
                           torch.from_numpy(init).to(cuda_device), 10)
    np.testing.assert_allclose(cg.cpu().numpy(), centers.numpy(), rtol=1e-4,
                               atol=1e-5)
    ch_c = ivf._assign_topc(torch.from_numpy(z), centers, 8192, 4).numpy()
    ch_g = ivf._assign_topc(torch.from_numpy(z).to(cuda_device),
                            centers.to(cuda_device), 8192, 4).cpu().numpy()
    assert (ch_c != ch_g).any(1).sum() <= 8

    labels = ivf._balance_buckets(ch_c, C, cap)
    ids = ivf._bucket_ids(labels, C, cap)
    probe = ivf._probe_table(centers.numpy(), labels, ch_c, P)
    bz = z[np.maximum(ids, 0)]
    args = (torch.from_numpy(bz), torch.from_numpy(ids),
            torch.from_numpy(probe).long())
    d_c, i_c = (a.numpy() for a in ivf._ivf_search(*args, k, k_sel))
    d_g, i_g = (a.cpu().numpy() for a in ivf._ivf_search(
        *(a.to(cuda_device) for a in args), k, k_sel))
    same = i_g == i_c
    np.testing.assert_allclose(np.where(same, d_g, 0), np.where(same, d_c, 0),
                               rtol=1e-5, atol=1e-6)
    rows = np.nonzero((ids >= 0) & ~same.all(-1))
    assert len(rows[0]) <= 8
    for b, r in zip(*rows):
        assert abs(d_g[b, r, -1] - d_c[b, r, -1]) <= 1e-6 * d_c[b, r, -1]


def test_ivf_end_to_end_on_the_card(cuda_device):
    z = _latents(8192)
    d, i = knn_search_ivf(z, 9, n_centroids=32, seed=0, device=cuda_device)
    assert ((i >= 0) & (i < len(z))).all()
    assert (i[:, 0] == np.arange(len(z))).mean() > 0.999
    assert (np.diff(d, axis=1) >= 0).all()
    exact = np.sqrt(((z[:, None, :] - z[i]) ** 2).sum(-1))
    np.testing.assert_allclose(d, exact, rtol=1e-5, atol=1e-6)
