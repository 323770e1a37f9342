"""Kernels K1 (packed) and K2 (unpacked) against their plain PyTorch version
on the card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one. The file imports no JAX, so it also runs on a GPU host without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_knn_select_cuda.py``.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops.knn_select import fused_select, fused_select_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _database(n_valid, rows, d=16, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, size=(12, d)).astype(np.float32)
    z = centers[rng.integers(0, 12, size=n_valid)]
    z = z + rng.normal(0, 0.3, size=z.shape).astype(np.float32)
    out = np.zeros((rows, d), np.float32)
    out[:n_valid] = z
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins,db_tile,metric,n_query", [
    (True, 1024, 8192, "euclidean", 2048),
    (False, 768, 6144, "euclidean", 2048),
    (True, 256, 1024, "cosine", 1000),   # query rows not a multiple of R
    (False, 384, 384, "euclidean", 300),
])
def test_kernel_matches_plain_version_on_card(cuda_device, packed, bins,
                                              db_tile, metric, n_query):
    n = 3 * db_tile - 100
    z = _database(n, 3 * db_tile)
    if metric == "cosine":
        z[:n] /= np.linalg.norm(z[:n], axis=1, keepdims=True) + 1e-8
    zq = torch.from_numpy(z[:n_query]).to(cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    before = fused_select.launches
    kd, ki = fused_select(zq, zd, n, metric=metric, bins=bins, k_sel=29,
                          packed=packed)
    assert fused_select.launches == before + 1
    rd, ri = fused_select_reference(zq, zd, n, metric=metric, bins=bins,
                                    k_sel=29, packed=packed)
    torch.cuda.synchronize()
    rows_differ = (ki != ri).any(dim=1).float().mean().item()
    assert rows_differ <= 1e-3, rows_differ
    torch.testing.assert_close(kd, rd, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_raises_on_card_instead_of_falling_back(cuda_device):
    z = torch.zeros((384, 16), device=cuda_device)
    with pytest.raises(ValueError):
        fused_select(z, z, 384, metric="euclidean", bins=256, k_sel=9,
                     packed=True)  # 384 rows not a multiple of bins
