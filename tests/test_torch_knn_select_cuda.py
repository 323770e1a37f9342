"""Kernels K1 (packed) and K2 (unpacked) against their plain PyTorch version
on the card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one. The file imports no JAX, so it also runs on a GPU host without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_knn_select_cuda.py``.

Tolerance: the kernel filters on the tensor cores and takes every value
that can enter a slot's top-2 from an f32 multiply-add chain over the
augmented columns, the order in which cuBLAS sums the plain version's f32
product at the main path's shapes (other shapes may sum in another order).
So at most 1e-3 of the rows may differ, and only at near-ties (a candidate
in one output and not the other lies within 1e-5 relative of the plain
version's k_sel-th value), as in ``chip_smoke.py``; values of the other
rows agree within rtol 1e-5 and atol 1e-4 (packed keys truncate the
distance's low mantissa bits).
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


def _assert_matches_plain(zq, zd, n_valid, *, metric, bins, k_sel, packed):
    before = fused_select.launches
    kd, ki = fused_select(zq, zd, n_valid, metric=metric, bins=bins,
                          k_sel=k_sel, packed=packed)
    assert fused_select.launches == before + 1
    rd, ri = fused_select_reference(zq, zd, n_valid, metric=metric,
                                    bins=bins, k_sel=k_sel, packed=packed)
    torch.cuda.synchronize()
    differ = (ki != ri).any(dim=1)
    assert differ.float().mean().item() <= 1e-3
    kth = rd[:, -1]
    for r in torch.nonzero(differ).flatten().tolist():
        a, b = set(ki[r].tolist()), set(ri[r].tolist())
        for c in a ^ b:
            src_d, src_i = (kd, ki) if c in a else (rd, ri)
            val = float(src_d[r][src_i[r] == c][0])
            assert abs(val - float(kth[r])) <= 1e-5 * abs(float(kth[r])), (
                r, c, val, float(kth[r]))
    torch.testing.assert_close(kd[~differ], rd[~differ], rtol=1e-5,
                               atol=1e-4, equal_nan=True)
    return kd, ki


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins,db_tile,metric,n_query,k_sel", [
    (True, 1024, 8192, "euclidean", 2048, 29),
    (False, 768, 6144, "euclidean", 2048, 29),
    (True, 256, 1024, "cosine", 1000, 29),   # queries not a multiple of 128
    (False, 384, 384, "euclidean", 300, 29),
    (True, 128, 1024, "euclidean", 130, 1),
    (False, 640, 640, "euclidean", 700, 128),
    (True, 1024, 4096, "euclidean", 333, 128),
    (False, 768, 1536, "cosine", 515, 9),
    (False, 96, 384, "euclidean", 200, 17),  # slots not a multiple of 64
])
def test_kernel_matches_plain_version_on_card(cuda_device, packed, bins,
                                              db_tile, metric, n_query,
                                              k_sel):
    n = 3 * db_tile - 100
    z = _database(n, 3 * db_tile)
    if metric == "cosine":
        z[:n] /= np.linalg.norm(z[:n], axis=1, keepdims=True) + 1e-8
    zq = torch.from_numpy(z[:n_query]).to(cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    _assert_matches_plain(zq, zd, n, metric=metric, bins=bins, k_sel=k_sel,
                          packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("d,metric", [(3, "cosine"), (8, "euclidean"),
                                      (29, "euclidean"), (128, "euclidean")])
def test_feature_widths(cuda_device, d, metric):
    # k-steps of 8 with zero columns past D, and at D = 128 the 64-row
    # blocks that fit shared memory
    n = 2 * 1024 - 37
    z = _database(n, 2 * 1024, d=d, seed=d)
    if metric == "cosine":
        z[:n] /= np.linalg.norm(z[:n], axis=1, keepdims=True) + 1e-8
    zq = torch.from_numpy(z[:200]).to(cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    _assert_matches_plain(zq, zd, n, metric=metric, bins=512, k_sel=29,
                          packed=True)


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins", [(True, 1024), (False, 640)])
def test_few_valid_rows_in_a_large_database(cuda_device, packed, bins):
    # most slots see one valid row or none: their entries are padding
    # (+inf) or never filled, and the extraction runs past the finite ones
    rows = 16 * bins
    n = bins + bins // 3
    z = _database(n, rows, seed=8)
    zq = torch.from_numpy(z[:257]).to(cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    kd, ki = _assert_matches_plain(zq, zd, n, metric="euclidean", bins=bins,
                                   k_sel=128, packed=packed)
    assert (ki < n).all()


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins", [(True, 128), (False, 640),
                                         (True, 1024)])
def test_duplicate_rows_and_ties_across_slots_and_blocks(cuda_device, packed,
                                                         bins):
    # every point three times: in the next slot, and in the same slot one
    # block later, so equal distances tie within a slot's top-2, across
    # slots and across blocks
    rng = np.random.default_rng(3)
    n_blocks = 6
    base = rng.normal(0, 1.0, size=(bins // 2, 16)).astype(np.float32)
    z = np.zeros((n_blocks * bins, 16), np.float32)
    for b in range(0, n_blocks, 2):
        z[b * bins:(b + 1) * bins:2] = base
        z[b * bins + 1:(b + 1) * bins:2] = base
        z[(b + 1) * bins:(b + 2) * bins:2] = base
    n = z.shape[0] - 5
    zq = torch.from_numpy(np.concatenate([base[:150], z[7:90]])).to(
        cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    _assert_matches_plain(zq, zd, n, metric="euclidean", bins=bins, k_sel=29,
                          packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins", [(True, 1024), (False, 640)])
def test_width_32_duplicates_and_ties_across_slots_and_blocks(cuda_device,
                                                              packed, bins):
    # D = 32, CIFAR's latent: the walks keep the query fragments in
    # registers, 128 query rows a block. Every point three times (the next
    # slot, and the same slot a block later), and 233 query rows: not a
    # multiple of the block's rows
    rng = np.random.default_rng(4)
    n_blocks = 6
    base = rng.normal(0, 1.0, size=(bins // 2, 32)).astype(np.float32)
    z = np.zeros((n_blocks * bins, 32), np.float32)
    for b in range(0, n_blocks, 2):
        z[b * bins:(b + 1) * bins:2] = base
        z[b * bins + 1:(b + 1) * bins:2] = base
        z[(b + 1) * bins:(b + 2) * bins:2] = base
    n = z.shape[0] - 5
    zq = torch.from_numpy(np.concatenate([base[:150], z[7:90]])).to(
        cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    _assert_matches_plain(zq, zd, n, metric="euclidean", bins=bins, k_sel=29,
                          packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins,n_query", [(True, 1024, 1000),
                                                 (False, 640, 1000),
                                                 (True, 1024, 4097)])
def test_width_32_clustered_database(cuda_device, packed, bins, n_query):
    # the CIFAR codebook stage's shape, cut: clustered rows at D = 32,
    # k_sel 29, a padded tail
    rows = 16 * bins
    n = rows - 300
    z = _database(n, rows, d=32, seed=12)
    zq = torch.from_numpy(z[:n_query]).to(cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    _assert_matches_plain(zq, zd, n, metric="euclidean", bins=bins, k_sel=29,
                          packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("packed,bins", [(True, 256), (False, 384)])
def test_rows_past_the_candidate_list_settle_in_full(cuda_device, packed,
                                                     bins):
    # 600 copies of one point overflow a query row's candidate list; with
    # 20 valid rows fewer than k_sel entries are finite: both rows take
    # the full per-slot settle
    z = _database(8 * bins, 8 * bins, seed=9)
    z[:600] = z[0]
    zq = torch.from_numpy(z[:130]).to(cuda_device)
    zd = torch.from_numpy(z).to(cuda_device)
    _assert_matches_plain(zq, zd, 8 * bins, metric="euclidean", bins=bins,
                          k_sel=29, packed=packed)
    _assert_matches_plain(zq, zd, 20, metric="euclidean", bins=bins,
                          k_sel=29, packed=packed)


@pytest.mark.cuda
def test_wrapper_raises_on_card_instead_of_falling_back(cuda_device):
    z = torch.zeros((384, 16), device=cuda_device)
    with pytest.raises(ValueError):
        fused_select(z, z, 384, metric="euclidean", bins=256, k_sel=9,
                     packed=True)  # 384 rows not a multiple of bins
    wide = torch.zeros((256, 130), device=cuda_device)
    with pytest.raises(ValueError, match="D <= 128"):
        fused_select(wide, wide, 256, metric="euclidean", bins=128, k_sel=9,
                     packed=True)
