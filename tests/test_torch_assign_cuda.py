"""Kernel K3 (nearest-code assignment) against its plain PyTorch version on
the card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one. The file imports no JAX, so it also runs on a GPU host without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_assign_cuda.py``.

The kernel sums its dot products as f32 fused multiply-add chains, the
plain version through a matrix product: indices may differ only where the
two best codes are within 1e-5 relative of each other, distances within
rtol 1e-5 (or 1e-5 absolute near 0, where |c|^2 - 2 z.c + |z|^2 cancels).
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops.assign import nearest_codes, nearest_codes_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _check_near_ties(z, cb, idx, ref_idx):
    differ = torch.nonzero(idx != ref_idx).flatten()
    if differ.numel():
        d = ((z[differ, None, :].double() - cb[None].double()) ** 2).sum(-1)
        a = d.gather(1, idx[differ, None]).flatten()
        b = d.gather(1, ref_idx[differ, None]).flatten()
        assert ((a - b).abs() <= 1e-5 * torch.minimum(a, b).abs()
                + 1e-6).all()
    return differ.numel() / max(z.shape[0], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [
    (160_000, 16, 512), (1037, 5, 130), (300, 16, 37), (20, 4, 1),
    (4099, 33, 700), (64, 128, 9000),
    (5000, 16, 1),                  # one code: seven warps without codes
    (3000, 16, 517), (700, 8, 13),  # K not a multiple of the warps' share
    (50, 16, 512),                  # fewer rows than one tile
    (12_800, 16, 512),              # 100 tiles: a grid under the 132 SMs
    (2000, 100, 300),               # padded width 128: chunks of 64 codes
])
def test_kernel_matches_plain_version_on_card(cuda_device, n, d, k):
    rng = np.random.default_rng(n + d + k)
    z = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        cuda_device)
    cb = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(
        cuda_device)
    before = nearest_codes.launches
    idx, dist = nearest_codes(z, cb)
    assert nearest_codes.launches == before + 1
    ref_idx, ref_dist = nearest_codes_reference(z, cb)
    torch.cuda.synchronize()
    assert _check_near_ties(z, cb, idx, ref_idx) <= 1e-4
    same = idx == ref_idx
    torch.testing.assert_close(dist[same], ref_dist[same], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_exact_codes_and_host_arrays(cuda_device):
    rng = np.random.default_rng(2)
    cb = rng.normal(size=(16, 8)).astype(np.float32)
    idx, dist = nearest_codes(cb[[3, 7, 3]], cb)  # host arrays -> cuda
    assert idx.device.type == "cuda"
    assert idx.tolist() == [3, 7, 3] and (dist < 1e-3).all()


@pytest.mark.cuda
def test_wrapper_raises_on_card_instead_of_falling_back(cuda_device):
    z = torch.zeros((8, 129), device=cuda_device)
    with pytest.raises(ValueError):
        nearest_codes(z, z)  # wider than the kernel holds in registers


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,lo,hi", [
    (16, 512, 127, 128),  # last code of warp 0, first of warp 1
    (16, 512, 5, 500),    # warps 0 and 3
    (128, 200, 20, 70),   # warp 1 of chunk 0 and warp 0 of chunk 1
    (4, 3000, 1023, 2900),  # chunks 0 and 2
])
def test_duplicate_codes_across_a_split_take_the_lower_index_on_card(
        cuda_device, d, k, lo, hi):
    rng = np.random.default_rng(d + k)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    cb[hi] = cb[lo]
    z = (cb[lo] + 1e-3 * rng.normal(size=(257, d))).astype(np.float32)
    z[0] = cb[lo]
    z = torch.from_numpy(z).to(cuda_device)
    cbt = torch.from_numpy(cb).to(cuda_device)
    idx, dist = nearest_codes(z, cbt)
    ref_idx, ref_dist = nearest_codes_reference(z, cbt)
    torch.cuda.synchronize()
    assert idx[0] == lo and ref_idx[0] == lo
    assert not (idx == hi).any()
    assert _check_near_ties(z, cbt, idx, ref_idx) <= 1e-2
    same = idx == ref_idx
    torch.testing.assert_close(dist[same], ref_dist[same], rtol=1e-5,
                               atol=1e-5)
