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
@pytest.mark.parametrize("n,d,k", [(160_000, 16, 512), (1037, 5, 130),
                                   (300, 16, 37), (20, 4, 1),
                                   (4099, 33, 700), (64, 128, 9000)])
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
