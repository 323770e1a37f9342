"""Kernel K4 (gather-min) against its plain PyTorch version on the card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one. The file imports no JAX, so it also runs on a GPU host without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_gather_min_cuda.py``. Min is exact: results must be equal
bit for bit, NaN included.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops.gather_min import gather_min, gather_min_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,r,nan", [
    (2048, 128, 2048, False), (2048, 256, 2048, True),
    (4096, 1024, 5000, False),   # ragged last chunk
    (500, 36, 1030, False),      # narrow rows, several row groups
    (300, 130, 777, True),       # K % 4 != 0: scalar loads
    (1000, 2056, 3000, False),   # two column tiles
])
def test_kernel_matches_plain_version_on_card(cuda_device, n, k, r, nan):
    rng = np.random.default_rng(n + k + r)
    d = rng.random((n, k), dtype=np.float32)
    idx = rng.integers(0, n, r).astype(np.int32)
    if nan:
        d[idx[r // 2], 7] = np.nan
    d = torch.from_numpy(d).to(cuda_device)
    idx = torch.from_numpy(idx).to(cuda_device)
    before = gather_min.launches
    out = gather_min(d, idx)
    assert gather_min.launches == before + 1
    ref = gather_min_reference(d, idx)
    torch.cuda.synchronize()
    assert out.shape == (1, k)
    assert torch.equal(out, ref) or (
        nan and torch.equal(out.isnan(), ref.isnan())
        and torch.equal(out[~out.isnan()], ref[~ref.isnan()]))
    assert bool(out[0, 7].isnan()) == nan


@pytest.mark.cuda
def test_wrapper_checks_indices_on_card(cuda_device):
    d = torch.zeros((10, 8), device=cuda_device)
    with pytest.raises(IndexError):
        gather_min(d, torch.tensor([0, 10], dtype=torch.int32,
                                   device=cuda_device))
