"""Kernel K4 (gather-min) against its plain PyTorch version on the card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one. The file imports no JAX, so it also runs on a GPU host without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_gather_min_cuda.py``. Min is exact: results must be equal
bit for bit, NaN included. The kernel has two routes (gather and scan);
``gather_min`` picks one, and ``_launch`` forces each on the same inputs.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops import gather_min as gm
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
    routes = dict(gather_min.route_launches)
    out = gather_min(d, idx)
    assert gather_min.launches == before + 1
    route = gm.gather_min_route(r, n, k)
    assert gather_min.route_launches[route] == routes[route] + 1
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


def _assert_same(out, ref):
    """Equal bit for bit, NaN where the plain version has NaN."""
    assert out.shape == ref.shape
    nan = ref.isnan()
    assert torch.equal(out.isnan(), nan)
    assert torch.equal(out[~nan], ref[~nan])


def _case(name, rng):
    """(d, idx) of one of the edge cases, on the host."""
    if name == "nan-in-absent-row":
        d = rng.random((3000, 256), dtype=np.float32)
        idx = rng.integers(0, 1500, 4000).astype(np.int32)
        d[2999, :] = np.nan  # never gathered
        d[idx[7], 3] = np.nan  # gathered: column 3 is NaN
        return d, idx
    if name == "one-row":
        d = rng.random((4096, 1024), dtype=np.float32)
        return d, np.full(70_000, 1234, np.int32)
    if name == "sparse":
        d = rng.random((200_000, 64), dtype=np.float32)
        return d, rng.integers(0, 200_000, 5).astype(np.int32)
    if name == "heavy-duplicates":
        d = rng.random((1000, 512), dtype=np.float32)
        return d, rng.integers(0, 1000, 64 * 1000).astype(np.int32)
    if name == "narrow-rows":
        d = rng.random((50_000, 36), dtype=np.float32)
        return d, rng.integers(0, 50_000, 300_000).astype(np.int32)
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("route", gm.ROUTES)
@pytest.mark.parametrize("name", ["nan-in-absent-row", "one-row", "sparse",
                                  "heavy-duplicates", "narrow-rows"])
def test_each_route_matches_plain_version_on_card(cuda_device, name, route):
    d, idx = _case(name, np.random.default_rng(7))
    d = torch.from_numpy(d).to(cuda_device)
    idx = torch.from_numpy(idx).to(cuda_device)
    before = gather_min.route_launches[route]
    out = gm._launch(d, idx, route)
    assert gather_min.route_launches[route] == before + 1
    ref = gather_min_reference(d, idx)
    torch.cuda.synchronize()
    _assert_same(out, ref)
    if name == "nan-in-absent-row":
        assert out[0, 3].isnan() and int(out.isnan().sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", gm.ROUTES)
def test_misaligned_rows_take_the_scalar_path_on_card(cuda_device, route):
    rng = np.random.default_rng(8)
    n, k = 5000, 256
    flat = torch.from_numpy(rng.random(n * k + 1, dtype=np.float32)).to(
        cuda_device)
    d = flat[1:].view(n, k)  # contiguous, 4 bytes past a 16-byte boundary
    assert d.is_contiguous() and d.data_ptr() % 16 == 4
    idx = torch.from_numpy(rng.integers(0, n, 20_000).astype(np.int32)).to(
        cuda_device)
    out = gm._launch(d, idx, route)
    ref = gather_min_reference(d, idx)
    torch.cuda.synchronize()
    _assert_same(out, ref)


@pytest.mark.cuda
def test_unknown_route_raises_on_card(cuda_device):
    d = torch.zeros((10, 8), device=cuda_device)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        gm._launch(d, idx, "fallback")
