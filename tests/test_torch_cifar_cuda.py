"""Kernels K1 and K3 at the CIFAR-10 spatial preset's width, D = 32, at
the shapes its stages give them, against their plain PyTorch versions on
the card.

- K1 (packed, bins 1024, k_sel 29: k = 20 plus the self-match plus the
  margin 8) in the codebook stage's one launch: 65,536 query rows (4,096
  images x 16 cells) against the same 65,536-row database;
- K3 in the quality stage's two launches: 16,000 rows (the quantization
  loss's 1,000 images) and 160,000 rows (the codebook health's 10,000
  val images), against 512 codes.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and
skips without one. The file imports no JAX: ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_cifar_cuda.py``.
Tolerances are the kernels' own files' (``test_torch_knn_select_cuda.py``,
``test_torch_assign_cuda.py``): at most 1e-3 of K1's rows may differ,
only at near-ties within 1e-5 relative of the plain k_sel-th value, the
other rows' values within rtol 1e-5, atol 1e-4; K3's indices may differ
on at most 1e-4 of the rows, only where the two codes' exact distances
are within 1e-5 relative, distances within rtol 1e-5, atol 1e-5.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops.assign import nearest_codes, nearest_codes_reference
from vqvae_tpu_torch.ops.knn_select import fused_select, fused_select_reference

D = 32
NODES = 65_536
K_SEL = 29


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _latents(n, seed):
    """Clustered latents as ``bench.py``'s, at D = 32."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.2, size=(10, D)).astype(np.float32)
    z = centers[rng.integers(0, 10, size=n)]
    return (z + rng.normal(0, 1.0, size=z.shape)).astype(np.float32)


@pytest.mark.cuda
def test_k1_at_the_codebook_stage_shape(cuda_device):
    zd = torch.from_numpy(_latents(NODES, 0)).to(cuda_device)
    before = fused_select.launches
    kd, ki = fused_select(zd, zd, NODES, metric="euclidean", bins=1024,
                          k_sel=K_SEL, packed=True)
    assert fused_select.launches == before + 1
    rd, ri = fused_select_reference(zd, zd, NODES, metric="euclidean",
                                    bins=1024, k_sel=K_SEL, packed=True)
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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16_000, 160_000])
def test_k3_at_the_quality_stage_shapes(cuda_device, rows):
    z = _latents(rows + 512, rows)
    zd = torch.from_numpy(z[:rows]).to(cuda_device)
    cb = torch.from_numpy(z[rows:]).to(cuda_device)  # medoid-like rows
    before = nearest_codes.launches
    idx, dist = nearest_codes(zd, cb)
    assert nearest_codes.launches == before + 1
    ref_idx, ref_dist = nearest_codes_reference(zd, cb)
    torch.cuda.synchronize()
    differ = torch.nonzero(idx != ref_idx).flatten()
    assert differ.numel() <= 1e-4 * rows
    if differ.numel():
        zz = zd[differ].double()
        a = ((zz - cb[idx[differ]].double()) ** 2).sum(1)
        b = ((zz - cb[ref_idx[differ]].double()) ** 2).sum(1)
        assert ((a - b).abs() <= 1e-5 * torch.minimum(a, b)).all()
    same = idx == ref_idx
    torch.testing.assert_close(dist[same], ref_dist[same], rtol=1e-5,
                               atol=1e-5)
