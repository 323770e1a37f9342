"""Port parity for kernel K3: nearest-code assignment.

The port's plain version ``nearest_codes_reference`` (what ``nearest_codes``
runs on a CPU tensor) against the JAX ``nearest_codes`` in interpret mode,
on the cases of ``tests/test_pallas_assign.py`` and at the quality stage's
width (16,000 rows x 16 against 512 codes). Indices must be identical;
squared distances agree within rtol 1e-5 / atol 1e-6 (the product and the
norm sums round in another order).
"""
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.pallas_assign import nearest_codes as jax_nearest_codes
from vqvae_tpu_torch.ops.assign import nearest_codes, nearest_codes_reference


def _cases():
    rng = np.random.RandomState(0)
    yield "oracle", rng.randn(300, 16), rng.randn(37, 16)
    rng = np.random.RandomState(1)
    yield "ragged", rng.randn(1037, 5), rng.randn(130, 5)
    rng = np.random.RandomState(2)
    cb = rng.randn(16, 8)
    yield "exact", cb[[3, 7, 3]], cb
    rng = np.random.RandomState(3)
    yield "single", rng.randn(20, 4), rng.randn(1, 4)
    # val-like rows against medoid-like codes: independent draws from one
    # clustered distribution, as val latents and train medoids are
    rng = np.random.default_rng(4)
    centers = rng.normal(0, 1.2, size=(10, 16))
    z = centers[rng.integers(0, 10, 16_512)] + rng.normal(0, 1, (16_512, 16))
    yield "quality", z[:16_000], z[16_000:]


@pytest.mark.parametrize("name,z,cb", [(n, z.astype(np.float32),
                                        cb.astype(np.float32))
                                       for n, z, cb in _cases()],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_plain_version_matches_jax_kernel(name, z, cb):
    ref_idx, ref_d = jax_nearest_codes(z, cb, interpret=True)
    idx, dist = nearest_codes_reference(torch.from_numpy(z),
                                        torch.from_numpy(cb))
    assert idx.dtype == torch.int64 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(dist.numpy(), ref_d, rtol=1e-5, atol=1e-6)
    if name == "exact":
        np.testing.assert_array_equal(idx.numpy(), [3, 7, 3])
    if name == "single":
        assert (idx == 0).all()


def test_wrapper_on_cpu_tensors_and_host_arrays_is_the_plain_version():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(257, 12)).astype(np.float32)
    cb = rng.normal(size=(33, 12)).astype(np.float32)
    before = nearest_codes.launches
    want = nearest_codes_reference(torch.from_numpy(z), torch.from_numpy(cb))
    for got in (nearest_codes(torch.from_numpy(z), torch.from_numpy(cb)),
                nearest_codes(z, cb, device="cpu")):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert nearest_codes.launches == before  # no kernel on the CPU


def test_ties_go_to_the_lowest_code():
    cb = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]], np.float32)
    z = np.array([[0.5, 0.5], [1.0, 0.0]], np.float32)
    idx, dist = nearest_codes(z, cb, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), [0, 0])
    ref_idx, _ = jax_nearest_codes(z, cb, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)


@pytest.mark.parametrize("d,k,lo,hi", [(16, 512, 127, 128),
                                      (128, 200, 20, 70)])
def test_duplicate_codes_far_apart_take_the_lower_index(d, k, lo, hi):
    # the card kernel splits codes over warps and chunks (csrc/assign.cu):
    # these pairs straddle a warp split and a chunk boundary there
    rng = np.random.default_rng(d + k)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    cb[hi] = cb[lo]
    z = (cb[lo] + 1e-3 * rng.normal(size=(33, d))).astype(np.float32)
    idx, dist = nearest_codes(z, cb, device="cpu")
    ref_idx, ref_dist = jax_nearest_codes(z, cb, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert (idx.numpy() == lo).all()
    # |c|^2 - 2 z.c + |z|^2 cancels at z ~ c: only the indices compare
    assert (dist.numpy() >= 0).all() and np.isfinite(dist.numpy()).all()


def test_tuning_variants_apply_to_the_shipped_source():
    # tools/tune_assign.py rewrites constants of csrc/assign.cu: each
    # variant must find its anchors, and "shipped" must be the source
    from vqvae_tpu_torch._build import CSRC_DIR
    from vqvae_tpu_torch.tools import tune_assign

    src = (CSRC_DIR / "assign.cu").read_text()
    for name, params in tune_assign.VARIANTS.items():
        assert (tune_assign.variant_source(src, *params) == src) == (
            name == "shipped"), name
