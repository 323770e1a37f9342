"""Port parity: image-quality and codebook-health metrics.

Masked ``psnr`` / ``ssim_simple`` (the training engine's eval step) against
the JAX versions within rtol 1e-5 (float order of the sums); the numpy
twins and ``codebook_stats`` are copies and must match exactly, including
the reference's ``+`` denominator in the batch SSIM and -1 codes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.eval import metrics as jm
from vqvae_tpu_torch.eval import metrics as pm


def _images(seed, shape=(8, 28, 28, 1)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape).astype(np.float32), 0, 1)
    return x, y


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(8, 28, 28, 1), (5, 32, 32, 3)])
def test_tensor_metrics_match_jax(masked, shape):
    x, y = _images(0, shape)
    mask = None
    if masked:
        mask = np.ones(shape[0], np.float32)
        mask[-3:] = 0.0
        y[-3:] = 0.0  # padded rows: excluded, or they would dominate
    jm_mask = None if mask is None else jnp.asarray(mask)
    pt_mask = None if mask is None else torch.from_numpy(mask)
    ref_p = float(jm.psnr(jnp.asarray(x), jnp.asarray(y), mask=jm_mask))
    ref_s = float(jm.ssim_simple(jnp.asarray(x), jnp.asarray(y),
                                 mask=jm_mask))
    got_p = float(pm.psnr(torch.from_numpy(x), torch.from_numpy(y),
                          mask=pt_mask))
    got_s = float(pm.ssim_simple(torch.from_numpy(x), torch.from_numpy(y),
                                 mask=pt_mask))
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-5)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-5)


def test_single_image_ssim_takes_the_product_branch():
    x, y = _images(1, (28, 28, 1))
    ref = float(jm.ssim_simple(jnp.asarray(x), jnp.asarray(y)))
    got = float(pm.ssim_simple(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    batch = float(pm.ssim_simple(torch.from_numpy(x[None]),
                                 torch.from_numpy(y[None])))
    assert batch != pytest.approx(got, rel=1e-3)  # '+' vs '*' denominator


@pytest.mark.parametrize("shape", [(6, 28, 28, 1), (28, 28, 1)])
def test_numpy_twins_are_identical(shape):
    x, y = _images(2, shape)
    assert pm.psnr_np(x, y) == jm.psnr_np(x, y)
    assert pm.ssim_simple_np(x, y) == jm.ssim_simple_np(x, y)
    assert pm.psnr_np(x, x) == jm.psnr_np(x, x)  # the 1e-12 MSE floor


@pytest.mark.parametrize("codes", [
    np.array([[0, 1, 1], [3, -1, 3]]),
    np.full((4, 4), -1),
    np.random.default_rng(3).integers(-1, 16, size=(50, 4, 4)),
])
def test_codebook_stats_identical(codes):
    assert pm.codebook_stats(codes, K=16) == jm.codebook_stats(codes, K=16)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_grid_pixels_match_the_jax_packages(tmp_path, channels):
    """The port writes PNGs with its own encoder; PIL reads back the pixels
    the JAX package writes through PIL, and the display mapping matches."""
    from PIL import Image

    from vqvae_tpu.utils import images as ji
    from vqvae_tpu_torch.utils import images as pi

    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (10, 28, 28, channels)).astype(np.float32)
    for name, sig in (("fashionmnist", True), ("CIFAR10", False),
                      ("mnist", False)):
        np.testing.assert_array_equal(pi.unnormalize_images(x, name, sig),
                                      ji.unnormalize_images(x, name, sig))
    imgs = pi.unnormalize_images(x, "fashionmnist", True)
    np.testing.assert_array_equal(pi.make_grid(imgs, nrow=4),
                                  ji.make_grid(imgs, nrow=4))
    ji.save_image_grid(imgs, tmp_path / "jax.png", nrow=4)
    pi.save_image_grid(imgs, tmp_path / "port.png", nrow=4)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
