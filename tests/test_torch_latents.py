"""Port parity: latent artifacts cross between the two packages unchanged.

The same seeded (N, 4, 4, C) latents are written by one package and read
by the other (``latents.npz``, NHWC), read from a reference-style directory
of NCHW ``.pt`` tensors by both, and flattened to graph nodes by both.
Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu.utils import latents as jax_latents
from vqvae_tpu_torch.utils import latents

KEYS = ("z", "mu", "logvar", "y")


def _arrays():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(6, 4, 4, 8)).astype(np.float32)
    return {"z": z, "mu": z + 1.0, "logvar": z - 1.0,
            "y": rng.integers(0, 10, size=6)}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


@pytest.mark.parametrize("writer,reader", [
    (latents.save_latents, jax_latents.load_latents),
    (jax_latents.save_latents, latents.load_latents),
], ids=["port_to_jax", "jax_to_port"])
def test_npz_crosses_between_packages(tmp_path, writer, reader):
    arrays = _arrays()
    path = writer(tmp_path / "lat", *(arrays[k] for k in KEYS))
    _assert_same(reader(tmp_path / "lat"), arrays)
    _assert_same(reader(path), arrays)


def test_reference_pt_directory_loads_as_nhwc(tmp_path):
    arrays = _arrays()
    for key, arr in arrays.items():
        t = torch.from_numpy(arr)
        torch.save(t.permute(0, 3, 1, 2).contiguous() if arr.ndim == 4 else t,
                   tmp_path / f"{key}.pt")
    got = latents.load_latents(tmp_path)
    _assert_same(got, jax_latents.load_latents(tmp_path))
    _assert_same(got, arrays)


def test_flatten_spatial_node_order_matches():
    z = _arrays()["z"]
    np.testing.assert_array_equal(latents.flatten_spatial(z),
                                  jax_latents.flatten_spatial(z))
    with pytest.raises(ValueError):
        latents.flatten_spatial(z[0])
