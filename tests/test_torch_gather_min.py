"""Port parity for kernel K4: the gather-min tool.

The port's plain version ``gather_min_reference`` (what ``gather_min`` runs
on a CPU tensor) against the JAX tool's ``pallas_gather_min`` in interpret
mode, on the cases of ``tests/test_pallas_gather.py`` and with a NaN in a
gathered row (``jnp.minimum`` propagates it). Min is exact: the results
must be equal bit for bit. The kernel's scan route computes the presence
formulation ``d[unique(idx)].amin(0)``: it is held against the JAX tool
too, with a NaN in a gathered row and another in a row never gathered.
The route rule is checked on the tool's shapes. The port's tool entry
point runs at a tiny size.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops.gather_min import (CHUNK, gather_min,
                                            gather_min_reference,
                                            gather_min_route)
from vqvae_tpu_torch.tools import bench_gather_min

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import bench_pallas_gather as jax_tool  # noqa: E402


@pytest.mark.parametrize("k,slots,nan", [(128, 2, False), (256, 8, False),
                                         (128, 2, True)])
def test_plain_version_matches_jax_kernel(k, slots, nan):
    rng = np.random.default_rng(1)
    d = rng.random((2048, k), dtype=np.float32)
    idx = rng.integers(0, 2048, jax_tool.CHUNK * 2).astype(np.int32)
    if nan:
        d[idx[5], 17] = np.nan
    ref = np.asarray(jax_tool.pallas_gather_min(
        jnp.asarray(d), jnp.asarray(idx), slots=slots, interpret=True))
    out = gather_min_reference(torch.from_numpy(d), torch.from_numpy(idx))
    assert out.shape == ref.shape == (1, k)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.isnan(out[0, 17].item()) == nan


def test_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    d = rng.random((500, 36), dtype=np.float32)
    idx = rng.integers(0, 500, CHUNK + 3).astype(np.int32)
    before = gather_min.launches
    want = gather_min_reference(torch.from_numpy(d), torch.from_numpy(idx))
    for got in (gather_min(torch.from_numpy(d), torch.from_numpy(idx)),
                gather_min(d, idx, device="cpu")):
        assert torch.equal(got, want)
    assert gather_min.launches == before  # no kernel on the CPU
    with pytest.raises(IndexError):
        gather_min(d, np.array([0, 500], np.int32), device="cpu")
    empty = gather_min(d, np.zeros(0, np.int32), device="cpu")
    assert torch.isinf(empty).all() and empty.shape == (1, 36)


def test_tool_entry_point_runs_at_a_tiny_size(capsys):
    res = bench_gather_min.main(["--rows", "2048", "--n", "512",
                                 "--widths", "128,36", "--device", "cpu"])
    assert sorted(res) == [36, 128]
    for r in res.values():
        assert r["kernel"]["seconds"] > 0 and r["library"]["seconds"] > 0
    assert "K=  128" in capsys.readouterr().out


@pytest.mark.parametrize("k,nan_present,nan_absent", [
    (128, True, True), (256, False, True), (128, True, False)])
def test_presence_formulation_matches_jax_kernel(k, nan_present, nan_absent):
    rng = np.random.default_rng(3)
    n = 2048
    d = rng.random((n, k), dtype=np.float32)
    idx = rng.integers(0, n - 100, jax_tool.CHUNK * 2).astype(np.int32)
    absent = np.setdiff1d(np.arange(n), idx)
    assert absent.size >= 100
    if nan_present:
        d[idx[11], 5] = np.nan
    if nan_absent:
        d[absent[0], 9] = np.nan  # no gathered row holds it: must not show
    ref = np.asarray(jax_tool.pallas_gather_min(
        jnp.asarray(d), jnp.asarray(idx), interpret=True))
    dt, it = torch.from_numpy(d), torch.from_numpy(idx)
    presence = dt[torch.unique(it.long())].amin(dim=0, keepdim=True)
    np.testing.assert_array_equal(presence.numpy(), ref)
    np.testing.assert_array_equal(gather_min_reference(dt, it).numpy(), ref)
    assert np.isnan(ref[0, 5]) == nan_present
    assert not np.isnan(ref[0, 9])


@pytest.mark.parametrize("r,n,k,route", [
    (1 << 20, 196_608, 256, "scan"),    # the gather-min tool's shapes
    (1 << 20, 196_608, 512, "scan"),
    (1 << 20, 196_608, 1024, "scan"),
    (4096, 196_608, 1024, "scan"),      # sparse: few present rows
    (5, 200_000, 64, "gather"),         # a handful of rows
    (16, 196_608, 1024, "gather"),      # one block, four steps
    (64, 196_608, 1024, "scan"),        # measured crossover: 16 < R <= 64
    (64, 196_608, 256, "gather"),       # and 64 < R <= 256 at K = 256
    (256, 196_608, 256, "scan"),
    (1 << 20, 196_608, 36, "gather"),   # narrow rows, d (28 MB) in L2
    (256, 1 << 20, 256, "gather"),      # a larger N moves the crossover
    (1024, 1 << 20, 256, "scan"),
    (64, 1 << 20, 1024, "gather"),
    (256, 1 << 20, 1024, "scan"),
])
def test_route_rule(r, n, k, route):
    assert gather_min_route(r, n, k) == route


def test_crossover_mode_refuses_without_card():
    with pytest.raises(SystemExit, match="card"):
        bench_gather_min.main(["--crossover", "5", "--device", "cpu"])
