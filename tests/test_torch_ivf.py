"""Port parity: IVF kNN (``ops/ivf.py``), step by step and end to end.

On JAX's 8,192-row fixture (``tests/test_ivf.py``), on the CPU:
- ``_balance_buckets`` equal to JAX's (the same numpy code);
- the sample Lloyd's centres from the same sample and initial centres
  within rtol 1e-5 (atol 1e-6);
- the top-4 choices from JAX's centres identical except at near-tie rows:
  a row may differ only where the fast-form values it swaps lie within
  1e-5 relative of each other (their products round differently in XLA's
  and torch's matmuls);
- the bucket search from JAX's labels, layout and probe table carried
  across: identical indices except at near-tie rows (the k-th exact
  distances within 1e-6), distances within 1e-6 where indices match;
- end to end, identical indices except at near-tie rows;
then JAX's own contract cases on the port: recall >= 0.92, a full probe
equal to the exact kNN, the caps respected.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops import ivf as jax_ivf
from vqvae_tpu.ops.knn import knn_search as jax_knn_search
from vqvae_tpu_torch.ops import ivf, knn_search_ivf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _latents(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.2, size=(10, d)).astype(np.float32)
    labels = rng.integers(0, 10, size=n)
    return centers[labels] + rng.normal(0, 1.0, size=(n, d)).astype(
        np.float32)


@pytest.fixture(scope="module")
def z8k():
    return _latents(8192)


@pytest.fixture(scope="module")
def jax_steps(z8k):
    """JAX's intermediate results at ``n_centroids=32``: centres, choices,
    labels (the same draws as ``knn_search_ivf``)."""
    n, C, cap = 8192, 32, 320
    rng = np.random.default_rng(0)
    init = z8k[rng.choice(n, size=C, replace=False)]
    centers = np.array(jax_ivf._lloyd_sample(jnp.asarray(z8k),
                                               jnp.asarray(init), 10))
    choices = np.asarray(jax_ivf._assign_topc(jnp.asarray(z8k),
                                              jnp.asarray(centers), 8192, 4))
    labels = jax_ivf._balance_buckets(choices, C, cap)
    return {"init": init, "centers": centers, "choices": choices,
            "labels": labels, "C": C, "cap": cap}


def _choices(rows, n, C, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(C)[:4] for _ in range(rows)])


@pytest.mark.parametrize("case", ["random", "skewed", "overfull"])
def test_balance_buckets_matches_jax(case):
    C, n, cap = 16, 1000, 80
    choices = _choices(n, n, C, 0)
    if case == "skewed":
        choices[:, 0] = 3
    elif case == "overfull":  # every candidate full: the least-loaded spill
        choices[:, :] = choices[:, :1]
        cap = 70
    np.testing.assert_array_equal(ivf._balance_buckets(choices, C, cap),
                                  jax_ivf._balance_buckets(choices, C, cap))


def test_lloyd_sample_matches_jax(z8k, jax_steps):
    out = ivf._lloyd_sample(torch.from_numpy(z8k),
                            torch.from_numpy(jax_steps["init"]), 10)
    np.testing.assert_allclose(out.numpy(), jax_steps["centers"], rtol=1e-5,
                               atol=1e-6)


def test_assign_topc_matches_jax_except_near_ties(z8k, jax_steps):
    centers = jax_steps["centers"]
    got = ivf._assign_topc(torch.from_numpy(z8k), torch.from_numpy(centers),
                           8192, 4).numpy()
    want = jax_steps["choices"]
    d2 = (z8k ** 2).sum(1)[:, None] - 2.0 * (z8k @ centers.T) \
        + (centers ** 2).sum(1)[None, :]
    differ = np.nonzero((got != want).any(1))[0]
    assert len(differ) <= 8, differ
    for r in differ:
        a = d2[r, got[r]]
        b = d2[r, want[r]]
        np.testing.assert_allclose(np.sort(a), np.sort(b), rtol=1e-5)


def test_topk_smallest_takes_lower_index_first_as_lax():
    import jax

    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, size=(64, 40)).astype(np.float32)  # many ties
    x[0, :] = 0.0
    x[1, 7] = -0.0
    got = ivf.topk_smallest(torch.from_numpy(x), 9).numpy()
    want = np.asarray(jax.lax.top_k(-jnp.asarray(x), 9)[1])
    np.testing.assert_array_equal(got, want)


def test_search_matches_jax_from_its_layout(z8k, jax_steps):
    C, cap, P = jax_steps["C"], jax_steps["cap"], 16
    labels, choices = jax_steps["labels"], jax_steps["choices"]
    bucket_ids = ivf._bucket_ids(labels, C, cap)
    probe = ivf._probe_table(jax_steps["centers"], labels, choices, P)
    bz = z8k[np.maximum(bucket_ids, 0)]
    ref_d, ref_i = (np.asarray(a) for a in jax_ivf._ivf_search(
        jnp.asarray(bz), jnp.asarray(bucket_ids), jnp.asarray(probe), 9, 13))
    got_d, got_i = (a.numpy() for a in ivf._ivf_search(
        torch.from_numpy(bz), torch.from_numpy(bucket_ids),
        torch.from_numpy(probe).long(), 9, 13))
    valid = bucket_ids >= 0
    same = got_i == ref_i
    np.testing.assert_allclose(np.where(same, got_d, 0.0),
                               np.where(same, ref_d, 0.0), atol=1e-6)
    rows = np.nonzero(valid & ~same.all(-1))
    assert len(rows[0]) <= 8
    for b, r in zip(*rows):  # near-ties at the boundary only
        assert abs(got_d[b, r, -1] - ref_d[b, r, -1]) <= 1e-6


def test_end_to_end_matches_jax(z8k):
    ref_d, ref_i = jax_ivf.knn_search_ivf(z8k, 9, n_centroids=32,
                                          n_probe=16, seed=0)
    stats = {}
    d, i = knn_search_ivf(z8k, 9, n_centroids=32, n_probe=16, seed=0,
                          device="cpu", stats=stats)
    assert (stats["C"], stats["P"], stats["cap"], stats["k_sel"]) == (
        32, 16, 320, 13)
    assert {"lloyd", "top4", "balance", "layout", "probe_table", "search",
            "scatter"} <= set(stats)
    differ = np.nonzero((i != ref_i).any(1))[0]
    assert len(differ) <= 8, differ
    for r in differ:
        assert abs(d[r, -1] - ref_d[r, -1]) <= 1e-6 * max(ref_d[r, -1], 1)
    same = i == ref_i
    assert np.abs(np.where(same, d - ref_d, 0.0)).max() <= 1e-6


def test_environment_knobs_as_jax(monkeypatch):
    z = _latents(2048, seed=2)
    monkeypatch.setenv("VQVAE_TPU_IVF_PROBE", "4")
    monkeypatch.setenv("VQVAE_TPU_IVF_CENTROIDS", "16")
    monkeypatch.setenv("VQVAE_TPU_KNN_MARGIN", "2")
    stats = {}
    d, i = knn_search_ivf(z, 5, device="cpu", stats=stats)
    assert (stats["C"], stats["P"], stats["k_sel"]) == (16, 4, 7)
    ref_d, ref_i = jax_ivf.knn_search_ivf(z, 5)
    assert (i != ref_i).any(1).sum() <= 4


def _contract(case):
    if case == "recall_band":
        z = _latents(8192)
        d_ref, i_ref = jax_knn_search(z, 9)
        d, i = knn_search_ivf(z, 9, n_centroids=32, n_probe=16, seed=0,
                              device="cpu")
        assert d.shape == (8192, 9) and i.shape == (8192, 9)
        assert (i[:, 0] == np.arange(8192)).mean() > 0.999
        assert (d[:, 0] <= 1e-5).all()
        assert (np.diff(d, axis=1) >= -1e-6).all()
        match = i == i_ref
        assert np.abs(np.where(match, d - d_ref, 0.0)).max() < 1e-5
        rec = np.mean([len(set(i_ref[q]) & set(i[q])) / 9
                       for q in range(0, 8192, 17)])
        assert rec >= 0.92, rec
    elif case == "full_probe":
        z = _latents(2048, seed=1)
        d_ref, i_ref = jax_knn_search(z, 7)
        d, i = knn_search_ivf(z, 7, n_centroids=16, n_probe=16, seed=1,
                              device="cpu")
        np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
        same = [set(i[q]) == set(i_ref[q]) for q in range(0, 2048, 11)]
        assert np.mean(same) > 0.999
    elif case == "caps":
        rng = np.random.default_rng(0)
        C, n, cap = 16, 1000, 80
        choices = np.stack([rng.permutation(C)[:4] for _ in range(n)])
        labels = ivf._balance_buckets(choices, C, cap)
        assert labels.min() >= 0 and labels.max() < C
        assert np.bincount(labels, minlength=C).max() <= cap
        choices[:, 0] = 3
        labels = ivf._balance_buckets(choices, C, cap)
        counts = np.bincount(labels, minlength=C)
        assert counts[3] == cap and counts.sum() == n


@pytest.mark.parametrize("case", ["recall_band", "full_probe", "caps"])
def test_jax_contract_on_the_port(case):
    _contract(case)
