"""Port parity: Euclidean K-means (``ops/kmeans_euclidean.py``).

Inputs made with numpy from a seed go through the JAX ``fit_kmeans`` and
the port's on the CPU: JAX's ``blobs`` fixture
(``tests/test_kmeans_euclidean.py``) and the spiral of
``tests/test_geodesic_advantage.py``. Tolerances: the k-means++ initial
centres bit for bit (the same numpy code and draws); identical labels;
centres within rtol 1e-5, atol 1e-6; inertia within rtol 1e-5 (an f32 sum
over the rows, in another order). Then JAX's own contract cases, run on
the port.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu.ops import kmeans_euclidean as jax_km
from vqvae_tpu_torch.ops import fit_kmeans
from vqvae_tpu_torch.ops import kmeans_euclidean as km


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs():
    rng = np.random.RandomState(0)
    centers = rng.randn(5, 8) * 5
    z = np.concatenate([c + rng.randn(60, 8) for c in centers])
    return z.astype(np.float32)


def _spiral(n=4096, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1.0, 4.0, size=n).astype(np.float32) * 2 * np.pi
    arm = rng.integers(0, 2, size=n)
    r = 0.25 * t
    x = np.stack([r * np.cos(t + np.pi * arm), r * np.sin(t + np.pi * arm)],
                 axis=1)
    z = np.zeros((n, dim), np.float32)
    z[:, :2] = x
    z += rng.normal(0, 0.02, size=z.shape).astype(np.float32)
    return z


DATA = {"blobs": _blobs, "spiral": _spiral}


@pytest.mark.parametrize("data,K,seed", [("blobs", 5, 0), ("blobs", 4, 3),
                                         ("blobs", 8, 1), ("spiral", 32, 42)])
def test_kpp_init_matches_jax(data, K, seed):
    z = DATA[data]()
    np.testing.assert_array_equal(km.kmeans_plus_plus_init(z, K, seed),
                                  jax_km.kmeans_plus_plus_init(z, K, seed))


@pytest.mark.parametrize("data,K,seed,max_iter", [
    ("blobs", 5, 0, 100), ("blobs", 4, 3, 100), ("blobs", 8, 1, 100),
    ("blobs", 5, 0, 3), ("spiral", 32, 42, 100)])
def test_fit_matches_jax(data, K, seed, max_iter):
    z = DATA[data]()
    ref_c, ref_l, ref_i = jax_km.fit_kmeans(z, K, seed=seed,
                                            max_iter=max_iter)
    c, labels, inertia = fit_kmeans(z, K, seed=seed, max_iter=max_iter,
                                    device="cpu")
    assert c.dtype == np.float32 and labels.dtype == np.int64
    np.testing.assert_array_equal(labels, ref_l)
    np.testing.assert_allclose(c, ref_c, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(inertia, ref_i, rtol=1e-5)


def test_empty_cluster_keeps_its_centre_as_jax():
    """A centre far from every row gets no rows and stays where it is;
    ``tol`` changes nothing (the loop runs ``max_iter`` iterations)."""
    import jax.numpy as jnp

    z = _blobs()
    init = np.concatenate([z[[0, 60, 120]],
                           np.full((1, 8), 1e3, np.float32)])
    ref = jax_km._lloyd(jnp.asarray(z), jnp.asarray(init), 4, 7, 1e-4)
    out = km._lloyd(torch.from_numpy(z), torch.from_numpy(init), 7)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(out[2]), float(ref[2]), rtol=1e-5)
    np.testing.assert_array_equal(out[0][3].numpy(), init[3])
    a = fit_kmeans(z, 5, seed=0, tol=1e-4, device="cpu")
    b = fit_kmeans(z, 5, seed=0, tol=10.0, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])


def _contract(case, z):
    if case == "shapes":
        centers, labels, inertia = fit_kmeans(z, 5, seed=0, device="cpu")
        assert centers.shape == (5, 8)
        assert labels.shape == (300,)
        assert ((labels >= 0) & (labels < 5)).all()
        assert inertia >= 0
    elif case == "sklearn":
        from sklearn.cluster import KMeans

        _, _, ours = fit_kmeans(z, 5, seed=0, device="cpu")
        ref = KMeans(n_clusters=5, n_init=1, random_state=0).fit(z).inertia_
        assert ours <= ref * 1.1
    elif case == "deterministic":
        c1, l1, i1 = fit_kmeans(z, 4, seed=3, device="cpu")
        c2, l2, i2 = fit_kmeans(z, 4, seed=3, device="cpu")
        np.testing.assert_array_equal(l1, l2)
        assert i1 == i2
    elif case == "kpp_distinct":
        init = km.kmeans_plus_plus_init(z, 8, seed=1)
        assert init.shape == (8, 8)
        assert len(np.unique(init, axis=0)) == 8
    elif case == "purity":
        _, labels, _ = fit_kmeans(z, 5, seed=0, device="cpu")
        purity = sum(np.bincount(labels[b * 60:(b + 1) * 60]).max()
                     for b in range(5))
        assert purity / 300 > 0.95


@pytest.mark.parametrize("case", ["shapes", "sklearn", "deterministic",
                                  "kpp_distinct", "purity"])
def test_jax_contract_on_the_port(case):
    _contract(case, _blobs())


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_kmeans(_blobs(), 3)
