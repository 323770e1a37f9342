"""Port parity: the device mesh (``vqvae_tpu_torch/parallel``) and the
codebook kernels sharded over it, against JAX on the virtual CPU mesh.

The ranks are subprocesses joined in a ``gloo`` group on 127.0.0.1 (world
sizes 2 and 4; free ports found as ``tests/test_distributed.py`` finds
them). A rank imports torch and the port only; it writes its results to
an ``.npz``, and this process compares them with the JAX package run on
``get_mesh(world_size)`` of the 8-device virtual CPU mesh, from the same
numpy-seeded inputs:

- ``shard_range`` holds the rows ``data_sharding`` puts on each device of
  a padded axis; ``pad_to_multiple``; ``is_primary`` and the world-size-1
  mesh without a process group, where every helper is the identity;
- exact and fused kNN (the fused route's plain version against Pallas in
  interpret mode, ``VQVAE_TPU_KNN_KERNEL=pallas``) sharded over the query
  axis at N = 300, which ``query_tile * world_size`` does not divide:
  indices identical to JAX's sharded search and to the unsharded port;
- Riemannian lengths: preformed endpoints through ``tanh(z W)`` within
  1e-6 relative of JAX's sharded call, and the port's mlp, edgewise and
  nodal engines on a small VAE equal to their unsharded runs bit for bit;
- the ELL relaxation with K = 16 sharded and K = 5 replicated: distances
  identical to JAX's;
- ``fit_kmedoids(backend="device", init="kpp_parallel")`` on a unit-
  weight grid (ties everywhere): medoids, assignments and QE identical to
  JAX's sharded fit (``reorder`` pinned off on both sides: the port's
  threshold scales with the host's cores); and the per-row min/argmin
  reduction on integer distances whose ties straddle ranks' columns takes
  the lowest global column, as ``np.argmin`` over all K; an edge-list
  graph (whose engine relaxes every column on each rank) fits the same
  under a mesh as without one;
- a data-parallel step that does not say where its rows lie in the global
  batch is refused.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)

# rank code: torch and the port only (no JAX)
_WORKER = r'''
import os, sys
import numpy as np
import torch
from scipy import sparse


def knn_data():
    return np.random.RandomState(0).rand(300, 8).astype(np.float32)


def riem_data():
    rng = np.random.RandomState(2)
    wd = rng.rand(8, 40).astype(np.float32)
    za = rng.randn(300, 8).astype(np.float32)
    zb = rng.randn(300, 8).astype(np.float32)
    return wd, za, zb


def grid_graph(side=20):
    n = side * side
    idx = np.arange(n).reshape(side, side)
    r = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    c = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    W = sparse.csr_matrix((np.ones(len(r), np.float32), (r, c)),
                          shape=(n, n))
    return (W + W.T).tocsr()


def knn_graph():
    from vqvae_tpu_torch.ops.graph import _build_knn_graph_host
    z = np.random.RandomState(4).rand(120, 3).astype(np.float32)
    return _build_knn_graph_host(z, 5, "euclidean", "distance", "union")[0]


def tie_matrix(n=64, k=16):
    return np.random.RandomState(7).randint(0, 4, (n, k)).astype(np.float32)


def main():
    torch.set_num_threads(1)
    from vqvae_tpu_torch.parallel import init_distributed
    mesh = init_distributed(device="cpu")
    out_dir = sys.argv[1]
    res = {"world": np.array(mesh.world_size), "rank": np.array(mesh.rank)}

    from vqvae_tpu_torch.ops.knn import knn_search
    z = knn_data()
    for kernel in ("exact", "fused"):
        d, i = knn_search(z, 7, kernel=kernel, query_tile=32, db_tile=128,
                          bins=128, device="cpu", mesh=mesh)
        d1, i1 = knn_search(z, 7, kernel=kernel, query_tile=32,
                            db_tile=128, bins=128, device="cpu")
        res[f"knn_{kernel}_d"], res[f"knn_{kernel}_i"] = d, i
        res[f"knn_{kernel}_d1"], res[f"knn_{kernel}_i1"] = d1, i1

    from vqvae_tpu_torch.ops import riemannian as riem
    wd, za, zb = riem_data()
    wt = torch.from_numpy(wd)

    def decode(v):
        return torch.tanh(v @ wt)
    decode.device = torch.device("cpu")
    res["riem"] = riem.edge_lengths_riemannian(decode, za, zb,
                                               batch_size=32, device="cpu",
                                               mesh=mesh)
    from vqvae_tpu_torch.models.vae import VAE, flax_init_
    model = VAE(in_channels=1, enc_channels=(8, 16, 32),
                dec_channels=(32, 16, 8), latent_dim=8, recon_loss="mse",
                norm_type="batch", topology="spatial")
    flax_init_(model, torch.Generator().manual_seed(3))
    fn = riem.make_decoder_image_fn(model)
    rng = np.random.RandomState(1)
    zz = rng.randn(200, 8).astype(np.float32)
    rows = rng.randint(0, 200, 450)
    cols = (rows + 1 + rng.randint(0, 199, 450)) % 200
    n_rec = len(riem.RIEM_STATS)
    for engine in ("mlp", "edgewise", "nodal"):
        res[f"riem_{engine}"] = riem.edge_lengths_riemannian_auto(
            fn, zz, rows, cols, batch_size=64, engine=engine, device="cpu",
            mesh=mesh)
        res[f"riem_{engine}1"] = riem.edge_lengths_riemannian_auto(
            fn, zz, rows, cols, batch_size=64, engine=engine, device="cpu")
    res["riem_samples"] = np.array([r["samples"]
                                    for r in riem.RIEM_STATS[n_rec:]])

    from vqvae_tpu_torch.ops.backend import multi_source_distances
    from vqvae_tpu_torch.ops.ell import BucketedGraph
    bg = BucketedGraph.from_csr(knn_graph(), device="cpu")
    for k in (16, 5):
        res[f"ell_{k}"] = multi_source_distances(bg, np.arange(k), "device",
                                                 mesh=mesh)

    from vqvae_tpu_torch.ops.kmedoids import _min_argmin, fit_kmedoids
    from vqvae_tpu_torch.ops.ell import source_columns
    med, asg, qe = fit_kmedoids(grid_graph(), K=33, init="kpp_parallel",
                                seed=11, backend="device", reorder=False,
                                device="cpu", mesh=mesh)
    res.update(med=med, asg=asg, qe=np.array(qe))
    from vqvae_tpu_torch.ops import EdgeList
    el = EdgeList.from_csr(grid_graph(), device="cpu")
    for tag, m in (("el", mesh), ("el1", None)):
        med, asg, qe = fit_kmedoids(el, K=33, init="kpp_parallel", seed=11,
                                    reorder=False, mesh=m)
        res.update({f"{tag}_med": med, f"{tag}_asg": asg,
                    f"{tag}_qe": np.array(qe)})
    full = tie_matrix()
    c0, c1 = source_columns(full.shape[1], mesh)
    best, col = _min_argmin(torch.from_numpy(full[:, c0:c1]), full.shape[1],
                            mesh)
    res["tie_best"], res["tie_col"] = best.numpy(), col.numpy()
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **res)


if __name__ == "__main__":
    main()
'''

_NS = {"__name__": "worker"}
exec(_WORKER, _NS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(src: str, world: int, tmp: Path, *args, timeout: float = 300):
    """Run ``src`` as ``world`` gloo ranks; returns each rank's output.
    A rank that exits nonzero fails the test (the others are killed)."""
    worker = tmp / "worker.py"
    worker.write_text(src)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), *map(str, args)], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > t_end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [p.communicate()[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{out}"
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results at each world size."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        launch(_WORKER, world, tmp, tmp)
        out[world] = [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(world)]
    return out


# -- mesh helpers ---------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [13, 16])
def test_shard_range_matches_data_sharding(world, n):
    from vqvae_tpu.parallel import data_sharding, get_mesh
    from vqvae_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from vqvae_tpu_torch.parallel import Mesh, shard_range

    jmesh = get_mesh(world)
    n_pad = jax_pad(n, world)
    arr = jax.device_put(jnp.arange(n_pad), data_sharding(jmesh, 1))
    held = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for rank, dev in enumerate(jmesh.devices.ravel()):
        mesh = Mesh(object(), rank, world, torch.device("cpu"))
        start, stop = shard_range(n, mesh)
        want = held[dev][held[dev] < n]
        np.testing.assert_array_equal(np.arange(start, stop), want)


def test_pad_to_multiple_and_is_primary_without_a_group():
    from vqvae_tpu.parallel.mesh import is_primary as jax_is_primary
    from vqvae_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from vqvae_tpu_torch import parallel

    for n, m in ((0, 4), (1, 4), (7, 4), (8, 4), (9, 1)):
        assert parallel.pad_to_multiple(n, m) == jax_pad(n, m)
    assert parallel.is_primary() is jax_is_primary() is True
    mesh = parallel.get_mesh()
    assert (mesh.world_size, mesh.rank, mesh.distributed) == (1, 0, False)
    assert parallel.init_distributed() == mesh  # no torchrun environment
    t = torch.arange(6.0).view(3, 2)
    assert parallel.all_reduce_sum(t, mesh) is t
    assert parallel.all_gather_rows(t, 3, mesh) is t
    assert parallel.shard_range(5, mesh) == (0, 5)
    col = t[:, 0]
    v, i = parallel.all_reduce_min_argmin(col, torch.arange(3), mesh)
    assert v is col
    assert parallel.agree_any(True, mesh) and not parallel.agree_any(False,
                                                                     mesh)
    with pytest.raises(ValueError):
        parallel.get_mesh(2)


# -- sharded codebook kernels against JAX's --------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kernel,jax_kernel", [("exact", "xla"),
                                               ("fused", "pallas")])
def test_knn_sharded_matches_jax(ranks, world, kernel, jax_kernel,
                                 monkeypatch):
    from vqvae_tpu.ops.knn import knn_search as jax_knn
    from vqvae_tpu.parallel import get_mesh

    monkeypatch.setenv("VQVAE_TPU_KNN_KERNEL", jax_kernel)
    z = _NS["knn_data"]()
    assert len(z) % (32 * world)  # N does not divide the block alignment
    d_ref, i_ref = jax_knn(z, k=7, query_tile=32, db_tile=128,
                           mesh=get_mesh(world))
    for res in ranks[world]:
        np.testing.assert_array_equal(res[f"knn_{kernel}_i"], i_ref)
        np.testing.assert_allclose(res[f"knn_{kernel}_d"], d_ref,
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(res[f"knn_{kernel}_i"],
                                      res[f"knn_{kernel}_i1"])
        np.testing.assert_array_equal(res[f"knn_{kernel}_d"],
                                      res[f"knn_{kernel}_d1"])


@pytest.mark.parametrize("world", WORLDS)
def test_riemannian_sharded_matches_jax(ranks, world):
    from vqvae_tpu.ops.riemannian import edge_lengths_riemannian
    from vqvae_tpu.parallel import get_mesh

    wd, za, zb = _NS["riem_data"]()
    wj = jnp.asarray(wd)
    ref = edge_lengths_riemannian(lambda v: jnp.tanh(v @ wj), za, zb,
                                  batch_size=32, mesh=get_mesh(world))
    for res in ranks[world]:
        np.testing.assert_allclose(res["riem"], ref, rtol=1e-6, atol=0)
        for engine in ("mlp", "edgewise", "nodal"):
            np.testing.assert_array_equal(res[f"riem_{engine}"],
                                          res[f"riem_{engine}1"])
        # sharded records count every rank's samples: 2 E, 2 E, N D
        assert res["riem_samples"].tolist() == [900, 900, 900, 900,
                                                1600, 1600]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("k", [16, 5])
def test_ell_sharded_matches_jax(ranks, world, k):
    from vqvae_tpu.ops.ell import (BucketedGraph as JaxBucketed,
                                   multi_source_shortest_paths_ell)
    from vqvae_tpu.parallel import get_mesh

    ref = np.asarray(multi_source_shortest_paths_ell(
        JaxBucketed.from_csr(_NS["knn_graph"]()), np.arange(k),
        mesh=get_mesh(world)))
    for res in ranks[world]:
        np.testing.assert_array_equal(res[f"ell_{k}"], ref)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_kmedoids_sharded_matches_jax(ranks, world, monkeypatch):
    from vqvae_tpu.ops.kmedoids import fit_kmedoids
    from vqvae_tpu.parallel import get_mesh

    monkeypatch.setenv("VQVAE_TPU_KMED_REORDER", "0")
    med, asg, qe = fit_kmedoids(_NS["grid_graph"](), K=33,
                                init="kpp_parallel", seed=11,
                                backend="device", mesh=get_mesh(world))
    for res in ranks[world]:
        np.testing.assert_array_equal(res["med"], med)
        np.testing.assert_array_equal(res["asg"], asg)
        assert float(res["qe"]) == pytest.approx(qe, rel=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_kmedoids_edge_list_under_a_mesh(ranks, world):
    """An edge-list graph relaxes every column on each rank (its engine
    does not shard K): under a mesh the fit equals the unsharded one and
    the bucketed graph's sharded fit."""
    for res in ranks[world]:
        np.testing.assert_array_equal(res["el_med"], res["el1_med"])
        np.testing.assert_array_equal(res["el_asg"], res["el1_asg"])
        assert float(res["el_qe"]) == float(res["el1_qe"])
        np.testing.assert_array_equal(res["el_med"], res["med"])
        np.testing.assert_array_equal(res["el_asg"], res["asg"])


@pytest.mark.parametrize("world", WORLDS)
def test_min_argmin_takes_the_lowest_global_column(ranks, world):
    full = _NS["tie_matrix"]()
    # ties that straddle ranks' column blocks
    assert ((full[:, :8] == full.min(1, keepdims=True)).any(1)
            & (full[:, 8:] == full.min(1, keepdims=True)).any(1)).sum() > 10
    for res in ranks[world]:
        np.testing.assert_array_equal(res["tie_best"], full.min(1))
        np.testing.assert_array_equal(res["tie_col"], full.argmin(1))


def test_init_distributed_refuses_nccl_without_a_card(monkeypatch):
    """The backend is never swapped: NCCL asked for on the CPU raises
    before any group is started (gloo is the CPU's default)."""
    import torch.distributed as dist

    from vqvae_tpu_torch.parallel import init_distributed

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="needs CUDA devices"):
        init_distributed("nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown process-group backend"):
        init_distributed("mpi", device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("engine", ["vae", "baseline"])
def test_data_parallel_step_without_rows_is_refused(engine):
    """A rank's step must say where its rows lie in the global batch: the
    VAE's noise and the baseline's bank are drawn over the whole batch.
    Without them a step under a mesh of two ranks raises before any
    collective (it would draw the noise or the bank from its own rows)."""
    from vqvae_tpu_torch.parallel import Mesh

    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    if engine == "vae":
        from vqvae_tpu_torch.models.vae import VAE
        from vqvae_tpu_torch.train import VAEEngine

        eng = VAEEngine(VAE(in_channels=1, enc_channels=(4, 8, 8),
                            dec_channels=(8, 8, 4), latent_dim=2,
                            norm_type="none", topology="spatial"),
                        lr=1e-3, device="cpu", mesh=mesh)
        x = torch.rand(2, 28, 28, 1)
        with pytest.raises(ValueError, match="noise_rows"):
            eng.train_step(x, torch.ones(2), 1.0, gen)
        with pytest.raises(ValueError, match="noise_rows"):
            eng.eval_step(x, torch.ones(2), 1.0, gen)
    else:
        from vqvae_tpu_torch.models.vqvae_baseline import VQVAE
        from vqvae_tpu_torch.train import VQVAEEngine

        eng = VQVAEEngine(VQVAE(in_channels=3, hidden=8, n_res_blocks=1,
                                z_channels=4), n_codes=8, device="cpu",
                          mesh=mesh)
        cb, bank = eng.init_state()
        with pytest.raises(ValueError, match="rows="):
            eng.train_step(cb, bank, torch.rand(2, 32, 32, 3) * 2 - 1,
                           torch.ones(2), gen)
