"""The codebook stage's device engines and the VAE's epoch path on the card
against the CPU.

Every test needs a CUDA device (the ``cuda`` marker) and skips without
one. The file imports no JAX, so it runs on a GPU host without it:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_engines_cuda.py``.

- edge-list Bellman-Ford, the ELL engine with and without ``active``, and
  the device connected components on a kNN graph of 2,000 points: the
  card's distances, sweeps and labels equal the CPU's (exact fixed
  points);
- k-medoids on an ``EdgeList`` on the card equals the CSR run on the CPU;
- one epoch of the VAE's epoch path (a narrow spatial model, a NaN pixel
  in one batch) on the card against the CPU, the same permutation and
  noise: finite parameters, the epoch's metrics within rtol 1e-5 except
  the NaN loss, parameters within rtol 1e-4 or 2 lr a step.
"""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models import VAE, flax_init_
from vqvae_tpu_torch.ops import (EdgeList, build_knn_graph,
                                 connected_components_device, fit_kmedoids,
                                 multi_source_shortest_paths)
from vqvae_tpu_torch.ops.ell import (ELL_STATS, BucketedGraph,
                                     multi_source_shortest_paths_ell)
from vqvae_tpu_torch.train import VAEEngine
from vqvae_tpu_torch.train.vae_engine import seeded_generator


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (card vs CPU)")
    return resolve_device("cuda")  # full f32


def _graph(k=6, sym="union"):
    z = np.random.default_rng(0).normal(size=(2000, 8)).astype(np.float32)
    W, _ = build_knn_graph(z, k=k, sym=sym, device="cpu")
    return W.astype(np.float32)


@pytest.mark.cuda
def test_shortest_path_engines_on_card_match_cpu(cuda_device):
    W = _graph()
    src = np.asarray([0, 17, 555, 1999])
    out = {}
    for dev in ("cpu", "cuda"):
        el = EdgeList.from_csr(W, pad_multiple=1024, device=dev)
        d_bf, it_bf = multi_source_shortest_paths(el, src, chunk=4096,
                                                  return_iters=True)
        g = BucketedGraph.from_csr(W, device=dev, min_rows=1)
        d_ell, it_ell = multi_source_shortest_paths_ell(g, src,
                                                        return_iters=True)
        d_act, it_act = multi_source_shortest_paths_ell(
            g, src, active=True, return_iters=True)
        out[dev] = (d_bf.cpu().numpy(), it_bf, d_ell.cpu().numpy(), it_ell,
                    d_act.cpu().numpy(), it_act,
                    ELL_STATS[-1]["chunk_relaxed"])
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["cuda"][0], out["cuda"][2])


@pytest.mark.cuda
def test_components_and_kmedoids_on_card_match_cpu(cuda_device):
    W = _graph(k=3, sym="mutual")
    labels = connected_components_device(W, device="cuda")
    np.testing.assert_array_equal(
        labels, connected_components_device(W, device="cpu"))
    assert len(np.unique(labels)) > 1
    W = _graph()
    got = fit_kmedoids(EdgeList.from_csr(W, device="cuda"), K=16,
                       init="kpp_parallel", seed=3)
    ref = fit_kmedoids(W, K=16, init="kpp_parallel", seed=3,
                       backend="device", reorder=False, device="cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


@pytest.mark.cuda
def test_vae_epoch_path_on_card_matches_cpu(cuda_device):
    arch = dict(in_channels=1, enc_channels=(16, 32, 64),
                dec_channels=(64, 32, 16), latent_dim=8, recon_loss="mse",
                output_image_size=28, norm_type="batch", topology="spatial")
    model = flax_init_(VAE(**arch), seeded_generator("cpu", 0))
    x = np.random.default_rng(0).random((40, 28, 28, 1), dtype=np.float32)
    x[7, 3, 3, 0] = np.nan
    perm = torch.randperm(48, generator=torch.Generator().manual_seed(1))
    lr, bs = 1e-3, 16
    res = {}
    for dev in ("cpu", "cuda"):
        eng = VAEEngine(copy.deepcopy(model), lr=lr, grad_clip_max_norm=1.0,
                        cosine_t_max=3, steps_per_epoch=3, seed=0,
                        device=dev)
        loader = SimpleNamespace(split=SimpleNamespace(images=x))
        data, mask, steps, _ = eng.device_dataset(loader, bs)
        tr = eng.train_epoch(data, mask, perm.to(dev), 1.0, steps, bs,
                             seeded_generator("cpu", 0, 1))
        res[dev] = (tr.cpu().numpy(), {k: p.detach().cpu() for k, p in
                                       eng.model.named_parameters()})
    (tr_c, par_c), (tr_g, par_g) = res["cpu"], res["cuda"]
    assert not np.isfinite(tr_c[0]) and not np.isfinite(tr_g[0])
    np.testing.assert_allclose(tr_g[1:], tr_c[1:], rtol=1e-5)
    n_close = n_par = 0
    for key, p_c in par_c.items():
        assert torch.isfinite(par_g[key]).all(), key
        dp = (par_g[key] - p_c).abs()
        assert (dp <= 2 * 3 * lr + 1e-7).all(), key
        n_close += int((dp <= 1e-4 * p_c.abs() + 1e-7).sum())
        n_par += p_c.numel()
    assert n_close >= 0.99 * n_par
