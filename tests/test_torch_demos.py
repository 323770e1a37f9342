"""Port parity: the demos, the geodesic experiments and the crossover tool.

- ``demos.codebook_comparison``'s JSON against the JAX demo's, both run in
  process on the same small experiment: the geodesic side exact (the same
  kNN graph, medoids and QE; rtol 1e-9 on the float64 sums), the
  Euclidean side within ``tests/test_torch_kmeans.py``'s tolerances
  (inertia and recon MSE rtol 1e-5, identical labels, so the same
  perplexity);
- the port's counterpart of ``tests/test_geodesic_advantage.py``: the
  geodesic codebook's QE equal to JAX's, and the geodesic codebook at
  least 10x better on geodesic QE than the Euclidean one;
- ``experiments_geo.riemann_sanity_check``'s lengths from JAX's decoder
  weights carried across within rtol 1e-4 of JAX's
  (``tests/test_torch_riemannian.py``'s tolerance), except at edges with
  a ReLU input within 1e-6 of 0 at an endpoint (in f64), where the two
  frameworks' roundings may gate it differently, and on at most 2 % of
  the edges (1 of the 200 here);
- ``demos.kmedoids_geodesic_analysis``'s rows against the JAX demo's on a
  port-trained experiment (QE, purity, NMI, ARI, perplexity);
- every other demo's ``main`` on the CPU, writing its artifacts, and
  ``tools.bench_fit`` at a tiny size.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.cli.pipeline import STAGES, run_pipeline
from vqvae_tpu_torch.demos import (codebook_comparison, codebook_sampling,
                                   interactive_exploration,
                                   kmedoids_geodesic_analysis)
from vqvae_tpu_torch.experiments_geo import (riemann_sanity_check,
                                             run_riemann_experiments)
from vqvae_tpu_torch.tools import bench_fit
from vqvae_tpu_torch.utils.images import load_image

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "configs" / "sandbox-fashion" / "geodesic"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(rel: str):
    """A JAX demo or experiment script, loaded as a module."""
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(
        "jax_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_threshold(monkeypatch):
    """The port's k-medoids takes JAX's ``HOST_WORK_THRESHOLD``: the BFS
    reorder (which changes the nodes k-means|| samples) follows it, and
    the two packages calibrate it for different hosts."""
    from vqvae_tpu.ops import kmedoids as jax_kmedoids
    from vqvae_tpu_torch.ops import kmedoids

    monkeypatch.setattr(kmedoids, "HOST_WORK_THRESHOLD",
                        jax_kmedoids.HOST_WORK_THRESHOLD)


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    mod.main()


@pytest.fixture(scope="module")
def latents_exp(tmp_path_factory):
    """An experiment holding only spatial training latents (150 images of
    4 x 4 cells of 8 dims, clustered) and their labels."""
    exp = tmp_path_factory.mktemp("latents_exp")
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1.5, size=(6, 8)).astype(np.float32)
    y = rng.integers(0, 6, size=150)
    z = centers[y][:, None, None, :] + rng.normal(
        0, 0.7, size=(150, 4, 4, 8)).astype(np.float32)
    (exp / "vae" / "latents_train").mkdir(parents=True)
    np.savez(exp / "vae" / "latents_train" / "latents.npz",
             z=z.astype(np.float32), y=y.astype(np.int64))
    return exp


@pytest.fixture(scope="module")
def pipeline_exp(tmp_path_factory):
    """The sandbox preset's VAE (1 epoch, 256 synthetic images) and
    codebook, trained by the port on the CPU."""
    root = tmp_path_factory.mktemp("pipeline")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQVAE_TPU_SYNTH_SIZE", "256")
        mp.delenv("VQVAE_TPU_TIMINGS_PATH", raising=False)
        mp.delenv("VQVAE_TPU_PROFILE_DIR", raising=False)
        run_pipeline(PRESET, skip=set(STAGES) - {"vae", "codebook"},
                     overrides={"vae": {"max_epochs": 1,
                                        "data": {"synthetic_size": 256}}},
                     root_dir=root, device="cpu")
    return root / "experiments" / "sandbox-fashion" / "geodesic"


def test_codebook_comparison_matches_jax(latents_exp, monkeypatch,
                                        jax_threshold):
    jax_demo = _jax_script("demos/codebook_comparison.py")
    _run_jax_main(jax_demo, [str(latents_exp), "--K", "16"], monkeypatch)
    ref = json.loads(
        (latents_exp / "demo_codebook_comparison.json").read_text())
    got = codebook_comparison.run(latents_exp, K=16, device="cpu")
    assert got == json.loads(
        (latents_exp / "demo_codebook_comparison.json").read_text())
    for key in ("K", "k_graph", "n_points"):
        assert got[key] == ref[key]
    g, r = got["geodesic"], ref["geodesic"]
    assert g["lcc_nodes"] == r["lcc_nodes"]
    np.testing.assert_allclose(g["qe"], r["qe"], rtol=1e-9)
    np.testing.assert_allclose(g["recon_mse"], r["recon_mse"], rtol=1e-6)
    np.testing.assert_allclose(g["perplexity"], r["perplexity"], rtol=1e-12)
    e, r = got["euclidean"], ref["euclidean"]
    np.testing.assert_allclose(e["inertia"], r["inertia"], rtol=1e-5)
    np.testing.assert_allclose(e["recon_mse"], r["recon_mse"], rtol=1e-5)
    np.testing.assert_allclose(e["perplexity"], r["perplexity"], rtol=1e-12)


def _spiral_latents(n=4096, dim=8, seed=0):
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


def _geodesic_qe(W, code_nodes, assign=None):
    from vqvae_tpu_torch.ops.backend import multi_source_distances

    D = multi_source_distances(W, np.asarray(code_nodes), device="cpu")
    d = D.min(axis=1) if assign is None else D[np.arange(D.shape[0]), assign]
    finite = np.isfinite(d)
    dmax = d[finite].max() if finite.any() else 1.0
    d = np.where(finite, d, 2.0 * dmax)
    return float(np.sum(d.astype(np.float64) ** 2))


def test_geodesic_codebook_beats_euclidean_as_jax(jax_threshold):
    from vqvae_tpu.ops import build_knn_graph as jax_build_knn_graph
    from vqvae_tpu.ops import fit_kmedoids as jax_fit_kmedoids
    from vqvae_tpu_torch.ops import build_knn_graph, fit_kmeans, fit_kmedoids

    z = _spiral_latents()
    K = 32
    W, _ = build_knn_graph(z, k=8, metric="euclidean", mode="distance",
                           sym="union", device="cpu")
    medoids, _, qe_geo = fit_kmedoids(W, K=K, init="kpp_parallel", seed=42,
                                      assume_symmetric=True, device="cpu")
    W_j, _ = jax_build_knn_graph(z, k=8, metric="euclidean",
                                 mode="distance", sym="union")
    ref_medoids, _, ref_qe = jax_fit_kmedoids(W_j, K=K, init="kpp_parallel",
                                              seed=42, assume_symmetric=True)
    np.testing.assert_array_equal(medoids, ref_medoids)
    np.testing.assert_allclose(qe_geo, ref_qe, rtol=1e-9)

    centroids, e_assign, _ = fit_kmeans(z, K, seed=42, device="cpu")
    d2 = ((z[:, None, :] - centroids[None]) ** 2).sum(-1)
    code_nodes = d2.argmin(axis=0)
    qe_geo_of_euclid = _geodesic_qe(W, code_nodes, assign=e_assign)
    qe_geo_direct = _geodesic_qe(W, medoids)
    assert qe_geo_direct <= 0.1 * qe_geo_of_euclid, (
        qe_geo_direct, qe_geo_of_euclid)
    np.testing.assert_allclose(qe_geo, qe_geo_direct, rtol=1e-3)


def test_riemann_sanity_check_matches_jax():
    import jax

    from vqvae_tpu.models import VAE as JaxVAE
    from vqvae_tpu.ops import edge_lengths_riemannian as jax_lengths
    from vqvae_tpu.ops.riemannian import make_decoder_image_fn
    from vqvae_tpu_torch.utils.checkpoint import (build_vae,
                                                  load_vae_state_dict,
                                                  vae_state_dict_from_jax)

    cfg = dict(in_channels=1, latent_dim=16, topology="flat",
               output_image_size=28, norm_type="none", recon_loss="mse",
               enc_channels=(32, 64, 128), dec_channels=(128, 64, 32))
    model = JaxVAE(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(model.init(
        {"params": jax.random.key(0)}, np.zeros((1, 28, 28, 1), np.float32))))
    port = load_vae_state_dict(build_vae(cfg), vae_state_dict_from_jax(
        variables, "flat", cfg["enc_channels"], cfg["dec_channels"], "none"))
    got = riemann_sanity_check.run(n_edges=200, seed=0, device="cpu",
                                   model=port)
    rng = np.random.default_rng(0)
    za = rng.normal(size=(200, 16)).astype(np.float32)
    zb = za + rng.normal(scale=0.1, size=za.shape).astype(np.float32)
    ref = jax_lengths(make_decoder_image_fn(model, variables, "flat"), za,
                      zb, batch_size=512)
    np.testing.assert_allclose(got["euclidean"],
                               np.linalg.norm(zb - za, axis=1), rtol=1e-6)
    bad = np.nonzero(~np.isclose(got["riemannian"], ref, rtol=1e-4,
                                 atol=0.0))[0]
    assert len(bad) <= 0.02 * len(ref), bad
    assert all(_relu_input_gap(port, [za[e], zb[e]]) < 1e-6 for e in bad)
    assert got["ok"]


def _relu_input_gap(model, points) -> float:
    """The smallest |input| of the decoder's ReLUs at ``points``, in f64."""
    import copy

    m64 = copy.deepcopy(model).double()
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, inp, out: seen.append(float(inp[0].abs().min())))
        for mod in m64.decoder.modules() if isinstance(mod, torch.nn.ReLU)]
    with torch.no_grad():
        for p in points:
            m64.decode(torch.from_numpy(np.asarray(p)[None]).double())
    for h in hooks:
        h.remove()
    return min(seen)


def test_riemann_sanity_check_main(capsys):
    out = riemann_sanity_check.main(["--n_edges", "200", "--device", "cpu"])
    assert out["ok"] and "sanity: OK" in capsys.readouterr().out


def test_kmedoids_analysis_matches_jax(pipeline_exp, monkeypatch,
                                       jax_threshold):
    jax_demo = _jax_script("demos/kmedoids_geodesic_analysis.py")
    _run_jax_main(jax_demo, [str(pipeline_exp), "--Ks", "4", "8"],
                  monkeypatch)
    out = pipeline_exp / "demo_kmedoids_analysis.json"
    ref = json.loads(out.read_text())
    out.unlink()
    (pipeline_exp / "demo_kmedoids_analysis.png").unlink()
    rows = kmedoids_geodesic_analysis.main(
        [str(pipeline_exp), "--Ks", "4", "8", "--device", "cpu"])
    assert json.loads(out.read_text()) == rows
    assert (pipeline_exp / "demo_kmedoids_analysis.png").stat().st_size > 0
    assert [r["K"] for r in rows] == [r["K"] for r in ref] == [4, 8]
    for got, want in zip(rows, ref):
        for key in ("qe", "purity", "nmi", "ari", "perplexity"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       atol=1e-12)


def test_codebook_comparison_main_writes_its_artifacts(pipeline_exp):
    res = codebook_comparison.main([str(pipeline_exp), "--K", "8",
                                    "--max_points", "1024", "--device",
                                    "cpu"])
    assert res["n_points"] == 1024
    for name in ("demo_codebook_comparison.json",
                 "demo_codebook_comparison.png"):
        assert (pipeline_exp / name).stat().st_size > 0
    assert np.isfinite(res["euclidean"]["recon_mse"])
    assert np.isfinite(res["geodesic"]["recon_mse"])


def test_codebook_sampling_main_writes_its_grid(pipeline_exp):
    res = codebook_sampling.main([str(pipeline_exp), "--n", "6",
                                  "--device", "cpu"])
    grid = load_image(pipeline_exp / "demo_cont_vs_quant.png")
    assert grid.shape[:2] == (2 * 30 + 2, 6 * 30 + 2)
    assert res["spatial"] and np.isfinite(res["pixel_mse"])
    assert res["codes"].shape == (6 * 16,)


def test_interactive_exploration_main(tmp_path):
    out = tmp_path / "knn.png"
    res = interactive_exploration.main(["--n", "300", "--out", str(out),
                                        "--device", "cpu"])
    assert out.stat().st_size > 0
    D = res["distances"]
    assert D.shape == (300, 3)
    assert (D[res["probes"], [0, 1, 2]] == 0).all()


def test_run_riemann_experiments_main(pipeline_exp):
    res = run_riemann_experiments.main(
        [str(pipeline_exp), "--max_edges", "300", "--max_points", "1024",
         "--device", "cpu"])
    saved = json.loads((pipeline_exp / "riemann_graph_effect.json")
                       .read_text())
    assert saved == res and res["n_points"] == 1024
    for key in ("mean_sp_euclidean", "mean_sp_riemannian",
                "path_dilation_ratio", "path_dilation_ratio_raw"):
        assert np.isfinite(res[key]) and res[key] > 0


def test_bench_fit_crossover_interpolates():
    grid = [{"sources": 8, "host_s": 0.1, "device_s": 0.3},
            {"sources": 32, "host_s": 0.5, "device_s": 0.3},
            {"sources": 128, "host_s": 2.0, "device_s": 0.4}]
    assert bench_fit.crossover(grid) == pytest.approx(8 + 24 * 0.5)
    assert bench_fit.crossover(grid[1:]) is None


def test_bench_fit_main_on_the_cpu(capsys):
    out = bench_fit.main(["--nodes", "1024", "--sources", "2,8",
                          "--threads", "1", "--codes", "8", "--runs", "1",
                          "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    rec = out["results"][0]
    assert rec["nodes"] == 1024 and [g["sources"] for g in rec["grid"]] == [
        2, 8]
    assert rec["fit"]["host"]["qe"] == rec["fit"]["device"]["qe"]
    assert rec["thread_scaling"][0]["threads"] == 1
