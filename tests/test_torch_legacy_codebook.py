"""Port parity: the legacy flat-latent codebook builders
(``cli/build_codebook_legacy.py``) and the endpoint-form
``edge_lengths_riemannian``.

A narrow JAX-initialized flat VAE (decoder batch statistics drawn away
from 0 / 1, so eval-mode normalisation does real work) is exported to
the reference ``.pt`` format; 240 flat latents in six lobes plus a far
group of 12 (a second component, so codes carry -1) go through both
packages from one YAML.

- ``edge_lengths_riemannian``: within rtol 1e-4 of JAX's (the JVP
  tolerance of ``tests/test_torch_riemannian.py``: the frameworks' float
  orders differ), with a ragged last chunk (JAX pads it with zeros);
- ``_reweight_graph_with_riemannian``, ``subset`` and ``full``: the
  identical edge list is measured (the decile sample is numpy
  ``default_rng(seed)`` on both sides), the same graph structure, weights
  within rtol 1e-4;
- ``build_codebook_legacy_main(riemannian=False)``: the identical
  ``knn_graph.npz`` structure (weights within rtol 1e-6, the kNN distance
  tolerance of ``tests/test_torch_graph.py``), identical medoids and
  codes, QE within rtol 1e-6 of JAX's k-medoids on JAX's graph;
  ``riemannian=True``: the same structure of both graph files;
- k-medoids on JAX's re-weighted graph: identical medoids, codes and QE.
"""
import json

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy import sparse

from vqvae_tpu.cli import build_codebook_legacy as jax_legacy
from vqvae_tpu.config import load_config as jax_load_config
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.ops.graph import build_knn_graph as jax_knn_graph
from vqvae_tpu.ops.kmedoids import fit_kmedoids as jax_fit_kmedoids
from vqvae_tpu.ops.riemannian import (
    edge_lengths_riemannian as jax_edge_lengths,
    make_decoder_image_fn as jax_decoder_image_fn)
from vqvae_tpu.utils.latents import save_latents
from vqvae_tpu.utils.torch_compat import export_reference_vae_checkpoint
from vqvae_tpu_torch.cli import build_codebook_legacy as legacy
from vqvae_tpu_torch.cli.build_codebook import load_codebook
from vqvae_tpu_torch.config import Config, load_config
from vqvae_tpu_torch.ops import edge_lengths_riemannian, fit_kmedoids
from vqvae_tpu_torch.ops.riemannian import make_decoder_image_fn
from vqvae_tpu_torch.utils.checkpoint import load_vae_from_checkpoint

ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 8
ARCH = {"in_channels": 1, "output_image_size": 28, "latent_dim": LATENT,
        "enc_channels": list(ENC), "dec_channels": list(DEC),
        "recon_loss": "mse", "norm_type": "batch", "mse_use_sigmoid": True,
        "topology": "flat"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(work dir, JAX decode fn, port decode fn, latents, config path)."""
    tmp = tmp_path_factory.mktemp("legacy")
    model = JaxVAE(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in ARCH.items()})
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(model.init(
        {"params": jax.random.key(2)}, np.zeros((1, 28, 28, 1),
                                                np.float32))))
    rng = np.random.RandomState(0)
    for st in variables["batch_stats"]["decoder"].values():
        st["mean"] = rng.uniform(-0.3, 0.3, st["mean"].shape).astype(
            np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    ckpt = export_reference_vae_checkpoint(
        variables, tmp / "vae" / "checkpoints" / "best.pt", "flat", ENC, DEC,
        "batch")
    port_model = load_vae_from_checkpoint(ckpt, ARCH, device="cpu")

    g = np.random.default_rng(0)
    centers = g.normal(0, 1.5, size=(6, LATENT)).astype(np.float32)
    z = centers[g.integers(0, 6, size=240)] + g.normal(
        0, 0.6, size=(240, LATENT)).astype(np.float32)
    far = 30.0 + g.normal(0, 0.1, size=(12, LATENT))
    z = np.concatenate([z, far]).astype(np.float32)
    save_latents(tmp / "latents", z, z, np.zeros_like(z),
                 np.zeros(len(z), np.int64))
    cfg = {"builder": "legacy",
           "latents_path": str(tmp / "latents"), "latents_key": "mu",
           "vae_ckpt_path": str(ckpt),
           "vae": ARCH,
           "graph": {"k": 6, "metric": "euclidean", "sym": "union",
                     "mode": "distance"},
           "quantize": {"K": 12, "init": "kpp_parallel", "seed": 42},
           "seed": 42,
           "riemannian": {"mode": "subset", "max_edges": 300,
                          "batch_size": 128}}
    path = tmp / "codebook.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return (tmp, jax_decoder_image_fn(model, variables, "flat"),
            make_decoder_image_fn(port_model), z, path)


def test_edge_lengths_match_jax(inputs):
    _, jax_fn, port_fn, z, _ = inputs
    rng = np.random.RandomState(1)
    a, b = rng.randint(0, 240, 333), rng.randint(0, 240, 333)
    ref = jax_edge_lengths(jax_fn, z[a], z[b], batch_size=128)
    out = edge_lengths_riemannian(port_fn, z[a], z[b], batch_size=128,
                                  device="cpu")
    assert out.shape == ref.shape == (333,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    assert edge_lengths_riemannian(port_fn, z[:0], z[:0]).shape == (0,)
    with pytest.raises(ValueError, match="same shape"):
        edge_lengths_riemannian(port_fn, z[:3], z[:4], device="cpu")


@pytest.mark.parametrize("mode", ["subset", "full"])
def test_reweighting_measures_the_identical_edges(inputs, mode,
                                                  monkeypatch):
    _, jax_fn, port_fn, z, _ = inputs
    W, _ = jax_knn_graph(z, k=6, mode="distance", sym="union")
    measured = {}

    def recording(name, fn):
        def wrapper(decode_fn, za, zb, batch_size=512, **kw):
            measured[name] = (np.array(za), np.array(zb))
            return fn(decode_fn, za, zb, batch_size=batch_size, **kw)
        return wrapper

    monkeypatch.setattr(jax_legacy, "edge_lengths_riemannian",
                        recording("jax", jax_edge_lengths))
    monkeypatch.setattr(legacy, "edge_lengths_riemannian",
                        recording("port", edge_lengths_riemannian))
    ref = jax_legacy._reweight_graph_with_riemannian(
        W, z, jax_fn, mode=mode, max_edges=300, batch_size=128, seed=42)
    out = legacy._reweight_graph_with_riemannian(
        W, z, port_fn, mode=mode, max_edges=300, batch_size=128, seed=42,
        device="cpu")
    n_edges = sparse.triu(W, k=1).nnz
    want = 300 if mode == "subset" else n_edges
    assert n_edges > 300
    assert len(measured["port"][0]) == len(measured["jax"][0])
    assert abs(len(measured["port"][0]) - want) <= 10  # deciles of 30
    for got, ref_ends in zip(measured["port"], measured["jax"]):
        np.testing.assert_array_equal(got, ref_ends)
    np.testing.assert_array_equal(out.indptr, ref.indptr)
    np.testing.assert_array_equal(out.indices, ref.indices)
    np.testing.assert_allclose(out.data, ref.data, rtol=1e-4)
    assert (out != out.T).nnz == 0


def _run_both(inputs, riemannian, tmp_name):
    tmp, _, _, _, path = inputs
    jax_out = jax_legacy.build_codebook_legacy_main(
        jax_load_config(path, {"out_dir": str(tmp / tmp_name / "jax")}),
        riemannian=riemannian)
    out = legacy.build_codebook_legacy_main(
        load_config(path, {"out_dir": str(tmp / tmp_name / "port")}),
        riemannian=riemannian, device="cpu")
    return jax_out, out


def _same_structure(a, b, rtol):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=rtol)


def test_euclidean_builder_matches_jax(inputs):
    jax_out, out = _run_both(inputs, False, "euclidean")
    ref_w = sparse.load_npz(jax_out / "knn_graph.npz")
    _same_structure(sparse.load_npz(out / "knn_graph.npz"), ref_w, 1e-6)
    assert not (out / "knn_graph_riemannian.npz").exists()

    ref_codes, codes = np.load(jax_out / "codes.npy"), np.load(
        out / "codes.npy")
    assert codes.shape == ref_codes.shape == (252,)
    assert codes.dtype == ref_codes.dtype == np.int32
    lcc = int((ref_codes >= 0).sum())
    assert (codes[240:] == -1).all() and 120 < lcc <= 240
    np.testing.assert_array_equal(codes, ref_codes)

    ref_cb, cb = load_codebook(jax_out), load_codebook(out)
    np.testing.assert_array_equal(cb["medoid_indices"],
                                  ref_cb["medoid_indices"])
    np.testing.assert_array_equal(cb["z_medoid"], ref_cb["z_medoid"])
    # the JAX record's keys, each with its value (but the wall time)
    for key, val in ref_cb["config"].items():
        assert key in cb["config"], key
        if key != "total_s":
            assert cb["config"][key] == val, key
    mask = ref_codes >= 0
    _, _, ref_qe = jax_fit_kmedoids(ref_w[mask][:, mask], K=12,
                                    init="kpp_parallel", seed=42)
    np.testing.assert_allclose(cb["config"]["quantization_error"], ref_qe,
                               rtol=1e-6)
    assert cb["config"]["lcc_nodes"] == lcc


def test_riemannian_builder_matches_jax_structure(inputs):
    jax_out, out = _run_both(inputs, True, "riemannian")
    for name in ("knn_graph.npz", "knn_graph_riemannian.npz"):
        _same_structure(sparse.load_npz(out / name),
                        sparse.load_npz(jax_out / name), 1e-4)
    ref_w = sparse.load_npz(jax_out / "knn_graph_riemannian.npz")
    codes = np.load(out / "codes.npy")
    lcc = int((codes >= 0).sum())
    assert ref_w.shape == (lcc, lcc)
    assert codes.shape == (252,) and (codes[240:] == -1).all()
    assert len(load_codebook(out)["medoid_indices"]) == 12
    rec = json.loads(bytes(np.load(out / "codebook.npz")["config_json"]))
    assert rec["riemannian"] is True and rec["device"] == "cpu"


def test_kmedoids_on_jax_reweighted_graph_is_identical(inputs):
    jax_out = inputs[0] / "riemannian" / "jax"
    if not (jax_out / "knn_graph_riemannian.npz").exists():
        _run_both(inputs, True, "riemannian")
    W = sparse.load_npz(jax_out / "knn_graph_riemannian.npz")
    ref = jax_fit_kmedoids(W, K=12, init="kpp_parallel", seed=42)
    got = fit_kmedoids(W, K=12, init="kpp_parallel", seed=42, device="cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]
    codes = np.load(jax_out / "codes.npy")
    np.testing.assert_array_equal(codes[codes >= 0], ref[1])


def test_flat_latents_loader(inputs, tmp_path):
    tmp, _, _, z, _ = inputs
    got = legacy._load_flat_latents(Config({
        "data": {"latents_path": str(tmp / "latents")}, "source": "mu"}))
    np.testing.assert_array_equal(got, z)
    with pytest.raises(KeyError, match="latents_path"):
        legacy._load_flat_latents(Config({}))
    save_latents(tmp_path, z.reshape(-1, 1, 1, LATENT)[:4],
                 z.reshape(-1, 1, 1, LATENT)[:4], z[:4], np.zeros(4))
    with pytest.raises(ValueError, match="flat"):
        legacy._load_flat_latents(Config({"latents_path": str(tmp_path)}))
    with pytest.raises(KeyError, match="out_dir"):
        legacy.build_codebook_legacy_main(Config({}), device="cpu")
