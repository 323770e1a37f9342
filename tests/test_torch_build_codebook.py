"""Port parity for the whole slice: the codebook stage CLI.

About 128 images of (4, 4, 8) latents — one image's cells far from the
rest, so the graph has a small second component and -1 codes — and a
narrow JAX-initialized VAE exported to the reference ``.pt`` format go
through both packages' ``build_codebook_main`` from one YAML (the JAX kNN
forced to its Pallas kernel, run in interpret mode). Codes, the off-LCC
-1 positions and the medoids must be identical; QE agrees within rtol 1e-4
(the Riemannian edge lengths differ in float order).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from vqvae_tpu.cli.build_codebook import (
    build_codebook_main as jax_build_codebook_main)
from vqvae_tpu.config import load_config as jax_load_config
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.utils.latents import save_latents
from vqvae_tpu.utils.torch_compat import export_reference_vae_checkpoint
from vqvae_tpu_torch.cli.build_codebook import (build_codebook_main,
                                                load_codebook)
from vqvae_tpu_torch.config import load_config

REPO = Path(__file__).resolve().parents[1]
ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 8


def _write_inputs(tmp_path: Path) -> Path:
    model = JaxVAE(in_channels=1, enc_channels=ENC, dec_channels=DEC,
                   latent_dim=LATENT, recon_loss="mse",
                   output_image_size=28, norm_type="batch",
                   topology="spatial")
    variables = jax.device_get(model.init(
        {"params": jax.random.key(0)}, np.zeros((1, 28, 28, 1), np.float32)))
    ckpt = export_reference_vae_checkpoint(
        variables, tmp_path / "vae" / "best.pt", "spatial", ENC, DEC, "batch")
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1.2, size=(6, LATENT)).astype(np.float32)
    z = centers[rng.integers(0, 6, size=(128, 4, 4))]
    z = z + rng.normal(0, 0.6, size=z.shape).astype(np.float32)
    z[-1] = 40.0 + rng.normal(0, 0.1, size=(4, 4, LATENT))  # far-off image
    z = z.astype(np.float32)
    save_latents(tmp_path / "latents", z, z, np.zeros_like(z),
                 np.zeros(128, np.int64))
    cfg = {
        "latents_path": str(tmp_path / "latents"),
        "vae_ckpt_path": str(ckpt),
        "out_dir": str(tmp_path / "out"),
        "vae": {"in_channels": 1, "output_image_size": 28,
                "latent_dim": LATENT, "enc_channels": list(ENC),
                "dec_channels": list(DEC), "recon_loss": "mse",
                "norm_type": "batch", "mse_use_sigmoid": True,
                "topology": "spatial"},
        "graph": {"k": 10, "sym": "union"},
        "quantize": {"K": 16, "init": "kpp_parallel", "seed": 42},
        "system": {"batch_size": 512},
    }
    path = tmp_path / "codebook.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_codebook_stage_matches_jax(tmp_path, monkeypatch):
    cfg_path = _write_inputs(tmp_path)
    monkeypatch.setenv("VQVAE_TPU_KNN_KERNEL", "pallas")
    jax_out = jax_build_codebook_main(jax_load_config(
        cfg_path, {"out_dir": str(tmp_path / "jax")}))
    out = build_codebook_main(
        load_config(cfg_path, {"out_dir": str(tmp_path / "port")}),
        device="cpu")

    ref_codes = np.load(jax_out / "codes.npy")
    codes = np.load(out / "codes.npy")
    assert codes.shape == ref_codes.shape == (128, 4, 4)
    assert codes.dtype == ref_codes.dtype
    np.testing.assert_array_equal(codes == -1, ref_codes == -1)
    assert (codes[-1] == -1).all() and (codes[:-1] >= 0).all()
    np.testing.assert_array_equal(codes, ref_codes)

    ref_cb, cb = load_codebook(jax_out), load_codebook(out)
    np.testing.assert_array_equal(cb["medoid_indices"],
                                  ref_cb["medoid_indices"])
    np.testing.assert_array_equal(cb["z_medoid"], ref_cb["z_medoid"])
    assert cb["config"]["lcc_nodes"] == int((ref_codes >= 0).sum())

    from scipy import sparse

    ref_w = sparse.load_npz(jax_out / "knn_graph_geodesic.npz")
    w = sparse.load_npz(out / "knn_graph_geodesic.npz")
    np.testing.assert_array_equal(w.indptr, ref_w.indptr)
    np.testing.assert_array_equal(w.indices, ref_w.indices)
    np.testing.assert_allclose(w.data, ref_w.data, rtol=1e-4)

    # QE: the JAX stage does not store it; recompute both from the graphs
    from vqvae_tpu.ops.kmedoids import fit_kmedoids as jax_fit

    _, _, ref_qe = jax_fit(ref_w, K=16, init="kpp_parallel", seed=42)
    np.testing.assert_allclose(cb["config"]["quantization_error"], ref_qe,
                               rtol=1e-4)
    # the torch-format mirror reads back the same codebook
    pt = load_codebook(out / "codebook.pt")
    np.testing.assert_array_equal(pt["medoid_indices"], cb["medoid_indices"])


def test_module_entry_point_runs_the_preset_layout(tmp_path):
    cfg_path = _write_inputs(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.build_codebook",
         "--config", str(cfg_path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = Path(yaml.safe_load(cfg_path.read_text())["out_dir"])
    for name in ("knn_graph_geodesic.npz", "codebook.npz", "codebook.pt",
                 "codes.npy"):
        assert (out / name).exists(), name
    cfg = json.loads(bytes(np.load(out / "codebook.npz")["config_json"]))
    assert cfg["device"] == "cpu" and cfg["K"] == 16


_IMPORT_CHECK = textwrap.dedent("""
    import importlib, pkgutil, sys
    import vqvae_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(vqvae_tpu_torch.__path__,
                                                  "vqvae_tpu_torch.")]
    # the device mesh (parallel/) is walked with the rest
    assert {"vqvae_tpu_torch.parallel",
            "vqvae_tpu_torch.parallel.mesh"} <= set(names), names
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # the smoke script's imports count too
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "orbax", "vqvae_tpu"))
    assert not bad, bad
    print(len(names))
    import torch
    from scipy import sparse
    import numpy as np
    from vqvae_tpu_torch.cli import (build_codebook_legacy_main,
                                     build_codebook_main,
                                     eval_codebook_metrics_main,
                                     evaluate_baseline_main,
                                     evaluate_codebook_health_main,
                                     evaluate_model_main,
                                     evaluate_quantization_loss_main,
                                     evaluate_vae_quality_main,
                                     generate_samples_main,
                                     run_baseline_pipeline, run_pipeline,
                                     train_baseline_main,
                                     train_transformer_main,
                                     train_vae_main)
    from vqvae_tpu_torch.cli import (eval_codebook_metrics,
                                     evaluate_baseline, pipeline,
                                     train_baseline_vqvae)
    from vqvae_tpu_torch.cli import build_codebook_legacy
    from vqvae_tpu_torch.config import Config
    from vqvae_tpu_torch.eval.lpips import lpips_distance
    from vqvae_tpu_torch.models import VQVAE, Transformer
    from vqvae_tpu_torch.ops import edge_lengths_riemannian
    from vqvae_tpu_torch.train import TransformerEngine, VQVAEEngine
    from vqvae_tpu_torch.utils.checkpoint import load_baseline_checkpoint
    from vqvae_tpu_torch.ops import nearest_codes
    from vqvae_tpu_torch.ops.gather_min import gather_min
    from vqvae_tpu_torch.ops.ell import BucketedGraph
    from vqvae_tpu_torch.tools import bench_gather_min
    from vqvae_tpu_torch.utils.checkpoint import load_vae_from_checkpoint
    from vqvae_tpu_torch.ops import (EdgeList, connected_components_device,
                                     edge_lengths_riemannian_nodal,
                                     fit_kmedoids_with_connectivity_check,
                                     knn_search, pullback_metrics)
    if not torch.cuda.is_available():
        # no entry point picks the CPU by itself: each needs device="cpu"
        z = np.zeros((4, 2), np.float32)
        calls = [
            lambda: build_codebook_main(Config({"out_dir": "unused"})),
            lambda: BucketedGraph.from_csr(sparse.eye(4, format="csr")),
            lambda: BucketedGraph.from_edges([0], [1], [1.0], 2),
            lambda: load_vae_from_checkpoint("unused.pt", {}),
            lambda: train_vae_main(Config({"model": {}, "data": {}})),
            lambda: evaluate_vae_quality_main("unused"),
            lambda: evaluate_quantization_loss_main("unused"),
            lambda: evaluate_codebook_health_main("unused"),
            lambda: nearest_codes(z, z),
            lambda: gather_min(z, np.zeros(2, np.int32)),
            lambda: bench_gather_min.main(["--rows", "8"]),
            lambda: train_transformer_main(Config({"model": {}, "data": {},
                                                   "training": {}})),
            lambda: TransformerEngine(Transformer(num_tokens=8,
                                                  embed_dim=8, n_head=2),
                                      lr=1e-3),
            lambda: generate_samples_main(Config({})),
            lambda: evaluate_model_main(Config({})),
            lambda: lpips_distance(z, z, weights_path="unused.npz"),
            lambda: run_pipeline("configs/sandbox-fashion/geodesic"),
            lambda: pipeline.main(["--preset",
                                   "configs/sandbox-fashion/geodesic"]),
            lambda: build_codebook_legacy_main(Config({"out_dir": "unused"})),
            lambda: build_codebook_legacy.main([
                "--config", "configs/sandbox-fashion/euclidean/codebook.yaml"]),
            lambda: edge_lengths_riemannian(lambda v: v, z, z),
            lambda: VQVAEEngine(VQVAE(z_channels=4, hidden=8)),
            lambda: load_baseline_checkpoint("unused.pt", {}),
            lambda: train_baseline_main(Config({})),
            lambda: evaluate_baseline_main(Config({})),
            lambda: eval_codebook_metrics_main(Config({})),
            lambda: run_baseline_pipeline("configs/baseline_vqvae/"
                                          "config.yaml"),
            lambda: train_baseline_vqvae.main([]),
            lambda: evaluate_baseline.main([]),
            lambda: eval_codebook_metrics.main([]),
            lambda: pipeline.main(["--baseline",
                                   "configs/baseline_vqvae/config.yaml"]),
            lambda: EdgeList.from_csr(sparse.eye(4, format="csr")),
            lambda: EdgeList.from_arrays([0], [1], [1.0], 2),
            lambda: connected_components_device(sparse.eye(4, format="csr")),
            lambda: pullback_metrics(lambda v: v, z),
            lambda: edge_lengths_riemannian_nodal(lambda v: v, z, [0], [1]),
            lambda: fit_kmedoids_with_connectivity_check(
                sparse.eye(4, format="csr"), K=2),
            lambda: knn_search(z, 2, device_max=1),
        ]
        for call in calls:
            try:
                call()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("ran without CUDA and without device=")
        print("raised")
""")


def test_port_imports_no_jax_and_needs_a_device_without_cuda():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert int(lines[0]) >= 56  # every module of every slice was imported
    if not torch.cuda.is_available():
        assert lines[-1] == "raised"


def test_no_module_of_the_port_names_jax_in_an_import():
    """Every import statement of the port's sources (the device mesh
    under ``parallel/`` included) and of ``chip_smoke.py``, read from the
    files: none names ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``
    or the JAX package, also inside functions."""
    import ast

    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "vqvae_tpu"}
    files = sorted((REPO / "vqvae_tpu_torch").rglob("*.py"))
    assert REPO / "vqvae_tpu_torch" / "parallel" / "mesh.py" in files
    bad = []
    for path in files + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {m}" for m in mods
                    if m.split(".")[0] in banned]
    assert not bad, bad
