"""The port's measurement and session tools on the CPU.

- ``tools.bench_kmedoids_prep``: ``make_random_graph`` equal to JAX's
  (indptr, indices and weights, exactly: the same numpy draws), the BFS
  order equal to JAX's ``bfs_node_order``, the COO rebuild equal to
  scipy's double index, and the timed run;
- ``tools.export_lpips_weights``: a synthetic lpips state_dict and a
  synthetic torchvision AlexNet state_dict through the tool and back
  through both packages' ``_load_weights``, every array exact; the npz
  equal to what JAX's tool builds from the same files;
- the other tools at a tiny size with ``--device cpu``: each runs and
  returns finite numbers (``bench_riemannian``'s conv engines agree
  within 1e-5, the nodal and the linearized one within 1e-3, JAX's
  nodal bound, and the tool refuses ``unfused``;
  ``check_riem_accuracy``'s conv engine on the CPU equals the CPU truth;
  ``ab_kmed_reorder``'s four fits give one QE; the CIFAR session stops
  with exit code 2 on a collapsed probe and otherwise runs the pipeline
  and the dilation experiment; ``ab_cifar_freebits`` trains both arms).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.tools import (ab_cifar_freebits, ab_kmed_reorder,
                                   bench_kmedoids_prep, bench_riemannian,
                                   check_cifar_collapse, check_riem_accuracy,
                                   export_lpips_weights, probe_pull,
                                   run_cifar_geodesic_session,
                                   run_fullscale_median)

REPO = Path(__file__).resolve().parents[1]
SANDBOX = REPO / "configs" / "sandbox-fashion" / "geodesic"
SMALL_RUN = {"vae": {"max_epochs": 1, "data": {"synthetic_size": 128}},
             "quality": {"synthetic_size": 64},
             "transformer": {"training": {"epochs": 1}},
             "evaluate": {"data": {"synthetic_size": 64}}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str):
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kmedoids_prep_graph_and_order_match_jax():
    from vqvae_tpu.ops.graph import bfs_node_order as jax_bfs
    from vqvae_tpu_torch.ops.graph import bfs_node_order

    ref = _jax_tool("bench_kmedoids_prep").make_random_graph(3000, 6)
    W = bench_kmedoids_prep.make_random_graph(3000, 6)
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(W, attr), getattr(ref, attr))
    perm = bfs_node_order(W)
    np.testing.assert_array_equal(perm, jax_bfs(ref))
    a = W[perm][:, perm]
    b = bench_kmedoids_prep.coo_permute(W, perm)
    assert (a != b).nnz == 0
    out = bench_kmedoids_prep.main(["--nodes", "3000", "--k", "6",
                                    "--device", "cpu"])
    assert out["nnz"] == W.nnz
    assert set(out["seconds"]) == {
        "make_graph", "bfs_node_order", "csr_perm_scipy_double_index",
        "csr_perm_coo_rebuild", "bucketed_from_csr_sym",
        "bucketed_from_csr_dedup"}
    assert all(t >= 0 for t in out["seconds"].values())


def _lpips_state_dict(rng):
    sd = {"scaling_layer.shift": torch.zeros(1, 3, 1, 1),
          "scaling_layer.scale": torch.ones(1, 3, 1, 1)}
    cin = 3
    for i, (ch, k, *_) in enumerate(export_lpips_weights._ALEX):
        slot = export_lpips_weights._TV_CONV_IDX[i]
        sd[f"net.slice{i + 1}.{slot}.weight"] = torch.from_numpy(
            rng.normal(size=(ch, cin, k, k)).astype(np.float32))
        sd[f"net.slice{i + 1}.{slot}.bias"] = torch.from_numpy(
            rng.normal(size=ch).astype(np.float32))
        cin = ch
    for i, (ch, *_) in enumerate(export_lpips_weights._ALEX):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            rng.random((1, ch, 1, 1)).astype(np.float32))
    return sd


def test_export_lpips_round_trips_through_both_loaders(tmp_path):
    from vqvae_tpu.eval.lpips import _load_weights as jax_load
    from vqvae_tpu_torch.eval.lpips import _load_weights

    rng = np.random.default_rng(0)
    sd = _lpips_state_dict(rng)
    torch.save(sd, tmp_path / "lpips.pt")
    out = export_lpips_weights.main(["--state_dict",
                                     str(tmp_path / "lpips.pt"), "--out",
                                     str(tmp_path / "a.npz")])
    want = {}
    for i, slot in enumerate(export_lpips_weights._TV_CONV_IDX):
        want[f"conv{i}/kernel"] = sd[f"net.slice{i + 1}.{slot}.weight"]
        want[f"conv{i}/bias"] = sd[f"net.slice{i + 1}.{slot}.bias"]
        want[f"lin{i}"] = sd[f"lin{i}.model.1.weight"].squeeze()
    for loader in (_load_weights, jax_load):
        for path in (out, tmp_path / "lpips.pt"):
            got = loader(Path(path))
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)

    # a torchvision trunk with and without the lpips heads, as JAX builds it
    tv = {f"features.{slot}.{p}": sd[f"net.slice{i + 1}.{slot}.{p}"]
          for i, slot in enumerate(export_lpips_weights._TV_CONV_IDX)
          for p in ("weight", "bias")}
    torch.save(tv, tmp_path / "alexnet.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")},
               tmp_path / "lins.pth")
    jax_tool = _jax_tool("export_lpips_weights")
    for lins in (None, tmp_path / "lins.pth"):
        ref = jax_tool.from_alexnet_state_dict(tmp_path / "alexnet.pth",
                                               lins)
        argv = ["--alexnet", str(tmp_path / "alexnet.pth"), "--out",
                str(tmp_path / "b.npz")]
        if lins is not None:
            argv += ["--lins", str(lins)]
        got = _load_weights(export_lpips_weights.main(argv))
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert str(got["meta/lins"]) == "calibrated"


def test_export_lpips_refuses_incomplete_weights(tmp_path):
    with pytest.raises(SystemExit, match="missing"):
        export_lpips_weights.export({"conv0/kernel": np.zeros(1)},
                                    tmp_path / "x.npz")


def test_bench_riemannian_engines(capsys):
    out = bench_riemannian.main([
        "--nodes", "300", "--knn", "4", "--batch", "128", "--runs", "1",
        "--engines", "indexed,edgewise,nodal,mlp,bf16", "--device", "cpu"])
    res, recs = out["results"], out["records"]
    assert set(recs) == {"mlp", "indexed", "edgewise", "nodal", "bf16"}
    assert res["edgewise_max_rel_diff"] < 1e-5
    # nodal against edgewise: JAX's own spatial bound; the linearized
    # decoder may gate a ReLU input at rounding distance from 0 otherwise
    assert res["nodal_max_rel_diff"] < 1e-3
    assert res["mlp_max_rel_diff"] < 1e-3
    assert np.isfinite(res["bf16_max_rel_diff"])
    assert recs["mlp"]["samples"] == 2 * out["edges"]
    assert recs["nodal"]["samples"] == 300 * 16
    assert recs["mlp"]["flops"] < recs["indexed"]["flops"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        json.loads(json.dumps(out))
    sweep = bench_riemannian.main([
        "--nodes", "300", "--knn", "4", "--dim", "32", "--channels", "3",
        "--size", "32", "--runs", "1", "--engines", "mlp", "--batches",
        "64,128", "--device", "cpu"])
    assert set(sweep["results"]) == {"bs64", "bs128"}
    with pytest.raises(ValueError, match="one JVP"):
        bench_riemannian.main(["--engines", "unfused", "--device", "cpu"])


def test_check_riem_accuracy_cpu():
    out = check_riem_accuracy.main([
        "--nodes", "500", "--edges", "200", "--batch", "64", "--channels",
        "3", "--size", "32", "--dim", "32", "--device", "cpu"])
    assert out["results"]["conv_indexed"]["max_rel"] == 0.0
    assert out["results"]["mlp"]["max_rel"] < 1e-4


def test_ab_kmed_reorder_and_probe_pull(tmp_path):
    out = ab_kmed_reorder.main(["--nodes", "1500", "--knn", "5", "--codes",
                                "16", "--out", str(tmp_path / "ab.json"),
                                "--device", "cpu"])
    assert [r["tag"] for r in out["runs"]] == ["A1", "B1", "B2", "A2"]
    assert len({round(r["qe"], 6) for r in out["runs"]}) <= 2
    assert all(np.isfinite(r["qe"]) for r in out["runs"])
    assert json.loads((tmp_path / "ab.json").read_text())["K"] == 16
    pull = probe_pull.main(["--rows", "1000", "--k", "11", "--runs", "2",
                            "--device", "cpu"])
    assert pull["results"]["f32"]["mb"] == pull["results"]["i32"]["mb"] \
        == 1000 * 11 * 4 / 1e6


def test_run_fullscale_median(tmp_path):
    rec = run_fullscale_median.run(SANDBOX, runs=2,
                                   out=tmp_path / "t.json",
                                   overrides=SMALL_RUN, root=tmp_path,
                                   device="cpu")
    assert len(rec["runs"]) == 2
    lo, hi = rec["band_seconds"]
    assert lo <= rec["median_total_seconds"] <= hi
    assert json.loads((tmp_path / "t.json").read_text())["band_seconds"] \
        == [lo, hi]


W8 = {"enc_channels": [8, 16, 32], "dec_channels": [32, 16, 8]}
CIFAR_SMALL = {
    "vae": {"max_epochs": 1, "data": {"synthetic_size": 128,
                                      "batch_size": 32}, "model": W8},
    "codebook": {"vae": W8, "quantize": {"K": 16}},
    "quality": {"synthetic_size": 64},
    "transformer": {"training": {"epochs": 1},
                    "model": {"num_tokens": 16, "embed_dim": 32,
                              "n_layers": 1, "n_head": 2}},
    "generate": {"vae": W8, "num_samples": 20, "top_k": 8,
                 "transformer": {"num_tokens": 16, "embed_dim": 32,
                                 "n_layers": 1, "n_head": 2}},
    "evaluate": {"data": {"synthetic_size": 64}, "num_samples": 20}}


def test_cifar_session(tmp_path, monkeypatch):
    monkeypatch.setattr(check_cifar_collapse, "run",
                        lambda *a, **k: {"collapsed": True})
    assert run_cifar_geodesic_session.main([
        "--root", str(tmp_path), "--device", "cpu"]) == 2
    assert not (tmp_path / "experiments" / "cifar10").exists()
    out = run_cifar_geodesic_session.run(
        skip_probe=True, root=tmp_path, overrides=CIFAR_SMALL,
        device="cpu")
    timings = json.loads((tmp_path / "experiments" /
                          "cifar10-spatial-geodesic-timings.json")
                         .read_text())
    assert timings == pytest.approx(out["timings"])
    assert "codebook" in timings and "evaluate" in timings
    exp = tmp_path / "experiments" / "cifar10" / "spatial" / "geodesic"
    saved = json.loads((exp / "riemann_graph_effect.json").read_text())
    assert saved["path_dilation_ratio"] == out["dilation"][
        "path_dilation_ratio"]
    assert np.isfinite(saved["path_dilation_ratio"])


def test_ab_cifar_freebits(tmp_path):
    out = ab_cifar_freebits.main(["--size", "64", "--epochs", "2",
                                  "--work", str(tmp_path / "w"), "--out",
                                  str(tmp_path / "ab.json"), "--device",
                                  "cpu"])
    assert out["control"]["free_bits"] is None
    assert out["freebits"]["free_bits"] == 0.1
    for arm in ("control", "freebits"):
        assert len(out[arm]["val_kl_trajectory"]) == 2
        assert np.isfinite(out[arm]["riem_unit_length_mean"])
    assert out["kl_floor_nats"] == pytest.approx(51.2)
    assert json.loads((tmp_path / "ab.json").read_text())["verdict"] == \
        out["verdict"]
