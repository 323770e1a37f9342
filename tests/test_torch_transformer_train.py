"""Port parity: transformer training (``train/transformer_engine.py``,
``cli/train_transformer.py``), its checkpoints and ``resume``.

- 2 epochs on ``tests/test_engines.py``'s synthetic codes (128 sequences
  of 16 tokens over 32 codes, 10 classes, batch 32, dropout 0), both
  engines from the same (carried-across) initial weights. Only the batch
  order differs (each package draws its own permutations), so the epoch
  losses agree statistically: within rtol 6e-4, three times the largest
  gap seen over engine seeds 0-4 (1.9e-4); both decrease.
- the checkpoint files: each per-epoch ``latest.pt`` holds the weights
  without the optimizer; at the end ``best.pt`` and ``latest.pt`` hold
  ``model_state_dict``, ``optimizer_state_dict``, ``step`` and ``epoch``.
- ``resume`` through the CLI from a weights-only and from a full
  ``latest.pt`` (learning rate 0, so the weights must come back as saved;
  the optimizer's count and the step show which state was loaded).
- the CLI's label resolution against the JAX CLI's, and the
  ``labels_cache.npy`` it writes from a latents dir.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu.cli.train_transformer import (
    _resolve_labels_path as jax_resolve_labels_path)
from vqvae_tpu.data.codes import CodeLoader as JaxCodeLoader
from vqvae_tpu.models import Transformer as JaxTransformer
from vqvae_tpu.train import TransformerEngine as JaxEngine
from vqvae_tpu_torch.cli.train_transformer import (_resolve_labels_path,
                                                   train_transformer_main)
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.data.codes import CodeLoader
from vqvae_tpu_torch.models.transformer import Transformer
from vqvae_tpu_torch.train import TransformerEngine
from vqvae_tpu_torch.train import transformer_engine
from vqvae_tpu_torch.utils.checkpoint import (read_checkpoint,
                                              transformer_state_dict_from_jax)
from vqvae_tpu_torch.utils.latents import save_latents

REPO = Path(__file__).resolve().parents[1]
CFG = dict(num_classes=10, num_tokens=32, embed_dim=32, n_layers=2,
           n_head=2, max_seq_len=16, dropout=0.0)
FULL_KEYS = {"model_state_dict", "optimizer_state_dict", "step", "epoch"}


class _Log:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append(dict(metrics))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are tiny, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 32, size=(128, 16)).astype(np.int32)
    labels = rng.integers(0, 10, size=128).astype(np.int32)
    return codes, labels


def test_two_epochs_match_jax_engine(tmp_path, monkeypatch):
    codes, labels = _codes()
    jax_loader = JaxCodeLoader(codes[:, :-1], codes[:, 1:], labels,
                               batch_size=32, shuffle=True)
    jax_engine = JaxEngine(JaxTransformer(**CFG), lr=3e-4, cosine_t_max=2,
                           steps_per_epoch=len(jax_loader), seed=0)
    state = jax_engine.init_state(seq_len=15)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    jax_log = _Log()
    jax_engine.train(state, jax_loader, jax_loader, num_epochs=2,
                     logger=jax_log)

    writes = []
    save = transformer_engine.save_checkpoint
    monkeypatch.setattr(transformer_engine, "save_checkpoint",
                        lambda path, payload: writes.append(
                            (Path(path).name, set(payload)))
                        or save(path, payload))
    loader = CodeLoader(codes[:, :-1], codes[:, 1:], labels, batch_size=32,
                        shuffle=True)
    model = Transformer(**CFG)
    model.load_state_dict(transformer_state_dict_from_jax(params))
    engine = TransformerEngine(model, lr=3e-4, cosine_t_max=2,
                               steps_per_epoch=len(loader), seed=0,
                               device="cpu")
    log = _Log()
    engine.train(loader, loader, num_epochs=2, checkpoint_dir=tmp_path,
                 logger=log)

    assert len(log.rows) == len(jax_log.rows) == 2
    for got, want in zip(log.rows, jax_log.rows):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=6e-4,
                                       err_msg=key)
        assert got["train_steps"] == 4
    for rows in (log.rows, jax_log.rows):
        assert rows[1]["train_loss"] < rows[0]["train_loss"]
        assert rows[1]["val_loss"] < rows[0]["val_loss"]

    weights_only = {"model_state_dict", "step", "epoch"}
    assert writes == [("latest.pt", weights_only), ("latest.pt", weights_only),
                      ("best.pt", FULL_KEYS), ("latest.pt", FULL_KEYS)]
    best, latest = (read_checkpoint(tmp_path / n)
                    for n in ("best.pt", "latest.pt"))
    assert set(best) == set(latest) == FULL_KEYS
    assert (best["epoch"], best["step"]) == (2, 8)  # val loss fell twice
    assert (latest["epoch"], latest["step"]) == (2, 8)
    assert latest["optimizer_state_dict"]["count"] == 8
    for key, val in model.state_dict().items():
        torch.testing.assert_close(latest["model_state_dict"][key], val)


def _stage(tmp_path: Path, epochs: int, lr: float, resume: bool = False
           ) -> Path:
    codes, labels = _codes()
    grid = codes.reshape(128, 4, 4).astype(np.int64)
    grid[5, 2, 1] = -1  # one grid off the LCC: dropped with its label
    np.save(tmp_path / "codes.npy", grid)
    z = np.zeros((128, 4, 4, 2), np.float32)
    save_latents(tmp_path / "latents", z, z, z, labels)
    cfg = {
        "system": {"seed": 42},
        "data": {"codes_path": str(tmp_path / "codes.npy"),
                 "labels_path": str(tmp_path / "latents"),
                 "batch_size": 48, "vanilla_vae": False},
        "training": {"epochs": epochs, "lr": lr, "weight_decay": 0.01,
                     "label_smoothing": 0.1},
        "out": {"dir": str(tmp_path / "out")},
        "run_name": "transformer_test",
        "model": {**CFG, "dropout": 0.1},
        "resume": resume,
    }
    path = tmp_path / "transformer.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_resolves_labels_as_jax_does_and_writes_checkpoints(tmp_path):
    path = _stage(tmp_path, epochs=2, lr=3e-4)
    (tmp_path / "y_dir").mkdir()
    (tmp_path / "y_dir" / "y.pt").touch()
    for arg in (None, tmp_path / "latents", tmp_path / "y_dir",
                tmp_path / "labels.npy", "missing/latents.npz"):
        assert _resolve_labels_path(arg) == jax_resolve_labels_path(arg)
    proc = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.train_transformer",
         "--config", str(path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / "out"
    np.testing.assert_array_equal(  # the latents' y, as the JAX CLI writes
        np.load(out / "labels_cache.npy"),
        np.load(tmp_path / "latents" / "latents.npz")["y"].astype(np.int32))
    for name in ("best.pt", "latest.pt"):
        assert set(read_checkpoint(out / "checkpoints" / name)) == FULL_KEYS
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(np.isfinite(r["train_loss"])
                                  for r in rows)
    assert rows[0]["train_steps"] == 3  # 127 sequences in batches of 48
    params = yaml.safe_load((out / "params.yaml").read_text())
    assert params["device"] == "cpu" and params["embed_dim"] == 32


@pytest.mark.parametrize("full", [False, True],
                         ids=["weights-only", "full-state"])
def test_resume_from_latest(tmp_path, full):
    path = _stage(tmp_path, epochs=1, lr=0.0)
    cfg = load_config(path)
    train_transformer_main(cfg, device="cpu")
    latest = tmp_path / "out" / "checkpoints" / "latest.pt"
    saved = read_checkpoint(latest)
    # a different set of weights than a fresh init, so a resume shows
    weights = {k: v + 0.01 for k, v in saved["model_state_dict"].items()}
    payload = {"model_state_dict": weights, "step": 7, "epoch": 3}
    if full:
        opt = dict(saved["optimizer_state_dict"], count=5)
        payload["optimizer_state_dict"] = opt
    torch.save(payload, latest)

    train_transformer_main(load_config(path, {"resume": True}),
                           device="cpu")
    after = read_checkpoint(latest)
    for key, val in weights.items():  # lr 0: no update moves a weight
        torch.testing.assert_close(after["model_state_dict"][key], val)
    steps = 3
    assert after["step"] == 7 + steps
    assert after["optimizer_state_dict"]["count"] == \
        (5 if full else 0) + steps


def test_cli_refuses_bf16(tmp_path):
    """``model.dtype``: the CLI trains with ``bfloat16`` (float32
    parameters and checkpoints, finite losses) and refuses a dtype that is
    not floating."""
    path = _stage(tmp_path, epochs=1, lr=3e-4)
    cfg = load_config(path, {"model": {"dtype": "bfloat16"}})
    out = train_transformer_main(cfg, device="cpu")
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    latest = read_checkpoint(out / "checkpoints" / "latest.pt")
    assert all(v.dtype == torch.float32
               for v in latest["model_state_dict"].values())
    assert yaml.safe_load((out / "params.yaml").read_text())["dtype"] == \
        "bfloat16"
    for bad in ("int8", "float8"):
        cfg = load_config(path, {"model": {"dtype": bad}})
        with pytest.raises(ValueError, match="model.dtype"):
            train_transformer_main(cfg, device="cpu")


def test_run_epoch_matches_jax():
    """The per-batch ``run_epoch`` (host batches, loss read once) against
    JAX's, dropout 0, from the same weights: both loaders shuffle with
    ``default_rng(seed + epoch)``, so the batches are the same. rtol 1e-5
    on the train and the eval epoch's loss."""
    codes, labels = _codes()
    jax_loader = JaxCodeLoader(codes[:100, :-1], codes[:100, 1:],
                               labels[:100], batch_size=32, shuffle=True)
    jax_engine = JaxEngine(JaxTransformer(**CFG), lr=3e-4, cosine_t_max=2,
                           steps_per_epoch=len(jax_loader), seed=0)
    state = jax_engine.init_state(seq_len=15)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    state, jtr = jax_engine.run_epoch(state, jax_loader, True, 1,
                                      jax.random.key(1))
    _, jva = jax_engine.run_epoch(state, jax_loader, False, 1,
                                  jax.random.key(1))

    loader = CodeLoader(codes[:100, :-1], codes[:100, 1:], labels[:100],
                        batch_size=32, shuffle=True)
    model = Transformer(**CFG)
    model.load_state_dict(transformer_state_dict_from_jax(params))
    engine = TransformerEngine(model, lr=3e-4, cosine_t_max=2,
                               steps_per_epoch=len(loader), seed=0,
                               device="cpu")
    tr = engine.run_epoch(loader, True, 1)
    va = engine.run_epoch(loader, False, 1)
    assert engine.step == engine.opt.count == 4  # 100 rows, the last padded
    np.testing.assert_allclose(tr, jtr, rtol=1e-5)
    np.testing.assert_allclose(va, jva, rtol=1e-5)
    assert va < tr
