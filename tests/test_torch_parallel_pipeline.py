"""Port parity: ``run_pipeline`` on the sandbox preset
(``configs/sandbox-fashion/geodesic``: the VAE on 64 synthetic images for
one epoch, one step of a batch of 64; the transformer for one epoch) at
world size 2 (two ``gloo`` ranks on the CPU, subprocesses that import
torch and the port only) against world size 1 (this process).

The VAE runs one step because its weights are compared: after the four
steps of 256 images one process already disagrees with itself across
thread counts (1 against 4 threads: 1,535 of the 32,768 elements of
``decoder.deconv_layers.0.weight`` beyond the limit below, up to 0.099 of
the learning rate), as Adam's normalized steps magnify the rounding of
near-zero gradients. Each step's data-parallel gradients are held against
JAX's in ``tests/test_torch_parallel_train.py``.

- each rank records every file it opens for writing or renames into place
  (an audit hook) and every path it hands ``torch.save`` (which writes
  from C++): rank 1 writes nothing, and every file of the run's tree
  was written by rank 0 — each artifact once, by rank 0;
- the VAE's best weights within the limits of
  ``tests/test_torch_vae_epoch.py``: rtol 1e-4 or 2e-5 of the tensor's
  largest value, at most 0.1 % of a tensor (or one element) beyond that and
  every element within 2 * steps * lr (conv biases that feed a BatchNorm
  to that bound only: their true gradient is 0; the global-batch BatchNorm uses
  flax's fast variance where one process uses torch's, and the gradient
  sums associate differently);
- the codebook stage is exact under sharding: a world-size-1 codebook
  stage run on world size 2's VAE checkpoint and latents gives the same
  ``codes.npy``, the same ``codebook.npz`` arrays and medoids, and the
  same graph; codes are -1 only off the LCC;
- the transformer's losses are finite and the rank-0 stages (quality,
  generate, evaluate) wrote their artifacts.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse

from vqvae_tpu_torch.cli.pipeline import run_pipeline

REPO = Path(__file__).resolve().parents[1]
PRESET = REPO / "configs" / "sandbox-fashion" / "geodesic"
EXP = Path("experiments") / "sandbox-fashion" / "geodesic"
OVERRIDES = {"vae": {"max_epochs": 1, "data": {"synthetic_size": 64}},
             "transformer": {"training": {"epochs": 1}}}
VAE_RUN = EXP / "vae" / "spatial_vae_fashionmnist"
LR, STEPS = 1e-3, 1  # the preset's learning rate; 64 images, batch 64

_WORKER = r'''
import json, os, sys
import torch
torch.set_num_threads(1)

root = os.path.realpath(sys.argv[1])
written = set()


def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        mode, flags = args[1], args[2] or 0
        writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                  else bool(flags & (os.O_WRONLY | os.O_RDWR)))
        if writes:
            written.add(os.path.realpath(os.fsdecode(args[0])))
    elif event == "os.rename":
        written.add(os.path.realpath(os.fsdecode(args[1])))


sys.addaudithook(audit)
_save = torch.save


def save(obj, f, *args, **kwargs):  # torch writes a path from C++
    if isinstance(f, (str, os.PathLike)):
        written.add(os.path.realpath(os.fspath(f)))
    return _save(obj, f, *args, **kwargs)


torch.save = save
from vqvae_tpu_torch.cli.pipeline import run_pipeline
from vqvae_tpu_torch.parallel import get_mesh

overrides = json.loads(sys.argv[3])
timings = run_pipeline(sys.argv[2], overrides=overrides, root_dir=root,
                       device="cpu")
mesh = get_mesh()
mine = sorted(p for p in written if p.startswith(root + os.sep))
with open(os.path.join(sys.argv[4], f"rank{mesh.rank}.json"), "w") as f:
    json.dump({"world": mesh.world_size, "written": mine,
               "timings": timings}, f)
'''


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


def launch(src: str, world: int, tmp: Path, *args, timeout: float = 600):
    """Run ``src`` as ``world`` gloo ranks; a rank that exits nonzero fails
    the test (the others are killed)."""
    worker = tmp / "worker.py"
    worker.write_text(src)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
                   VQVAE_TPU_SYNTH_SIZE="256")
        env.pop("LPIPS_WEIGHTS", None)
        env.pop("VQVAE_TPU_TIMINGS_PATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), *map(str, args)], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > t_end:
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
def runs(tmp_path_factory):
    """(world-1 root, world-2 root, world-2 records, world-1 codebook on
    world 2's VAE)."""
    one = tmp_path_factory.mktemp("one")
    two = tmp_path_factory.mktemp("two")
    logs = tmp_path_factory.mktemp("logs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQVAE_TPU_SYNTH_SIZE", "256")
        mp.delenv("LPIPS_WEIGHTS", raising=False)
        mp.delenv("VQVAE_TPU_TIMINGS_PATH", raising=False)
        run_pipeline(PRESET, overrides=OVERRIDES, root_dir=one, device="cpu")
        launch(_WORKER, 2, logs, two, PRESET, json.dumps(OVERRIDES), logs)
        records = [json.loads((logs / f"rank{r}.json").read_text())
                   for r in range(2)]
        # the codebook stage alone, one process, on world 2's VAE outputs
        again = tmp_path_factory.mktemp("again")
        shutil.copytree(two / EXP / "vae", again / EXP / "vae")
        run_pipeline(PRESET, overrides=OVERRIDES, root_dir=again,
                     device="cpu",
                     skip={"vae", "quality", "transformer", "generate",
                           "evaluate"})
    return one, two, records, again


def test_rank0_writes_every_artifact_once(runs):
    _, two, records, _ = runs
    assert [r["world"] for r in records] == [2, 2]
    assert records[1]["written"] == []
    files = {os.path.realpath(p) for p in two.rglob("*") if p.is_file()}
    assert files <= set(records[0]["written"])
    exp = two / EXP
    for path in (VAE_RUN / "checkpoints" / "best.pt",
                 VAE_RUN / "latents_train" / "latents.npz",
                 VAE_RUN / "metrics.csv",
                 EXP / "codebook" / "codes.npy",
                 EXP / "codebook" / "codebook.npz",
                 EXP / "transformer" / "checkpoints" / "best.pt",
                 EXP / "evaluation" / "codebook_health.json"):
        assert (two / path).is_file(), path
    assert (exp / "generate").exists() or any(exp.rglob("*.png"))
    t = records[0]["timings"]
    assert all(np.isfinite(v) and v >= 0 for v in t.values())


def test_vae_weights_match_one_process(runs):
    one, two, _, _ = runs
    a = torch.load(one / VAE_RUN / "checkpoints" / "best.pt",
                   weights_only=False)["model_state_dict"]
    b = torch.load(two / VAE_RUN / "checkpoints" / "best.pt",
                   weights_only=False)["model_state_dict"]
    assert set(a) == set(b)
    # conv biases that feed a BatchNorm: true gradient 0, every step is
    # rounding residue, held to the learning-rate bound only
    pre_norm = set()
    for key in a:
        if key.endswith(".running_mean"):
            base, i = key[:-len(".running_mean")].rsplit(".", 1)
            pre_norm.add(f"{base}.{int(i) - 1}.bias")
    assert len(pre_norm) == 5
    for key, ref in a.items():
        if not ref.is_floating_point():
            continue
        ref, got = ref.numpy(), b[key].numpy()
        dp = np.abs(got - ref)
        if key not in pre_norm:
            tight = dp <= 1e-4 * np.abs(ref) + 2e-5 * np.abs(ref).max()
            assert (~tight).sum() <= max(1, int(1e-3 * ref.size)), key
        if not key.endswith(("running_mean", "running_var")):
            assert (dp <= 2 * STEPS * LR).all(), key


def test_sharded_codebook_stage_is_exact(runs):
    _, two, _, again = runs
    cb_two, cb_one = two / EXP / "codebook", again / EXP / "codebook"
    codes = np.load(cb_two / "codes.npy")
    np.testing.assert_array_equal(codes, np.load(cb_one / "codes.npy"))
    with np.load(cb_two / "codebook.npz") as f2, \
            np.load(cb_one / "codebook.npz") as f1:
        for key in ("medoid_indices", "z_medoid"):
            np.testing.assert_array_equal(f2[key], f1[key])
        K = len(f2["medoid_indices"])
        assert json.loads(bytes(f2["config_json"]).decode())[
            "world_size"] == 2
    g2 = sparse.load_npz(cb_two / "knn_graph_geodesic.npz")
    g1 = sparse.load_npz(cb_one / "knn_graph_geodesic.npz")
    assert (g2 != g1).nnz == 0
    assert codes.min() >= -1 and codes.max() < K
    assert (codes >= 0).sum() == g2.shape[0]  # -1 only off the LCC


def test_transformer_losses_finite(runs):
    _, two, _, _ = runs
    rows = [json.loads(line) for line in
            (two / EXP / "transformer" / "metrics.jsonl").read_text()
            .splitlines()]
    assert rows and all(np.isfinite(r["train_loss"])
                        and np.isfinite(r["val_loss"]) for r in rows)
