"""Port parity: the three training engines data-parallel over a ``gloo``
group (world sizes 2 and 4), against JAX's steps on ``get_mesh(world)`` of
the virtual CPU mesh.

The weights come from JAX's ``init`` (carried across with the state-dict
converters) and the batches from numpy seeds; the ranks (subprocesses that
import torch and the port only) take their ``shard_range`` of each global
batch of 8, run one engine step and write what they saw to an ``.npz``.
The gradients are the ones the engine hands its optimizer (after the sum
over ranks and the NaN guard).

- VAE (spatial, BatchNorm, no noise on either side): the loss within rtol
  1e-5, the gradients within rtol 1e-4 or 2e-5 of the tensor's largest
  (``tests/test_torch_vae_train.py``'s limit; conv biases that feed a
  BatchNorm have a true gradient of 0 and are held to ~0), the BatchNorm
  running statistics within rtol 1e-5 — with every row valid, and with a
  padded batch whose 5 valid rows fall unevenly over the ranks (the last
  rank of 4 holds none);
- the flat VAE with the capacity term ``|kl - C(step)|`` at step 3 (the
  term is nonlinear in the global KL);
- a NaN pixel in the last rank's rows: the global loss is not finite on
  every rank, the gradients become zeros, and every rank keeps finite,
  equal parameters;
- the transformer (dropout 0, 6 valid rows): loss and gradients against
  JAX's masked cross entropy on the sharded batch, same limits (the
  attention's key bias, whose true gradient is 0, held to ~0);
- the EMA VQ-VAE baseline (6 valid rows): the step's metrics (loss, rec,
  vq, q_mse, perplexity, usage) within rtol 1e-5, the EMA codebook within
  rtol 1e-5, the parameters within the single-step limit of
  ``tests/test_torch_vqvae_baseline.py``, and the 64 bank rows rows of
  the global batch's latents — the same rows, to rtol 1e-5, as one process
  drawing without replacement from the same generator (the zero padding
  images repeat latents, so rows are not told apart by value).
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

from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.models import VQVAE as JaxVQVAE
from vqvae_tpu.models import Transformer as JaxTransformer
from vqvae_tpu.models.transformer import cross_entropy_loss as jax_ce
from vqvae_tpu.models.vae import elbo_loss as jax_elbo
from vqvae_tpu.parallel import data_sharding, get_mesh
from vqvae_tpu.train import VQVAEEngine as JaxVQEngine
from vqvae_tpu_torch.models.vqvae_baseline import VQVAE
from vqvae_tpu_torch.train import VQVAEEngine
from vqvae_tpu_torch.utils.checkpoint import (codebook_state_from_jax,
                                              transformer_state_dict_from_jax,
                                              vae_state_dict_from_jax,
                                              vqvae_state_dict_from_jax)

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 6
VAE_CASES = {
    # name: (topology, valid rows, capacity step, NaN row)
    "bn": ("spatial", 8, 0, None),
    "pad": ("spatial", 5, 0, None),
    "cap": ("flat", 6, 3, None),
    "nan": ("spatial", 8, 0, 6),
}
TCFG = dict(num_classes=10, num_tokens=32, embed_dim=32, n_layers=2,
            n_head=2, max_seq_len=16, dropout=0.0)
ARCH = dict(in_channels=3, z_channels=8, hidden=16, n_res_blocks=1)
N_CODES, LR = 16, 2e-4

_WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)


def capture(engine):
    """The gradients the engine hands its optimizer, by name."""
    seen = {}
    step = engine.opt.step

    def wrapped():
        for name, p in engine.model.named_parameters():
            seen[name] = p.grad.detach().clone().numpy()
        step()
    engine.opt.step = wrapped
    return seen


def main():
    from vqvae_tpu_torch.parallel import init_distributed
    mesh = init_distributed(device="cpu")
    tmp = sys.argv[1]
    setup = torch.load(os.path.join(tmp, "setup.pt"), weights_only=False)
    out = {}

    from vqvae_tpu_torch.models.vae import VAE
    from vqvae_tpu_torch.train import VAEEngine
    from vqvae_tpu_torch.utils.checkpoint import load_vae_state_dict
    for name, case in setup["vae"].items():
        model = load_vae_state_dict(VAE(**case["cfg"]), case["sd"])
        eng = VAEEngine(model, lr=1e-3, weight_decay=1e-4,
                        grad_clip_max_norm=1.0, seed=0, device="cpu",
                        mesh=mesh)
        eng.step = case["step"]
        grads = capture(eng)
        mine = eng.local_rows(8)
        m = eng.train_step(torch.from_numpy(case["x"][mine]),
                           torch.from_numpy(case["mask"][mine]), 1.0, None,
                           nan_guard=True)
        out[f"{name}/loss"] = m["loss"].numpy()
        for k, v in grads.items():
            out[f"{name}/grad/{k}"] = v
        for k, v in eng.model.state_dict().items():
            out[f"{name}/state/{k}"] = v.numpy()

    from vqvae_tpu_torch.models.transformer import Transformer
    from vqvae_tpu_torch.train import TransformerEngine
    t = setup["transformer"]
    model = Transformer(**t["cfg"])
    model.load_state_dict(t["sd"])
    eng = TransformerEngine(model, lr=3e-4, seed=0, device="cpu", mesh=mesh)
    grads = capture(eng)
    mine = eng.local_rows(8)
    loss = eng.train_step(*(torch.from_numpy(t[k][mine])
                            for k in ("x", "y", "lab", "mask")), None)
    out["tf/loss"] = loss.numpy()
    for k, v in grads.items():
        out[f"tf/grad/{k}"] = v

    from vqvae_tpu_torch.models.vqvae_baseline import VQVAE, CodebookState
    from vqvae_tpu_torch.train import VQVAEEngine
    b = setup["baseline"]
    model = VQVAE(**b["arch"])
    model.load_state_dict(b["sd"])
    eng = VQVAEEngine(model, n_codes=b["n_codes"], lr=b["lr"],
                      grad_clip=1.0, bank_size=64, seed=0, device="cpu",
                      mesh=mesh)
    mine = eng.local_rows(8)
    cb = CodebookState(**b["cb"])
    cb, bank, m = eng.train_step(cb, torch.zeros(64, b["arch"]["z_channels"]),
                                 torch.from_numpy(b["x"][mine]),
                                 torch.from_numpy(b["mask"][mine]),
                                 torch.Generator().manual_seed(1),
                                 rows=(mine.start, 8))
    for k, v in m.items():
        out[f"vq/metric/{k}"] = v.numpy()
    for k, v in cb.as_dict().items():
        out[f"vq/cb/{k}"] = v.numpy()
    out["vq/bank"] = bank.numpy()
    for k, v in eng.model.state_dict().items():
        out[f"vq/param/{k}"] = v.numpy()
    np.savez(os.path.join(tmp, f"rank{mesh.rank}.npz"), **out)


if __name__ == "__main__":
    main()
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


def launch(src: str, world: int, tmp: Path, *args, timeout: float = 300):
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
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _vae_cfg(topology):
    cfg = dict(in_channels=1, enc_channels=ENC, dec_channels=DEC,
               latent_dim=LATENT, recon_loss="mse", output_image_size=28,
               norm_type="batch", topology=topology)
    if topology == "flat":
        cfg.update(capacity_max=15.0, capacity_anneal_steps=10)
    return cfg


def _vae_batch(valid, nan_row):
    rng = np.random.default_rng(0)
    x = rng.random((8, 28, 28, 1), dtype=np.float32)
    mask = np.ones(8, np.float32)
    x[valid:] = 0.0
    mask[valid:] = 0.0
    if nan_row is not None:
        x[nan_row, 5, 7, 0] = np.nan
    return x, mask


def _tf_batch():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 32, (8, 15)).astype(np.int64)
    y = rng.integers(0, 32, (8, 15)).astype(np.int64)
    lab = rng.integers(0, 10, 8).astype(np.int64)
    mask = np.ones(8, np.float32)
    mask[6:] = 0.0
    return x, y, lab, mask


def _vq_batch():
    x = np.random.default_rng(4).uniform(-1, 1, (8, 32, 32, 3)).astype(
        np.float32)
    mask = np.ones(8, np.float32)
    x[6:] = 0.0
    mask[6:] = 0.0
    return x, mask


@pytest.fixture(scope="module")
def jax_init():
    out = {"vae": {}}
    for topology in ("spatial", "flat"):
        model = JaxVAE(**_vae_cfg(topology))
        out["vae"][topology] = (model, _np_tree(model.init(
            {"params": jax.random.key(3)},
            np.zeros((1, 28, 28, 1), np.float32))))
    tmodel = JaxTransformer(**TCFG)
    out["tf"] = (tmodel, _np_tree(tmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, 15), jnp.int32),
        y=jnp.zeros((2,), jnp.int32))["params"]))
    return out


@pytest.fixture(scope="module")
def ranks(jax_init, tmp_path_factory):
    """Every rank's results at each world size, from one set of inputs."""
    setup = {"vae": {}}
    for name, (topology, valid, step, nan_row) in VAE_CASES.items():
        x, mask = _vae_batch(valid, nan_row)
        model, variables = jax_init["vae"][topology]
        setup["vae"][name] = {
            "cfg": _vae_cfg(topology), "x": x, "mask": mask, "step": step,
            "sd": vae_state_dict_from_jax(variables, topology, ENC, DEC)}
    x, y, lab, mask = _tf_batch()
    setup["transformer"] = {
        "cfg": TCFG, "x": x, "y": y, "lab": lab, "mask": mask,
        "sd": transformer_state_dict_from_jax(jax_init["tf"][1])}
    jeng, (state, jcb, _) = _jax_vq_engine(1)
    x, mask = _vq_batch()
    setup["baseline"] = {
        "arch": ARCH, "n_codes": N_CODES, "lr": LR, "x": x, "mask": mask,
        "sd": vqvae_state_dict_from_jax(_np_tree(state.params)),
        "cb": codebook_state_from_jax(_np_tree(jcb)).as_dict()}
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"train{world}")
        torch.save(setup, tmp / "setup.pt")
        launch(_WORKER, world, tmp, tmp)
        out[world] = [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(world)]
    return out


def _check_grads(got: dict, want: dict, pre_norm=()):
    assert set(got) <= set(want)
    for key, g in got.items():
        w = want[key].numpy()
        if key in pre_norm:  # true gradient 0: rounding residue both sides
            scale = np.abs(got[key[:-len("bias")] + "weight"]).max() \
                if key[:-len("bias")] + "weight" in got else 1.0
            assert np.abs(g).max() <= 1e-4 * max(scale, 1.0), key
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=key)


# -- VAE -------------------------------------------------------------------------

def _jax_vae_step(model, variables, x, mask, step, world):
    mesh = get_mesh(world)
    xs = jax.device_put(x, data_sharding(mesh, 4))
    ms = jax.device_put(mask, data_sharding(mesh, 1))

    def loss_fn(params):
        (logits, mu, logvar, _), new = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xs, None, True, mutable=["batch_stats"])
        total, _, _ = jax_elbo(
            xs, logits, mu, logvar, recon_loss=model.recon_loss,
            mse_use_sigmoid=model.mse_use_sigmoid, topology=model.topology,
            beta=1.0, mask=ms, free_bits=model.free_bits,
            capacity_max=model.capacity_max,
            capacity_anneal_steps=model.capacity_anneal_steps,
            capacity_mode=model.capacity_mode, step=step,
            spatial_free_bits=model.spatial_free_bits)
        return total, new["batch_stats"]

    (total, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return float(total), _np_tree(grads), _np_tree(stats)


def _pre_norm_biases(names):
    """Conv biases that feed a BatchNorm (``<seq>.<i>.bias`` before a norm
    at ``<seq>.<i+1>``, which has ``running_mean``)."""
    out = set()
    for key in names:
        if key.endswith(".running_mean"):
            base, i = key[:-len(".running_mean")].rsplit(".", 1)
            out.add(f"{base}.{int(i) - 1}.bias")
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["bn", "pad", "cap"])
def test_dp_vae_step_matches_jax_mesh(ranks, jax_init, world, case):
    topology, valid, step, nan_row = VAE_CASES[case]
    model, variables = jax_init["vae"][topology]
    x, mask = _vae_batch(valid, nan_row)
    total, grads, stats = _jax_vae_step(model, variables, x, mask, step,
                                        world)
    want_g = vae_state_dict_from_jax(
        {"params": grads, "batch_stats": variables["batch_stats"]},
        topology, ENC, DEC)
    want_s = vae_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": stats}, topology,
        ENC, DEC)
    names = [k[len(f"{case}/state/"):] for k in ranks[world][0]
             if k.startswith(f"{case}/state/")]
    pre_norm = _pre_norm_biases(names)
    assert len(pre_norm) == 5
    for res in ranks[world]:
        np.testing.assert_allclose(float(res[f"{case}/loss"]), total,
                                   rtol=1e-5)
        got = {k[len(f"{case}/grad/"):]: v for k, v in res.items()
               if k.startswith(f"{case}/grad/")}
        _check_grads(got, want_g, pre_norm)
        n_stats = 0
        for key, val in want_s.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(res[f"{case}/state/{key}"],
                                           val.numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=key)
                n_stats += 1
        assert n_stats == 10
    # every rank holds the same parameters after the summed-gradient step
    for res in ranks[world][1:]:
        for key in names:
            np.testing.assert_array_equal(res[f"{case}/state/{key}"],
                                          ranks[world][0][f"{case}/state/{key}"])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_vae_nan_on_one_rank_keeps_every_rank_finite(ranks, world):
    first = ranks[world][0]
    params = [k for k in first if k.startswith("nan/grad/")]
    for res in ranks[world]:
        assert not np.isfinite(float(res["nan/loss"]))
        for key in params:
            assert not np.any(res[key]), key  # zeroed by the guard
            name = "nan/state/" + key[len("nan/grad/"):]
            assert np.isfinite(res[name]).all(), name
            np.testing.assert_array_equal(res[name], first[name])


# -- transformer -----------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_dp_transformer_step_matches_jax_mesh(ranks, jax_init, world):
    model, params = jax_init["tf"]
    x, y, lab, mask = _tf_batch()
    mesh = get_mesh(world)
    put = lambda a, nd: jax.device_put(  # noqa: E731
        jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a),
        data_sharding(mesh, nd))
    xs, ys, ls, ms = put(x, 2), put(y, 2), put(lab, 1), put(mask, 1)

    def loss_fn(p):
        logits = model.apply({"params": p}, xs, y=ls, train=False)
        return jax_ce(logits, ys, mask=ms)

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = transformer_state_dict_from_jax(_np_tree(grads))
    for res in ranks[world]:
        np.testing.assert_allclose(float(res["tf/loss"]), float(total),
                                   rtol=1e-5)
        got = {k[len("tf/grad/"):]: v for k, v in res.items()
               if k.startswith("tf/grad/")}
        assert len(got) == len(want)
        # softmax ignores a constant added to every score: the key bias has
        # a true gradient of 0, rounding residue on both sides
        _check_grads(got, want, {k for k in got
                                 if k.endswith("attn.key.bias")})


# -- EMA VQ-VAE baseline ---------------------------------------------------------

def _jax_vq_engine(world):
    jeng = JaxVQEngine(JaxVQVAE(**ARCH), n_codes=N_CODES, lr=LR,
                       grad_clip=1.0, bank_size=64, seed=0,
                       mesh=get_mesh(world))
    return jeng, jeng.init_state((32, 32, 3))


@pytest.mark.parametrize("world", WORLDS)
def test_dp_baseline_step_matches_jax_mesh(ranks, world):
    jeng, (state, jcb, jbank) = _jax_vq_engine(world)
    port = VQVAE(**ARCH)
    port.load_state_dict(vqvae_state_dict_from_jax(_np_tree(state.params)))
    cb0 = codebook_state_from_jax(_np_tree(jcb))
    x, mask = _vq_batch()
    mesh = get_mesh(world)
    z_e = np.asarray(jax.jit(lambda p, v: jeng.model.apply(
        {"params": p}, v, method=jeng.model.encode))(state.params, x))
    state, jcb, _, jm = jeng._train_step(
        state, jcb, jbank, jax.device_put(x, data_sharding(mesh, 4)),
        jax.device_put(mask, data_sharding(mesh, 1)), jax.random.key(1))
    # one process drawing from the same generator: the same bank rows
    one = VQVAEEngine(port, n_codes=N_CODES, lr=LR, grad_clip=1.0,
                      bank_size=64, seed=0, device="cpu")
    _, bank1, _ = one.train_step(cb0, torch.zeros(64, 8), torch.from_numpy(x),
                                 torch.from_numpy(mask),
                                 torch.Generator().manual_seed(1))
    want_p = vqvae_state_dict_from_jax(_np_tree(state.params))
    flat = z_e.reshape(-1, 8)
    for res in ranks[world]:
        for key in ("loss", "rec", "vq", "q_mse", "perplex", "usage",
                    "dead"):
            np.testing.assert_allclose(float(res[f"vq/metric/{key}"]),
                                       float(jm[key]), rtol=1e-5, atol=1e-7,
                                       err_msg=key)
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(res[f"vq/cb/{key}"],
                                       np.asarray(getattr(jcb, key)),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        n_par = n_close = 0
        for key, ref in want_p.items():
            got, ref = res[f"vq/param/{key}"], ref.numpy()
            dp = np.abs(got - ref)
            assert (dp <= 1e-4 * np.abs(ref) + 2.0 * LR + 1e-7).all(), key
            n_close += int((dp <= 1e-4 * np.abs(ref) + 1e-7).sum())
            n_par += ref.size
        assert n_close >= 0.99 * n_par
        bank = res["vq/bank"]
        d = ((bank[:, None] - flat[None]) ** 2).sum(-1)
        assert bank.shape == (64, 8) and (d.min(1) < 1e-8).all()
        np.testing.assert_allclose(bank, bank1.numpy(), rtol=1e-5, atol=1e-6)
