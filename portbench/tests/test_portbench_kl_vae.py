"""The FLUX.1 KL autoencoder's cell on the CPU: its tiny run at the
published widths, the faults its check must catch, the yardstick against
the reference's weights, and its three per-layer readers."""
import math

import numpy as np
import pytest
import torch

from portbench import harness, tracing, yardstick_kl
from portbench.reference import autoencoder_kl as ref_kl

from .conftest import TINY, run_tiny, tiny_cell

NAME = "flux1-dev-vae.kl-vae-train"
WIDTHS = ("in_channels", "out_channels", "block_out_channels",
          "layers_per_block", "latent_channels", "norm_num_groups")


def test_tiny_run_keeps_the_published_widths(tmp_path):
    assert set(TINY[NAME]) <= {"data", "vae_train"}
    cell = tiny_cell(NAME, tmp_path)
    published = harness.find_cell(NAME).config
    assert {k: cell.config[k] for k in WIDTHS} == {
        k: published[k] for k in WIDTHS}
    assert published["block_out_channels"] == [128, 256, 512, 512]
    result, notes = run_tiny(NAME, tmp_path)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                     "start_gap"}
    # softmax ignores a shift shared by every key: the k projections'
    # biases get a gradient of rounding alone, and the change leaves
    # them out
    assert notes["left_out"] == [
        "decoder.mid_block.attentions.0.to_k.bias",
        "encoder.mid_block.attentions.0.to_k.bias"]


def _state_unchanged(monkeypatch):
    from vqvae_tpu_torch.train import state
    monkeypatch.setattr(state.Optimizer, "step", lambda self: None)


def _attention_is_identity(monkeypatch):
    from vqvae_tpu_torch.models import autoencoder_kl
    monkeypatch.setattr(autoencoder_kl.Attention, "forward",
                        lambda self, x: x)


def _logvar_past_the_clamp(monkeypatch):
    """Weights whose log-variance starts near 25, over the clamp's 20, on
    both sides (the clamp only acts there)."""
    init = ref_kl.initial_state

    def high(cfg, seed, tag, device):
        sd = init(cfg, seed, tag, device)
        sd["encoder.conv_out.bias"][cfg["latent_channels"]:] = 25.0
        return sd

    monkeypatch.setattr(ref_kl, "initial_state", high)


def _clamp_left_out(monkeypatch):
    from vqvae_tpu_torch.models import autoencoder_kl
    _logvar_past_the_clamp(monkeypatch)
    monkeypatch.setattr(autoencoder_kl, "LOGVAR_RANGE",
                        (-math.inf, math.inf))


FAULTS = [(_state_unchanged, ("grad_gap", "change_gap")),
          (_attention_is_identity, ("loss_gap",)),
          (_clamp_left_out, ("loss_gap",))]


@pytest.mark.parametrize("fault, numbers", FAULTS,
                         ids=[f.__name__ for f, _ in FAULTS])
def test_a_broken_kl_step_is_not_correct(fault, numbers, tmp_path,
                                         monkeypatch):
    fault(monkeypatch)
    result, _ = run_tiny(NAME, tmp_path)
    assert not result["correct"]
    for number in numbers:
        c = result["checks"][number]
        assert c["value"] > c["limit"], result["checks"]
    if fault is _state_unchanged:
        assert result["checks"]["grad_gap"]["value"] == 1.0
        assert result["checks"]["change_gap"]["value"] == 1.0


def test_a_log_variance_past_the_clamp_is_correct_with_the_clamp(
        tmp_path, monkeypatch):
    """The clamp fault's weights alone: the program clamps as the
    reference does, and the run is correct."""
    _logvar_past_the_clamp(monkeypatch)
    result, _ = run_tiny(NAME, tmp_path)
    assert result["correct"], result["checks"]


def test_the_yardstick_counts_the_references_weights():
    cfg = harness.find_cell(NAME).config
    state = ref_kl.initial_state(cfg, 2121692627, 3, "cpu")
    assert yardstick_kl.param_count(cfg) == sum(
        t.numel() for t in state.values()) == 83_819_683
    assert yardstick_kl.latent_grid(cfg) == 32
    assert yardstick_kl.shapes(cfg).attention == [(32 * 32, 512)] * 2
    # one head of 512 over 1,024 tokens, twice
    assert yardstick_kl.attention_flops(cfg) == 2 * 4.0 * 1024 ** 2 * 512


def test_taps_count_the_kept_products():
    # the down sampler: pad right and bottom by one, 3x3 of stride 2
    for n in (4, 7, 32):
        ones = torch.nn.functional.conv2d(
            torch.nn.functional.pad(torch.ones(1, 1, n, n), (0, 1, 0, 1)),
            torch.ones(1, 1, 3, 3), stride=2)
        assert yardstick_kl.taps_1d(n, 3, 2, 0, 1) ** 2 == int(ones.sum())


def _trace(names, seconds=1.0):
    n = len(names)
    ns = int(seconds * 1e9)
    return tracing.Trace(9.0, np.arange(n, dtype=np.int64) * ns,
                         np.arange(1, n + 1, dtype=np.int64) * ns, names)


def test_the_roofline_readers():
    cfg = harness.find_cell(NAME).config
    info = {"stage": "vae_train", "config": cfg,
            "traced": {"train_steps": 8, "eval_steps": 2}}
    att = harness.reader("kl_vae.attention_roofline")
    gn = harness.reader("kl_vae.groupnorm_roofline")
    trace = _trace(["fmha_cutlassF_f32_aligned_32x128_gmem_sm80(Params)",
                    "fmha_cutlassB_f32_aligned_128x64_k65536_sm80(Params)",
                    "void at::native::(anonymous namespace)::"
                    "RowwiseMomentsCUDAKernel<float>(long)",
                    "void at::native::elementwise_kernel<128, 2, "
                    "GroupNormKernelImplInternal<float>>()",
                    "sm80_xmma_fprop_implicit_gemm_f32f32"])
    want = yardstick_kl.attention_bound_seconds(cfg, 96, 24)
    assert att(trace, info) == pytest.approx(100.0 * want / 2.0)
    want = yardstick_kl.groupnorm_bound_seconds(cfg, 96, 24)
    assert gn(trace, info) == pytest.approx(100.0 * want / 2.0)
    # bytes at 3.35 TB/s: GroupNorm's 2 + 3 floats an element of training
    elems = sum(c * p for c, p in yardstick_kl.shapes(cfg).norms)
    assert want == pytest.approx((96 * 20 + 24 * 8) * elems / 3.35e12)
    none = _trace(["sm80_xmma_fprop_implicit_gemm_f32f32", "reduce_kernel"])
    for read in (att, gn):
        assert read(none, info) is None
        assert read(None, info) is None
        assert read(trace, {**info, "stage": "codebook"}) is None
        # a VAE cell's configuration has no KL autoencoder
        assert read(trace, {**info, "config": {"vae": {}}}) is None


def test_the_attention_token_reader():
    from vqvae_tpu_torch.models import AutoencoderKL, VAE
    from vqvae_tpu_torch.train.vae_engine import VAEEngine, seeded_generator
    from vqvae_tpu_torch.utils import profiling

    read = harness.reader("kl_vae.attention_tokens")
    info = {"stage": "vae_train"}
    profiling.reset_spans()
    assert read(None, info) is None

    def traced_epoch(model, shape):
        eng = VAEEngine(model, lr=1e-4, device="cpu", steps_per_epoch=2)
        x = torch.rand((4, *shape), generator=seeded_generator("cpu", 0))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.train_epoch(x, torch.ones(4), torch.arange(4), 1e-6, 2, 2,
                            seeded_generator("cpu", 1))
            eng.eval_epoch(x, torch.ones(4), 1e-6, 2, 2,
                           seeded_generator("cpu", 2))

    try:
        # a BatchNorm VAE's epoch: its spans, no counter
        traced_epoch(VAE(in_channels=1, enc_channels=(8, 8, 8),
                         dec_channels=(8, 8, 8), latent_dim=4,
                         recon_loss="mse", norm_type="batch",
                         topology="spatial"), (28, 28, 1))
        assert read(None, info) is None
        profiling.reset_spans()
        traced_epoch(AutoencoderKL(block_out_channels=(32, 32),
                                   latent_channels=4), (16, 16, 3))
        # two attention calls a step over a batch of 2 on an 8x8 grid;
        # the evaluation's calls lie outside the training steps
        assert read(None, info) == 2 * 2 * 8 * 8
        assert read(None, {"stage": "codebook"}) is None
    finally:
        profiling.reset_spans()


def test_op_split_families():
    from portbench.tools import op_split
    assert [op_split.family(op) for op in (
        "aten::cudnn_convolution", "aten::convolution_backward",
        "aten::native_group_norm_backward", "aten::silu_backward",
        "aten::_efficient_attention_backward", "aten::addmm", "aten::mm",
        "aten::_foreach_addcdiv_", "aten::where", "aten::add_")] == [
        "convolution", "convolution", "groupnorm", "silu", "attention",
        "linear", "linear", "optimizer", "nan_guard", "other"]
    row = op_split.split(NAME, 2121692627, device="cpu",
                         overrides=TINY[NAME])
    assert set(row["device_s"]) == {f for f, _ in op_split.FAMILIES}
    assert row["device"] == "cpu" and row["total_s"] == 0.0
