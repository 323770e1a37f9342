"""The mid-block attention's share of its roofline: the least time an H100
needs for the traced epoch's ``scaled_dot_product_attention`` calls (the
training steps' forward and backward, the evaluation's forward; their
FLOPs at the float32 peak or their bytes at the HBM rate, whichever is
larger, ``yardstick_kl``), over the device time of the kernels that run
them. In float32 on the H100 PyTorch runs its memory-efficient CUTLASS
attention, ``fmha_cutlassF_f32_*`` forward and ``fmha_cutlassB_f32_*``
backward. Nothing when the trace holds none of them."""
import re

from portbench import yardstick_kl

SDPA = re.compile(r"\bfmha_cutlass[FB]_")


def read(trace, info):
    traced = info.get("traced") or {}
    if info.get("stage") != "vae_train" or trace is None \
            or "latent_channels" not in info.get("config", {}) \
            or not traced.get("train_steps"):
        return None
    seconds = trace.kernel_seconds(SDPA.search)
    if seconds <= 0:
        return None
    cfg = info["config"]
    bs = cfg["vae_train"]["batch_size"]
    bound = yardstick_kl.attention_bound_seconds(
        cfg, bs * traced["train_steps"], bs * traced["eval_steps"])
    return 100.0 * bound / seconds
