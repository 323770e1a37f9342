"""GroupNorm's share of its roofline: the HBM bytes of the traced epoch's
GroupNorms (forward and backward of the training steps, the evaluation's
forward, ``yardstick_kl``) at 3.35 TB/s, over the device time of
PyTorch's GroupNorm kernels (the statistics, the fused parameters, the
normalization and their backward: ``RowwiseMomentsCUDAKernel``,
``ComputeFusedParamsCUDAKernel``, ``GroupNormKernelImplInternal``,
``ComputeInternalGradientsCUDAKernel``,
``ComputeBackwardFusedParamsCUDAKernel``,
``GroupNormBackwardKernelImplInternal``, ``GammaBetaBackwardCUDAKernel*``;
the model has no LayerNorm, which would share the first's name). Nothing
when the trace holds none of them."""
import re

from portbench import yardstick_kl

GROUPNORM = re.compile(
    r"GroupNorm|\bRowwiseMomentsCUDAKernel|\bComputeFusedParamsCUDAKernel"
    r"|\bComputeInternalGradientsCUDAKernel"
    r"|\bComputeBackwardFusedParamsCUDAKernel|\bGammaBetaBackwardCUDAKernel")


def read(trace, info):
    traced = info.get("traced") or {}
    if info.get("stage") != "vae_train" or trace is None \
            or "latent_channels" not in info.get("config", {}) \
            or not traced.get("train_steps"):
        return None
    seconds = trace.kernel_seconds(GROUPNORM.search)
    if seconds <= 0:
        return None
    cfg = info["config"]
    bs = cfg["vae_train"]["batch_size"]
    bound = yardstick_kl.groupnorm_bound_seconds(
        cfg, bs * traced["train_steps"], bs * traced["eval_steps"])
    return 100.0 * bound / seconds
