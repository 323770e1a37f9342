"""Device selection for the port's entry points.

The default device is the GPU. Nothing here falls back to the CPU: a
caller that wants the host (the CPU tests do) asks for ``"cpu"``, and
then every kernel wrapper runs its plain PyTorch version because its
tensors lie on the CPU. Under a process group (``parallel.init_distributed``)
a bare ``"cuda"`` names the rank's card, ``cuda:LOCAL_RANK``; an explicit
``cuda:<i>`` is kept as given (two ranks may share one card under gloo).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _full_f32() -> None:
    """No TF32 in float32 matmuls or cuDNN convolutions. Recent PyTorch
    carries one precision setting per backend and operator; cuDNN's
    operators start at "tf32", which the global ``fp32_precision`` does
    not override, so each one is set (and the legacy ``allow_tf32`` flags,
    which may not be mixed with these, are left alone)."""
    if hasattr(torch.backends, "fp32_precision"):
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cudnn.rnn.fp32_precision = "ieee"
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is visible. Also turns TF32 off for matmuls and
    cuDNN convolutions: the JAX decoder path runs at ``highest`` precision
    (``vqvae_tpu/ops/riemannian.py:196-209``), and cuDNN would otherwise
    run float32 convolutions in TF32. Under a process group, ``"cuda"``
    without an index is ``cuda:LOCAL_RANK``.
    """
    _full_f32()
    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and dev.index is None and dist.is_available()
            and dist.is_initialized()):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vqvae_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
