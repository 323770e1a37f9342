"""Plain references: float32 PyTorch written from the models' and the
codebook stage's descriptions. They import nothing of the program."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and cuDNN convolutions in full float32 (``tf32``
    False) or TF32, restored after the block. Recent PyTorch keeps one
    setting per backend and operator (cuDNN's start at TF32), older
    PyTorch the ``allow_tf32`` flags; the two may not be mixed."""
    if hasattr(torch.backends, "fp32_precision"):
        mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
        old = (mm.fp32_precision, conv.fp32_precision)
        mode = "tf32" if tf32 else "ieee"
        mm.fp32_precision = conv.fp32_precision = mode
        try:
            yield
        finally:
            mm.fp32_precision, conv.fp32_precision = old
    else:
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
