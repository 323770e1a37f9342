"""Compute dtype with float32 parameters, as flax's ``dtype`` /
``param_dtype`` split does it.

Parameters stay float32. A layer built here computes in its
``compute_dtype``: the input, kernel and bias are cast to it first (flax's
``promote_dtype``), the product runs in it, and the bias is added as a
second operation (flax adds it after the product, rounding twice). At
float32 the layers are plain torch layers, op for op. Norms take their
dtype from their input instead (``models.vae.BatchNorm``,
``models.vae.GroupNorm``, ``models.transformer.LayerNorm``): the
statistics and the normalization run in float32 and the output is cast
back, as flax 0.12's norms do.

This is not ``torch.autocast``, which picks its own casts and keeps
norms and softmax in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# the floating dtypes ``model.dtype`` may name (those ``jnp.dtype`` takes
# for the JAX package's configs)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_dtype(dtype) -> torch.dtype:
    """A torch floating dtype from a config name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype in DTYPES.values():
            return dtype
    elif str(dtype) in DTYPES:
        return DTYPES[str(dtype)]
    raise ValueError(f"model.dtype {dtype!r}: expected one of "
                     f"{sorted(DTYPES)}")


class _Cast:
    compute_dtype = torch.float32

    def _cast(self, x, weight, bias):
        dt = self.compute_dtype
        return (x.to(dt), weight.to(dt),
                None if bias is None else bias.to(dt))


class Linear(_Cast, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        x, w, b = self._cast(x, self.weight, self.bias)
        y = F.linear(x, w)
        return y if b is None else y + b


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        x, w, b = self._cast(x, self.weight, self.bias)
        y = self._conv_forward(x, w, None)
        return y if b is None else y + b[:, None, None]


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x, output_size)
        x, w, b = self._cast(x, self.weight, self.bias)
        y = F.conv_transpose2d(x, w, None, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return y if b is None else y + b[:, None, None]


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of every cast layer of ``model``."""
    dt = resolve_dtype(dtype)
    for mod in model.modules():
        if isinstance(mod, _Cast):
            mod.compute_dtype = dt
    return model
