"""What the training engines share: seeded generators, the host-to-device
copy, the padded device-resident split, the NaN/Inf guard and the write
cadence. The port's own module: JAX's engines each keep their own copy."""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` (through pinned memory, without waiting
    for the device, on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def padded_split(arrays: Sequence[np.ndarray], batch_size: int, device):
    """Host ``arrays`` of ``n`` rows each, zero-padded to a whole number of
    batches (at least one), on ``device`` with a float32 validity mask, 1
    on the first ``n`` rows: (tensors, mask, steps, padded rows)."""
    n = len(arrays[0])
    n_steps = max(1, (n + batch_size - 1) // batch_size)
    n_pad = n_steps * batch_size
    mask = np.zeros((n_pad,), np.float32)
    mask[:n] = 1.0
    tensors = [to_device(a if n_pad == n else np.concatenate(
        [a, np.zeros((n_pad - n, *a.shape[1:]), a.dtype)]), device)
        for a in arrays]
    return tensors, to_device(mask, device), n_steps, n_pad


@torch.no_grad()
def zero_nonfinite_grads_(finite: torch.Tensor, params: Iterable) -> None:
    """JAX's NaN/Inf guard without a host sync: where ``finite`` (0-d bool)
    is false every gradient becomes zeros, and the optimizer still steps."""
    for p in params:
        if p.grad is not None:
            p.grad = torch.where(finite, p.grad, torch.zeros_like(p.grad))


class WriteCadence:
    """A checkpoint every ``stride`` epochs, the rate one write sustains:
    the write's seconds (the larger of the last write and 0.7 of the
    estimate before it) over the epoch's, from 1 to 25. Each engine keeps
    its own rule for when a write is due."""
    stride, estimate = 1, 0.0  # until the first write

    def record(self, write_seconds: float, epoch_seconds: float) -> None:
        self.estimate = max(write_seconds, 0.7 * self.estimate)
        self.stride = max(1, min(25, int(self.estimate
                                         / max(epoch_seconds, 1e-3))))
