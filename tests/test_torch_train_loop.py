"""What the port's training engines share (``train/loop.py``): the padded
device-resident split and the checkpoint write cadence, each against the
inline form the engines had before they shared it. The NaN guard is held
by the engines' parity tests (``test_torch_vae_epoch.py``,
``test_torch_vqvae_baseline.py``, ``test_torch_parallel_train.py``).
"""
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.train.loop import WriteCadence, padded_split

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,batch,shapes,steps", [
    (12, 4, [(28, 28, 1)], 3),                # an exact multiple
    (10, 4, [(32, 32, 3)], 3),                # a ragged last batch
    (3, 8, [(4,)], 1),                        # smaller than one batch
    (7, 3, [(15,), (15,), ()], 3),            # several arrays at once
])
def test_padded_split(n, batch, shapes, steps):
    rng = np.random.default_rng(n)
    arrays = [rng.standard_normal((n, *s)).astype(np.float32) for s in shapes]
    arrays[-1] = (arrays[-1] * 100).astype(np.int64)  # dtypes are kept
    tensors, mask, n_steps, n_pad = padded_split(arrays, batch, CPU)
    assert (n_steps, n_pad) == (steps, steps * batch)
    assert mask.dtype == torch.float32 and mask.shape == (n_pad,)
    assert mask[:n].eq(1).all() and mask[n:].eq(0).all()
    assert len(tensors) == len(arrays)
    for t, a in zip(tensors, arrays):
        assert t.dtype == torch.from_numpy(a).dtype
        assert t.shape == (n_pad, *a.shape[1:])
        assert torch.equal(t[:n], torch.from_numpy(a))
        assert t[n:].eq(0).all()


def _inline(writes, epochs):
    """The cadence as the engines wrote it inline: (stride, estimate)
    after each write."""
    save_stride, write_est, out = 1, 0.0, []
    for t, dt_epoch in zip(writes, epochs):
        write_est = max(t, 0.7 * write_est)
        save_stride = max(1, min(25, int(write_est / max(dt_epoch, 1e-3))))
        out.append((save_stride, write_est))
    return out


@pytest.mark.parametrize("writes,epochs", [
    ([0.01, 0.02, 0.01], [1.0, 1.0, 1.0]),          # cheap writes: stride 1
    ([3.0, 3.0, 9.0], [1.0, 1.0, 1.0]),             # writes outlast epochs
    ([100.0, 1.0, 1.0, 1.0], [1.0] * 4),            # capped at 25
    ([5.0, 0.1, 0.1, 0.1, 0.1, 0.1], [0.5] * 6),    # the 0.7 decay
    ([0.5, 0.5], [0.0, 1e-4]),                      # the epoch's 1 ms floor
])
def test_write_cadence(writes, epochs):
    cadence = WriteCadence()
    assert (cadence.stride, cadence.estimate) == (1, 0.0)
    got = []
    for t, dt in zip(writes, epochs):
        cadence.record(t, dt)
        got.append((cadence.stride, cadence.estimate))
    assert got == _inline(writes, epochs)
    strides = [s for s, _ in got]
    assert all(1 <= s <= 25 for s in strides)
    if max(writes) >= 25 * max(epochs):
        assert 25 in strides
