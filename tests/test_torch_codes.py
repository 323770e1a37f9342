"""Port parity: the code-sequence datasets and loader (``data/codes.py``).

Both packages read the same ``codes.npy`` (with -1 off-LCC grids) and
labels in each accepted form; the datasets' arrays and every batch of the
loaders (x, y, labels, mask, shuffled per epoch and padded at the end)
must be bit-identical.
"""
import numpy as np
import pytest
import torch

from vqvae_tpu.data import codes as jax_codes
from vqvae_tpu_torch.data import codes


def _write(tmp_path, n=50, seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 32, (n, 4, 4)).astype(np.int64)
    grid[[3, 17, 18, 40], rng.integers(0, 4, 4), rng.integers(0, 4, 4)] = -1
    labels = rng.integers(0, 10, n).astype(np.int64)
    np.save(tmp_path / "codes.npy", grid)
    np.save(tmp_path / "labels.npy", labels)
    np.savez(tmp_path / "labels.npz", y=labels)
    torch.save(torch.from_numpy(labels), tmp_path / "labels.pt")
    flat = grid[:, 0, 0].copy()
    np.save(tmp_path / "flat.npy", flat)
    return grid, labels


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("labels", [None, "labels.npy", "labels.npz",
                                    "labels.pt"])
def test_spatial_dataset_matches_jax(tmp_path, labels):
    grid, lab = _write(tmp_path)
    path = None if labels is None else str(tmp_path / labels)
    ref = jax_codes.CodesDataset(str(tmp_path / "codes.npy"), path)
    got = codes.CodesDataset(str(tmp_path / "codes.npy"), path)
    assert len(got) == len(ref) == 46 and got.seq_len == ref.seq_len == 16
    for a, b in zip(got.arrays(), ref.arrays()):
        _same(a, b)
    x, y, _ = got.arrays()
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])  # shifted by one


def test_vanilla_dataset_matches_jax(tmp_path):
    _write(tmp_path)
    args = (str(tmp_path / "flat.npy"), str(tmp_path / "labels.npy"))
    ref = jax_codes.VanillaCodesDataset(*args, num_tokens=33)
    got = codes.VanillaCodesDataset(*args, num_tokens=33)
    assert got.bos_token == ref.bos_token == 32
    for a, b in zip(got.arrays(), ref.arrays()):
        _same(a, b)


@pytest.mark.parametrize("vanilla", [False, True])
@pytest.mark.parametrize("batch_size", [8, 46, 64])
def test_loaders_match_jax_batch_for_batch(tmp_path, vanilla, batch_size):
    _write(tmp_path)
    kw = dict(codes_path=str(tmp_path / ("flat.npy" if vanilla
                                         else "codes.npy")),
              labels_path=str(tmp_path / "labels.npy"),
              batch_size=batch_size, vanilla_vae=vanilla, num_tokens=33,
              seed=5)
    ref_train, ref_val = jax_codes.get_code_loaders(**kw)
    train, val = codes.get_code_loaders(**kw)
    assert len(train) == len(ref_train) and len(val) == len(ref_val)
    for loader, ref in ((train, ref_train), (val, ref_val)):
        assert loader.shuffle == ref.shuffle
        for epoch in (0, 1, 3):
            batches = list(loader.epoch(epoch))
            ref_batches = list(ref.epoch(epoch))
            assert len(batches) == len(ref_batches)
            for got_b, ref_b in zip(batches, ref_batches):
                for a, b in zip(got_b, ref_b):
                    _same(a, b)
            mask = np.concatenate([b[3] for b in batches])
            assert mask.sum() == loader.x.shape[0]
    # "val" re-serves the training data unshuffled
    first = next(iter(val))
    head = train.x[:batch_size]
    np.testing.assert_array_equal(first[0][:len(head)], head)


def test_unlabelled_loader_and_errors(tmp_path):
    _write(tmp_path)
    train, _ = codes.get_code_loaders(str(tmp_path / "codes.npy"),
                                      batch_size=16)
    _, _, lab, _ = next(iter(train))
    assert lab.dtype == np.int32 and not lab.any()
    with pytest.raises(ValueError, match="num_tokens"):
        codes.get_code_loaders(str(tmp_path / "flat.npy"), vanilla_vae=True)
    with pytest.raises(ValueError, match="spatial codes"):
        codes.CodesDataset(str(tmp_path / "flat.npy"))
    (tmp_path / "labels.txt").write_text("0\n")
    with pytest.raises(ValueError, match="unsupported labels"):
        codes.CodesDataset(str(tmp_path / "codes.npy"),
                           str(tmp_path / "labels.txt"))
