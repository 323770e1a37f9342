"""Port parity: the data layer.

The synthetic splits (the stand-in every run without dataset files trains
on) must be bit-identical for FashionMNIST, MNIST and CIFAR-10, and the
loaders must emit identical (images, labels, mask) batches over two epochs,
with and without augmentation. A tiny IDX file set goes through both
parsers too.
"""
import gzip
import struct

import numpy as np
import pytest

from vqvae_tpu.data import get_data_loaders as jax_loaders
from vqvae_tpu.data import load_dataset as jax_load
from vqvae_tpu_torch.data import get_data_loaders, load_dataset


@pytest.mark.parametrize("name", ["FashionMNIST", "mnist", "CIFAR10"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_splits_bit_identical(name, train):
    ref = jax_load(name, root="no-such-dir", train=train,
                   synthetic_size=300, seed=7)
    got = load_dataset(name, root="no-such-dir", train=train,
                       synthetic_size=300, seed=7)
    assert got.name == ref.name and got.normalized == ref.normalized
    assert got.images.dtype == ref.images.dtype == np.float32
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.labels, ref.labels)
    x = got.images[:4]
    np.testing.assert_array_equal(got.denormalize(x), ref.denormalize(x))


@pytest.mark.parametrize("name,augment", [("FashionMNIST", False),
                                          ("FashionMNIST", True),
                                          ("CIFAR10", True)])
def test_loader_batches_identical_over_two_epochs(name, augment):
    kw = dict(root="no-such-dir", batch_size=48, augment=augment, seed=3,
              synthetic_size=200)
    ref_tr, ref_va = jax_loaders(name, **kw)
    tr, va = get_data_loaders(name, **kw)
    assert len(tr) == len(ref_tr) and len(va) == len(ref_va)
    for epoch in (0, 1):
        for ref_l, l in ((ref_tr, tr), (ref_va, va)):
            ref_b = list(ref_l.epoch(epoch))
            got_b = list(l.epoch(epoch))
            assert len(got_b) == len(ref_b)
            for (ri, rl, rm), (gi, gl, gm) in zip(ref_b, got_b):
                np.testing.assert_array_equal(gi, ri)
                np.testing.assert_array_equal(gl, rl)
                np.testing.assert_array_equal(gm, rm)
    # the last batch is padded and masked: 200 = 4 * 48 + 8
    _, _, mask = list(tr.epoch(0))[-1]
    assert mask.sum() == 8 and mask.shape == (48,)


def test_idx_files_parse_identically(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "FashionMNIST" / "raw"
    root.mkdir(parents=True)
    for split, n in (("train", 12), ("t10k", 5)):
        imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
        lbls = rng.integers(0, 10, n).astype(np.uint8)
        with gzip.open(root / f"{split}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with open(root / f"{split}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n) + lbls.tobytes())
    for train in (True, False):
        ref = jax_load("fashionmnist", root=tmp_path, train=train)
        got = load_dataset("fashionmnist", root=tmp_path, train=train)
        np.testing.assert_array_equal(got.images, ref.images)
        np.testing.assert_array_equal(got.labels, ref.labels)
