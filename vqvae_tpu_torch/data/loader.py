"""Fixed-shape batched data loading — the port's copy of
``vqvae_tpu/data/loader.py``.

A host-side numpy iterator that emits fixed-shape batches (the trailing
partial batch is padded with zero rows and masked), with the same
seed-derived per-epoch shuffle and the same augmentation (light rotation
for grayscale sets, random crop (pad 4) + horizontal flip for CIFAR), so
both packages see the same batches in the same order. The training engine
moves each batch to its device; the padded rows stay in the batch (the
BatchNorm statistics include them, as in the JAX package).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .datasets import DatasetSplit, load_dataset


def _rotate_batch(images: np.ndarray, degrees: np.ndarray) -> np.ndarray:
    """Rotate each image by its own angle via scipy (host-side, augment only)."""
    from scipy.ndimage import rotate

    out = np.empty_like(images)
    for i in range(images.shape[0]):
        out[i] = rotate(images[i], degrees[i], axes=(0, 1), reshape=False,
                        order=1, mode="constant", cval=0.0)
    return np.clip(out, 0.0, 1.0) if images.min() >= 0.0 else out


def _crop_flip_batch(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="constant")
    ys = rng.integers(0, 9, size=n)
    xs = rng.integers(0, 9, size=n)
    flips = rng.random(n) < 0.5
    out = np.empty_like(images)
    for i in range(n):
        img = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = img[:, ::-1] if flips[i] else img
    return out


class DataLoader:
    """Shuffled fixed-shape batch iterator over an in-memory split.

    Every batch is ``(images, labels, mask)`` with images (B,H,W,C) float32,
    labels (B,) int32 and mask (B,) float32 — mask is 0 for padding rows in
    the final batch so losses/metrics can exclude them without dynamic shapes.
    """

    def __init__(
        self,
        split: DatasetSplit,
        batch_size: int,
        shuffle: bool,
        augment: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
    ):
        self.split = split
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.augment = augment
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        n = split.images.shape[0]
        if drop_remainder:
            self.num_batches = n // self.batch_size
        else:
            self.num_batches = (n + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    @property
    def num_examples(self) -> int:
        return self.split.images.shape[0]

    def epoch(self, epoch_idx: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = self.num_examples
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self._rng.bit_generator.state["state"]["state"] + epoch_idx)
            rng.shuffle(order)
        else:
            rng = self._rng

        bs = self.batch_size
        for b in range(self.num_batches):
            idx = order[b * bs:(b + 1) * bs]
            images = self.split.images[idx]
            labels = self.split.labels[idx]
            mask = np.ones(len(idx), dtype=np.float32)
            if self.augment:
                if self.split.name == "cifar10":
                    images = _crop_flip_batch(images, rng)
                else:
                    degs = rng.uniform(-10, 10, size=len(idx))
                    images = _rotate_batch(images, degs)
            if len(idx) < bs:  # pad trailing batch to static shape
                pad = bs - len(idx)
                images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), images.dtype)])
                labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield images, labels, mask

    def __iter__(self):
        return self.epoch(0)


def get_split_loader(
    name: str,
    train: bool,
    root: str = "data",
    batch_size: int = 128,
    augment: bool = False,
    seed: int = 0,
    synthetic_size: Optional[int] = None,
) -> DataLoader:
    """One of ``get_data_loaders``' two loaders, without building the other
    split (the train split shuffles and may augment; the val split's
    synthetic stand-in has ``max(synthetic_size // 6, 32)`` images)."""
    if not train and synthetic_size is not None:
        synthetic_size = max(synthetic_size // 6, 32)
    split = load_dataset(name, root, train=train,
                         synthetic_size=synthetic_size, seed=seed)
    return DataLoader(split, batch_size, shuffle=train,
                      augment=augment and train, seed=seed)


def get_data_loaders(
    name: str,
    root: str = "data",
    batch_size: int = 128,
    augment: bool = False,
    seed: int = 0,
    synthetic_size: Optional[int] = None,
    **_compat_kwargs,
) -> Tuple[DataLoader, DataLoader]:
    """Train/val loader factory mirroring the reference API surface
    (reference src/data/factory.py:99-147). Extra torch-specific kwargs
    (num_workers, pin_memory, persistent_workers) are accepted and ignored.
    """
    return tuple(get_split_loader(name, train, root, batch_size, augment,
                                  seed, synthetic_size)
                 for train in (True, False))
