"""Datasets over discrete code sequences for the transformer prior — the
port's own copy of ``vqvae_tpu/data/codes.py`` (numpy only, so its batches
are bit-identical to the JAX package's).

- ``CodesDataset``: (N, H, W) int codes -> drop any grid holding -1 (the
  off-LCC sentinel), flatten to length H*W sequences, serve
  (x = seq[:-1], y = seq[1:], label).
- ``VanillaCodesDataset``: one scalar code per image; BOS is
  ``num_tokens - 1``; serves (x = [BOS], y = [code], label).
- ``CodeLoader``: fixed-shape (x, y, label, mask) batches, shuffled with
  numpy ``default_rng(seed + epoch)``, the last batch padded with zeros
  and mask 0.
- ``get_code_loaders`` re-serves the training data as the unshuffled
  "val" loader, as the reference does, so loss curves stay comparable.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


def _load_labels(labels_path) -> Optional[np.ndarray]:
    if labels_path is None:
        return None
    p = Path(labels_path)
    if p.suffix == ".npy":
        return np.load(p).astype(np.int32)
    if p.suffix == ".npz":
        with np.load(p) as z:
            return z[list(z.files)[0]].astype(np.int32)
    if p.suffix == ".pt":  # reference artifacts
        import torch

        return torch.load(p, map_location="cpu",
                          weights_only=True).numpy().astype(np.int32)
    raise ValueError(f"unsupported labels file {p}")


class CodesDataset:
    def __init__(self, codes_path: str, labels_path: Optional[str] = None):
        codes = np.load(codes_path)
        if codes.ndim != 3:
            raise ValueError(f"spatial codes must be (N,H,W), got "
                             f"{codes.shape}")
        labels = _load_labels(labels_path)
        valid = ~(codes == -1).any(axis=(1, 2))
        codes = codes[valid]
        n, h, w = codes.shape
        self.codes = codes.reshape(n, h * w).astype(np.int32)
        self.labels = labels[valid] if labels is not None else None
        self.seq_len = h * w

    def __len__(self) -> int:
        return len(self.codes)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        return self.codes[:, :-1], self.codes[:, 1:], self.labels


class VanillaCodesDataset:
    def __init__(self, codes_path: str, labels_path: Optional[str] = None,
                 num_tokens: int = 512):
        codes = np.load(codes_path).reshape(-1)
        labels = _load_labels(labels_path)
        valid = codes != -1
        self.codes = codes[valid].astype(np.int32)
        self.labels = labels[valid] if labels is not None else None
        self.bos_token = int(num_tokens) - 1
        self.seq_len = 2  # [BOS, code]

    def __len__(self) -> int:
        return len(self.codes)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        n = len(self.codes)
        x = np.full((n, 1), self.bos_token, dtype=np.int32)
        return x, self.codes.reshape(n, 1), self.labels


class CodeLoader:
    """Fixed-shape batch iterator over (x, y, label, mask)."""

    def __init__(self, x: np.ndarray, y: np.ndarray,
                 labels: Optional[np.ndarray], batch_size: int,
                 shuffle: bool, seed: int = 0):
        self.x, self.y = x, y
        self.labels = labels
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._seed = seed
        self.num_batches = (x.shape[0] + self.batch_size - 1) \
            // self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    def epoch(self, epoch_idx: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        order = np.arange(self.x.shape[0])
        if self.shuffle:
            np.random.default_rng(self._seed + epoch_idx).shuffle(order)
        bs = self.batch_size
        for b in range(self.num_batches):
            idx = order[b * bs:(b + 1) * bs]
            x, y = self.x[idx], self.y[idx]
            lab = (self.labels[idx] if self.labels is not None
                   else np.zeros(len(idx), np.int32))
            mask = np.ones(len(idx), np.float32)
            if len(idx) < bs:
                pad = bs - len(idx)
                x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
                y = np.concatenate([y, np.zeros((pad, y.shape[1]), y.dtype)])
                lab = np.concatenate([lab, np.zeros(pad, lab.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield x, y, lab, mask

    def __iter__(self):
        return self.epoch(0)


def get_code_loaders(
    codes_path: str,
    labels_path: Optional[str] = None,
    batch_size: int = 128,
    vanilla_vae: bool = False,
    num_tokens: Optional[int] = None,
    seed: int = 0,
    **_compat_kwargs,
) -> Tuple[CodeLoader, CodeLoader]:
    if vanilla_vae:
        if num_tokens is None:
            raise ValueError("`num_tokens` must be provided for "
                             "VanillaCodesDataset")
        ds = VanillaCodesDataset(codes_path, labels_path,
                                 num_tokens=num_tokens)
    else:
        ds = CodesDataset(codes_path, labels_path)
    x, y, labels = ds.arrays()
    train = CodeLoader(x, y, labels, batch_size, shuffle=True, seed=seed)
    val = CodeLoader(x, y, labels, batch_size, shuffle=False, seed=seed)
    return train, val
