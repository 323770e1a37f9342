"""Dataset loading without torchvision: raw IDX / CIFAR-10 parsers + synthetic.

The port's own copy of ``vqvae_tpu/data/datasets.py``: the same parsers,
the same CIFAR-10 normalization constants and the same procedural
``_synthetic`` stand-in, bit for bit, so both packages train on identical
images when the raw files are absent (``synthetic_size`` shrinks it;
``VQVAE_TPU_SYNTH_SIZE`` is read as there). Images are NHWC float32:
grayscale sets in [0, 1], CIFAR-10 normalized per channel (mean (0.4914,
0.4822, 0.4465), std (0.2470, 0.2430, 0.2610)). Names match the reference
factory ("MNIST", "FashionMNIST", "CIFAR10", case-insensitive, MNIST
fallback). ``synthetic_rgb`` is the port's own: the procedural images at
3 x ``image_size`` x ``image_size`` in [-1, 1] (``DatasetSplit.signed``),
for image autoencoders trained at sizes no dataset in the repository has
(``synthetic_size`` images, 1,024 / 256 by default).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], dtype=np.float32)
CIFAR10_STD = np.array([0.2470, 0.2430, 0.2610], dtype=np.float32)

_MNIST_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


@dataclass
class DatasetSplit:
    """One split of an image dataset, fully materialized in host RAM."""

    images: np.ndarray  # (N, H, W, C) float32
    labels: np.ndarray  # (N,) int32
    name: str
    normalized: bool  # True if per-channel normalized (CIFAR)
    signed: bool = False  # True if in [-1, 1] (synthetic_rgb)

    @property
    def num_classes(self) -> int:
        return 10

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])  # type: ignore[return-value]

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        """Map model-space images back to [0,1] display space."""
        if self.signed:
            return (x + 1.0) * 0.5
        if not self.normalized:
            return x
        return x * CIFAR10_STD.reshape(1, 1, 1, -1) + CIFAR10_MEAN.reshape(1, 1, 1, -1)


def _open_maybe_gz(path: Path):
    gz = path.with_name(path.name + ".gz")
    if path.exists():
        return open(path, "rb")
    if gz.exists():
        return gzip.open(gz, "rb")
    raise FileNotFoundError(path)


def _read_idx_images(path: Path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic {magic} in {path}")
        buf = f.read(n * rows * cols)
    return np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: Path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic {magic} in {path}")
        buf = f.read(n)
    return np.frombuffer(buf, dtype=np.uint8).astype(np.int32)


def _find_idx_dir(root: Path, dataset_dirnames) -> Optional[Path]:
    """Search root (and conventional torchvision subdirs) for IDX files."""
    candidates = [root]
    for d in dataset_dirnames:
        candidates += [root / d, root / d / "raw"]
    for c in candidates:
        if (c / _MNIST_FILES[True][0]).exists() or (c / (_MNIST_FILES[True][0] + ".gz")).exists():
            return c
    return None


def _load_mnist_like(root: Path, train: bool, dirnames) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    d = _find_idx_dir(root, dirnames)
    if d is None:
        return None
    img_f, lbl_f = _MNIST_FILES[train]
    images = _read_idx_images(d / img_f).astype(np.float32) / 255.0
    labels = _read_idx_labels(d / lbl_f)
    return images[..., None], labels  # NHWC with C=1


def _load_cifar10(root: Path, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    for base in [root / "cifar-10-batches-py", root]:
        if (base / "data_batch_1").exists():
            break
    else:
        return None
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    imgs, lbls = [], []
    for fn in files:
        with open(base / fn, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], dtype=np.uint8))
        lbls.append(np.asarray(d[b"labels"], dtype=np.int32))
    x = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.concatenate(lbls)
    x = x.astype(np.float32) / 255.0
    x = (x - CIFAR10_MEAN) / CIFAR10_STD
    return x, y


def _synthetic(name: str, train: bool, size: Optional[int], image_shape, seed: int = 0):
    """Deterministic procedural stand-in with class-dependent structure.

    Each class renders a distinct oriented band/blob texture so VAEs learn
    nontrivial structure and class-conditional metrics remain meaningful.
    """
    H, W, C = image_shape
    n = size if size is not None else (60_000 if train else 10_000)
    rng = np.random.default_rng(seed + (0 if train else 1))
    labels = rng.integers(0, 10, size=n).astype(np.int32)

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    yy = yy / (H - 1) - 0.5
    xx = xx / (W - 1) - 0.5
    images = np.empty((n, H, W, C), dtype=np.float32)
    angles = rng.uniform(-0.3, 0.3, size=n).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    scales = rng.uniform(0.8, 1.2, size=n).astype(np.float32)
    for cls in range(10):
        idx = np.nonzero(labels == cls)[0]
        if idx.size == 0:
            continue
        base_angle = cls * np.pi / 10.0
        freq = 3.0 + cls * 0.7
        a = (base_angle + angles[idx])[:, None, None]
        proj = np.cos(a) * xx[None] + np.sin(a) * yy[None]
        r2 = (xx**2 + yy**2)[None]
        tex = 0.5 + 0.5 * np.sin(2 * np.pi * freq * scales[idx][:, None, None] * proj
                                 + phases[idx][:, None, None])
        blob = np.exp(-r2 / (0.08 + 0.02 * cls))
        img = np.clip(tex * blob, 0.0, 1.0).astype(np.float32)
        for c in range(C):
            images[idx, :, :, c] = np.clip(img * (1.0 - 0.15 * c), 0.0, 1.0)
    noise = rng.normal(0.0, 0.02, size=images.shape).astype(np.float32)
    images = np.clip(images + noise, 0.0, 1.0)
    if name == "cifar10":
        images = (images - CIFAR10_MEAN) / CIFAR10_STD
    return images, labels


def load_dataset(
    name: str,
    root: str | Path = "data",
    train: bool = True,
    synthetic_size: Optional[int] = None,
    allow_synthetic: bool = True,
    seed: int = 0,
    image_size: int = 256,
) -> DatasetSplit:
    """Load one split of MNIST / FashionMNIST / CIFAR10 (NHWC float32), or
    make one of ``synthetic_rgb`` at ``image_size``."""
    key = str(name).strip().lower().replace("-", "").replace("_", "")
    root = Path(root)
    if key == "syntheticrgb":
        n = synthetic_size or (1024 if train else 256)
        images, labels = _synthetic(key, train, n,
                                    (image_size, image_size, 3), seed)
        return DatasetSplit(images=images * 2.0 - 1.0, labels=labels,
                            name="synthetic_rgb", normalized=False,
                            signed=True)
    if key == "cifar10":
        loaded = _load_cifar10(root, train)
        shape, normalized = (32, 32, 3), True
        canonical = "cifar10"
    elif key == "fashionmnist":
        loaded = _load_mnist_like(root, train, ["FashionMNIST", "fashion-mnist", "fashion_mnist"])
        shape, normalized = (28, 28, 1), False
        canonical = "fashionmnist"
    else:  # MNIST and the reference's unknown-name fallback
        loaded = _load_mnist_like(root, train, ["MNIST", "mnist"])
        shape, normalized = (28, 28, 1), False
        canonical = "mnist"

    env_size = os.environ.get("VQVAE_TPU_SYNTH_SIZE")
    if loaded is None:
        if not allow_synthetic:
            raise FileNotFoundError(
                f"{name} not found under {root} and synthetic fallback disabled")
        if synthetic_size is None and env_size:
            synthetic_size = int(env_size) if train else max(int(env_size) // 6, 32)
        images, labels = _synthetic(canonical, train, synthetic_size, shape, seed)
    else:
        images, labels = loaded
        if synthetic_size is not None:  # subset real data too, for smoke runs
            images, labels = images[:synthetic_size], labels[:synthetic_size]
    return DatasetSplit(images=np.ascontiguousarray(images),
                        labels=np.ascontiguousarray(labels),
                        name=canonical, normalized=normalized)
