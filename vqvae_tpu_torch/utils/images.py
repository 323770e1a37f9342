"""Display mapping, image grids and PNG output — the port of
``vqvae_tpu/utils/images.py``.

The PNG writer is a small standard-library encoder (``zlib`` + ``struct``,
8-bit grayscale or RGB, no filtering), so the port needs no imaging
package; its pixels are those the JAX package writes through PIL
(``round(clip(x, 0, 1) * 255)``).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..data.datasets import CIFAR10_MEAN, CIFAR10_STD


def unnormalize_images(x: np.ndarray, dataset_name: str,
                       apply_sigmoid: bool) -> np.ndarray:
    """Dataset-aware logits -> display mapping (NHWC). CIFAR-10 trained
    with raw-logit MSE decodes into mean/std-normalized space, so display
    = x*std+mean clipped to [0, 1]; sigmoided models map through sigmoid;
    everything else clips."""
    if dataset_name.upper() == "CIFAR10" and not apply_sigmoid:
        return np.clip(x * CIFAR10_STD + CIFAR10_MEAN, 0.0, 1.0)
    if apply_sigmoid:
        return 1.0 / (1.0 + np.exp(-x))
    return np.clip(x, 0.0, 1.0)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile (N,H,W,C) [0,1] images into one (GH,GW,C) grid, torchvision-style
    (row-major, ``nrow`` images per row)."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.full((ncol * (h + padding) + padding,
                    nrow * (w + padding) + padding, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str | Path, nrow: int = 8,
                    padding: int = 2) -> Path:
    grid = make_grid(np.clip(images, 0.0, 1.0), nrow=nrow, padding=padding)
    return save_image(grid, path)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """PNG bytes of a uint8 (H, W) grayscale or (H, W, 3) RGB array."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3), got "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_image(img: np.ndarray, path: str | Path) -> Path:
    """Write (H, W, C) [0, 1] floats as an 8-bit PNG (C = 1 or 3)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    path.write_bytes(encode_png(arr))
    return path
