"""Display mapping, image grids and PNG output — the port of
``vqvae_tpu/utils/images.py``.

The PNG writer is a small standard-library encoder (``zlib`` + ``struct``,
8-bit grayscale or RGB, no filtering), so the port needs no imaging
package; its pixels are those the JAX package writes through PIL
(``round(clip(x, 0, 1) * 255)``). ``load_image`` is the matching reader:
8-bit grayscale, RGB and RGBA, not interlaced, with all five row filters
(PIL's writer picks a filter per row).
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


_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = data[y * (stride + 1)]
        raw = np.frombuffer(data, np.uint8, stride, y * (stride + 1) + 1)
        if ftype == 0:
            row = raw.copy()
        elif ftype == 1:  # Sub: a running sum along each sample lane
            row = (np.cumsum(raw.reshape(w, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            row = raw + prior
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(stride)
            r, up = raw.tolist(), prior.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (r[i] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = row
        prior = row
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """uint8 (H, W, C) pixels of an 8-bit grayscale, RGB or RGBA PNG."""
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace:
        raise ValueError(f"PNG reader takes 8-bit, non-interlaced gray, RGB "
                         f"or RGBA; got depth {depth}, colour type "
                         f"{color_type}, interlace {interlace}")
    bpp = _CHANNELS[color_type]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    return pixels.reshape(h, w, bpp)


def load_image(path: str | Path) -> np.ndarray:
    """A PNG as (H, W, C) float32 in [0, 1] (pixel / 255 in float32, as
    the JAX package's PIL reader gives it); alpha is dropped."""
    img = decode_png(Path(path).read_bytes()).astype(np.float32) / 255.0
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img
