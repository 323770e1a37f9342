"""Final evaluation: the generated grid against class-matched real images —
the port of ``vqvae_tpu/cli/evaluate_model.py``.

The generated PNG grid is cut back into per-class cells (the cell size
inferred from the grid's size), real test images are collected class by
class in the same order, and PSNR, global-statistics SSIM and LPIPS are
computed on 3-channel copies resized to ``image_size``. Results land in
``metrics.yaml`` (4-digit strings and ``_full`` floats) beside a
``comparison_grid.png`` (the first 5 classes, real and generated in
turn). LPIPS is null, with the reason printed, unless its weights are
found (``eval/lpips.py``).

``_resize`` is PIL's ``Image.resize(..., BILINEAR)`` on 8-bit pixels,
written in numpy: the image is truncated to uint8 as the JAX package does
(``(clip(x) * 255).astype(uint8)`` in float32), then resampled by PIL's
two fixed-point passes (horizontal, then vertical, each rounding to 8
bits) with a triangle filter whose support grows with the downscale
factor.

Run: ``python -m vqvae_tpu_torch.cli.evaluate_model --config <yaml>
[--device cpu]``.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Optional

import numpy as np
import yaml

from ..config import Config, load_config
from ..data.datasets import load_dataset
from ..device import resolve_device
from ..eval.metrics import psnr_np, ssim_simple_np
from ..utils.images import load_image, save_image_grid

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` for the bilinear filter and its 8-bit
    normalisation: per output pixel the first input index and the integer
    weights (ksize taps, zero-padded)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
              for x in range(xmax)]
        total = sum(ws)
        for x, wt in enumerate(ws):
            wt = wt / total if total != 0.0 else wt
            kk[xx, x] = int(wt * (1 << _PRECISION_BITS)
                            + (0.5 if wt >= 0 else -0.5))
        bounds[xx] = xmin
    return bounds, kk


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit pass along axis 0 of a uint8 array (PIL's rounding and
    clipping)."""
    bounds, kk = _bilinear_coeffs(img.shape[0], out_size)
    src = img.astype(np.int64)
    taps = np.arange(kk.shape[1])
    rows = np.minimum(bounds[:, None] + taps[None, :], img.shape[0] - 1)
    acc = (src[rows] * kk.reshape(kk.shape + (1,) * (img.ndim - 1))).sum(1)
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bilinear_resize(arr: np.ndarray, size: int) -> np.ndarray:
    """PIL ``Image.fromarray(arr).resize((size, size), BILINEAR)`` of a
    uint8 (H, W) or (H, W, C) array: the horizontal pass first, then the
    vertical one, each only when that side changes size."""
    out = arr
    if arr.shape[1] != size:
        out = np.swapaxes(_resample_axis0(np.swapaxes(out, 0, 1), size),
                          0, 1)
    if arr.shape[0] != size:
        out = _resample_axis0(out, size)
    return out


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) [0, 1] float32 -> (size, size, C), through 8 bits."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8).squeeze()
    out = pil_bilinear_resize(arr, size).astype(np.float32) / 255.0
    if out.ndim == 2:
        out = out[..., None]
    return out


def _to3ch(img: np.ndarray) -> np.ndarray:
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def load_generated_grid(path: str | Path, num_images: int, size: int,
                        samples_per_class: int) -> np.ndarray:
    """Cut a grid PNG into (num_images, size, size, 3) cells (the cell size
    from the grid's size)."""
    grid = load_image(path)
    num_rows = num_images // samples_per_class
    gh, gw = grid.shape[:2]
    cell_h, cell_w = gh // num_rows, gw // samples_per_class
    images = []
    for row in range(num_rows):
        for col in range(samples_per_class):
            cell = grid[row * cell_h:(row + 1) * cell_h,
                        col * cell_w:(col + 1) * cell_w]
            images.append(_to3ch(_resize(cell, size)))
    return np.stack(images)


def load_real_by_class(dataset_name: str, num_images: int, size: int,
                       samples_per_class: int, root: str = "data",
                       synthetic_size: Optional[int] = None) -> np.ndarray:
    """Class-ordered real test images, [0, 1] display space, 3-channel;
    zeros where the split lacks samples of a class."""
    split = load_dataset(dataset_name, root=root, train=False,
                         synthetic_size=synthetic_size)
    imgs01 = split.denormalize(split.images)
    out = []
    for cls in range(num_images // samples_per_class):
        idx = np.nonzero(split.labels == cls)[0][:samples_per_class]
        for i in idx:
            out.append(_to3ch(_resize(imgs01[i], size)))
        for _ in range(samples_per_class - len(idx)):
            out.append(np.zeros((size, size, 3), np.float32))
    return np.stack(out)


def compute_lpips(generated: np.ndarray, real: np.ndarray,
                  device=None) -> Optional[float]:
    """LPIPS when a weights file is found (``eval/lpips.py``), else None
    with the reason printed."""
    from ..eval.lpips import lpips_distance

    try:
        return lpips_distance(generated, real, device=device)
    except FileNotFoundError as err:
        print(f"[evaluate] LPIPS: null — {err} "
              f"(run tools/export_lpips_weights.py on a machine with "
              f"torchvision/lpips weights to enable)")
        return None


def evaluate_model_main(cfg: Config, device=None) -> dict:
    """Evaluate the generated grid of ``cfg``; LPIPS runs on ``device``
    (default the GPU; raises when CUDA is absent and no device is
    given)."""
    dev = resolve_device(device)
    dataset_name = cfg.get("dataset_name",
                           cfg.get("data", Config({})).get("dataset_name",
                                                           "fashionmnist"))
    samples_per_class = int(cfg["samples_per_class"])
    num_samples = int(cfg["num_samples"])
    size = int(cfg["image_size"])

    generated = load_generated_grid(cfg["generated_path"], num_samples, size,
                                    samples_per_class)
    real = load_real_by_class(dataset_name, num_samples, size,
                              samples_per_class,
                              root=str(cfg.get("data_root", "data")),
                              synthetic_size=cfg.get("data", Config({})).get(
                                  "synthetic_size"))

    psnr_val = psnr_np(generated, real)
    ssim_val = ssim_simple_np(generated, real)
    lpips_val = compute_lpips(generated, real, device=dev)

    results = {"PSNR": f"{psnr_val:.4f}", "SSIM": f"{ssim_val:.4f}",
               "LPIPS": f"{lpips_val:.4f}" if lpips_val is not None else None,
               # full-precision twins: "0.0000" cannot tell a clipped
               # epsilon from a true zero
               "PSNR_full": float(psnr_val), "SSIM_full": float(ssim_val),
               "LPIPS_full": (float(lpips_val) if lpips_val is not None
                              else None)}
    print(f"PSNR: {psnr_val:.4f}, SSIM: {ssim_val:.4f}, "
          f"LPIPS: {results['LPIPS']}")

    out_dir = Path(cfg["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "metrics.yaml", "w") as f:
        yaml.safe_dump(results, f)

    # comparison grid: first 5 classes, 2 samples each, real/gen in turn
    cells = []
    for cls in range(min(num_samples // samples_per_class, 5)):
        s = cls * samples_per_class
        for i in range(2):
            cells.append(real[s + i])
            cells.append(generated[s + i])
    save_image_grid(np.stack(cells), out_dir / "comparison_grid.png", nrow=4)
    print(f"Results saved to {out_dir}")
    return {"PSNR": psnr_val, "SSIM": ssim_val, "LPIPS": lpips_val}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Evaluate generated samples (PyTorch port).")
    parser.add_argument("--config", required=True,
                        help="evaluate stage YAML (e.g. configs/"
                             "fashionmnist/spatial/geodesic/evaluate.yaml)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    evaluate_model_main(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
