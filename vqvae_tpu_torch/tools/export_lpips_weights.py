"""Build ``data/lpips_alex.npz`` from LPIPS / AlexNet weights present on
the machine, so ``eval/lpips.py`` computes a real (non-null) LPIPS.

The port of ``tools/export_lpips_weights.py``, with the same inputs and
the same npz. LPIPS combines two artifacts: the AlexNet trunk
(torchvision ``alexnet-owt-*.pth``, keys
``features.{0,3,6,8,10}.{weight,bias}``) and the LPIPS linear
calibration heads (``lpips/weights/v0.1/alex.pth``, keys
``lin{0..4}.model.1.weight``). Sources, the first given wins:

- ``--from-lpips``: the installed ``lpips`` package's ``LPIPS(net='alex')``;
- ``--state_dict FILE``: a full lpips state_dict (trunk and heads), read
  by ``eval.lpips._load_weights``;
- ``--alexnet FILE [--lins FILE]``: a torchvision AlexNet state_dict, with
  the heads when given, else uniform heads (1/C a stage: the lpips
  package's ``lpips=False`` mode), recorded as ``meta/lins``;
- no flag: the files above under ``~/.cache/torch/hub/checkpoints`` and an
  importable ``lpips`` package.

The npz holds OIHW ``conv{0..4}/kernel``, ``conv{0..4}/bias`` and the
(C,) heads ``lin{0..4}``; after writing it, the port's loader reads it
back and every array is checked.

Run: ``python -m vqvae_tpu_torch.tools.export_lpips_weights
[--from-lpips | --state_dict F | --alexnet F [--lins F]]
[--out data/lpips_alex.npz]``.
"""
from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..eval.lpips import _ALEX, _load_weights

_STAGE_CH = [ch for ch, *_ in _ALEX]
# torchvision AlexNet ``features`` indices of the five convs
_TV_CONV_IDX = [0, 3, 6, 8, 10]
REQUIRED = tuple(k for i in range(5)
                 for k in (f"conv{i}/kernel", f"conv{i}/bias", f"lin{i}"))


def from_lpips_package() -> Dict[str, np.ndarray]:
    import lpips  # type: ignore

    m = lpips.LPIPS(net="alex")
    out = {}
    convs = [layer for s in (m.net.slice1, m.net.slice2, m.net.slice3,
                             m.net.slice4, m.net.slice5) for layer in s]
    conv_i = 0
    for layer in convs:
        if isinstance(layer, torch.nn.Conv2d):
            out[f"conv{conv_i}/kernel"] = layer.weight.detach().numpy()
            out[f"conv{conv_i}/bias"] = layer.bias.detach().numpy()
            conv_i += 1
    for i, lin in enumerate(m.lins):
        out[f"lin{i}"] = lin.model[-1].weight.detach().numpy().squeeze()
    out["meta/lins"] = np.array("calibrated")
    return out


def _torch_load(path: Path):
    return torch.load(path, map_location="cpu", weights_only=True)


def from_alexnet_state_dict(alexnet_path: Path,
                            lins_path: Optional[Path] = None
                            ) -> Dict[str, np.ndarray]:
    """The trunk from a torchvision AlexNet state_dict; the heads from the
    lpips calibration file when given, else uniform."""
    sd = _torch_load(alexnet_path)
    out = {}
    for i, tv_idx in enumerate(_TV_CONV_IDX):
        out[f"conv{i}/kernel"] = sd[f"features.{tv_idx}.weight"].numpy()
        out[f"conv{i}/bias"] = sd[f"features.{tv_idx}.bias"].numpy()
    if lins_path is not None:
        for k, v in _torch_load(lins_path).items():
            if "lin" in k and "weight" in k:
                idx = int("".join(c for c in k.split(".")[0] if c.isdigit()))
                out[f"lin{idx}"] = v.numpy().squeeze()
        out["meta/lins"] = np.array("calibrated")
    else:
        for i, ch in enumerate(_STAGE_CH):
            out[f"lin{i}"] = np.full(ch, 1.0 / ch, np.float32)
        out["meta/lins"] = np.array("uniform")
    return out


def discover() -> Dict[str, np.ndarray]:
    """The best weights found on the machine (see the module notes)."""
    hub = Path(os.path.expanduser("~/.cache/torch/hub/checkpoints"))
    alexnet = None
    for pat in ("alexnet-owt-*.pth", "alexnet*.pth"):
        hits = sorted(glob.glob(str(hub / pat)))
        if hits:
            alexnet = Path(hits[0])
            break
    lins = None
    try:
        import lpips  # type: ignore

        cand = Path(lpips.__file__).parent / "weights" / "v0.1" / "alex.pth"
        if cand.is_file():
            lins = cand
    except ImportError:
        pass
    if alexnet is None:
        raise FileNotFoundError(
            f"no AlexNet trunk checkpoint under {hub} (the trunk is "
            "required); fetch it on a networked machine and pass "
            "--alexnet/--lins")
    print(f"[export] trunk: {alexnet}")
    print(f"[export] lins: {lins or 'UNIFORM (lpips package not found)'}")
    return from_alexnet_state_dict(alexnet, lins)


def export(weights: Dict[str, np.ndarray], out) -> Path:
    """Write the npz and check it through the port's loader."""
    missing = [k for k in REQUIRED if k not in weights]
    if missing:
        raise SystemExit(f"incomplete weights, missing: {missing}")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **weights)
    back = _load_weights(out)
    for k in REQUIRED:
        if not np.array_equal(back[k], weights[k]):
            raise AssertionError(f"{out}: {k} does not read back")
    print(f"wrote {out} ({len(weights)} arrays)")
    return out


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--from-lpips", action="store_true",
                    help="use the installed lpips package directly")
    ap.add_argument("--state_dict", type=str, default=None,
                    help="full lpips state_dict .pt/.pth (trunk + lins)")
    ap.add_argument("--alexnet", type=str, default=None,
                    help="torchvision AlexNet state_dict (trunk only)")
    ap.add_argument("--lins", type=str, default=None,
                    help="lpips lin-head state_dict (with --alexnet)")
    ap.add_argument("--out", type=str, default="data/lpips_alex.npz")
    args = ap.parse_args(argv)
    if args.from_lpips:
        weights = from_lpips_package()
    elif args.state_dict:
        weights = _load_weights(Path(args.state_dict))
    elif args.alexnet:
        weights = from_alexnet_state_dict(
            Path(args.alexnet), Path(args.lins) if args.lins else None)
    else:
        weights = discover()
    return export(weights, args.out)


if __name__ == "__main__":
    main()
