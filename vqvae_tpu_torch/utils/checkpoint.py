"""VAE weights in the reference torch format, and the carry-across from JAX.

The port keeps no checkpoint format of its own: VAE weights live in the
reference implementation's ``{'model_state_dict', 'epoch'}`` ``.pt`` files,
whose state-dict names the port's ``models.VAE`` uses unchanged. Training
writes ``<ckpt_dir>/best.pt`` (weights of the best validation epoch) and
``<ckpt_dir>/latest.pt`` (which adds ``optimizer_state_dict`` and ``step``
for ``resume``), each atomically. The JAX package writes such files with
``vqvae_tpu.utils.torch_compat.export_reference_vae_checkpoint`` and reads
them with ``load_reference_vae_checkpoint``; its own orbax directories are
not readable here, but a path that names one (``.../checkpoints/best``,
as the stage presets do) resolves to the sibling ``best.pt`` when the port
wrote one.

Transformer checkpoints are ``.pt`` files of the same kind:
``<out>/checkpoints/best.pt`` and ``latest.pt`` hold
``{'model_state_dict', 'optimizer_state_dict', 'step', 'epoch'}`` when a
stage ends, and the ``latest.pt`` written after each epoch holds the
weights without the optimizer, as the JAX engine writes it.
``transformer_state_dict_from_jax`` carries flax's transformer params
across.

The baseline EMA VQ-VAE's checkpoints are ``.pt`` files too:
``<out_dir>/checkpoints/best.pt`` (the best validation loss so far) and
``latest.pt`` hold ``{'model', 'optimizer', 'codebook', 'epoch'}``
(``save_baseline_checkpoint`` / ``load_baseline_checkpoint``);
``vqvae_state_dict_from_jax`` and ``codebook_state_from_jax`` carry the
JAX model's params and codebook across.

``vae_state_dict_from_jax`` is the port's own copy of that mapping
(``vqvae_tpu/utils/torch_compat.py:160-251``), from the JAX ``variables``
as nested dicts of numpy arrays: HWIO -> OIHW for convs, HWIO -> IOHW with
a spatial flip for transposed convs (torch's transposed conv is the
gradient of correlation, flax's correlates with the kernel as given), and
the (4, 4, C) <-> (C, 4, 4) reorder at the flat bottleneck.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.vae import VAE
from ..parallel.mesh import is_primary

# VAE constructor arguments a stage config may carry; training-only keys
# (free bits, capacity annealing) are not read by the ported stages
_ARCH_KEYS = ("in_channels", "enc_channels", "dec_channels", "latent_dim",
              "recon_loss", "output_image_size", "norm_type",
              "mse_use_sigmoid", "topology")


def _t(arr) -> torch.Tensor:
    return torch.tensor(np.array(arr, np.float32))  # copies: no negative strides


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(kernel, (3, 2, 0, 1)))  # HWIO -> OIHW


def _conv_t(kernel) -> torch.Tensor:
    # HWIO -> IOHW with the spatial flip
    return _t(np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def vae_state_dict_from_jax(variables: Mapping, topology: str, enc_channels,
                            dec_channels, norm_type: str = "batch"
                            ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.VAE`` from JAX ``variables`` (nested dicts
    of numpy arrays: ``{"params": ..., "batch_stats": ...}``)."""
    norm_type = (norm_type or "none").lower()
    if norm_type not in ("batch", "none"):
        raise ValueError(f"norm_type {norm_type!r}: only batch/none carry "
                         f"across (the reference format has no group norm)")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    has_norm = norm_type == "batch"
    sd: Dict[str, torch.Tensor] = {}

    def put_bn(tkey: str, side: str, fkey: str):
        if has_norm:
            bn, st = params[side][fkey], stats[side][fkey]
            sd[f"{tkey}.weight"] = _t(bn["scale"])
            sd[f"{tkey}.bias"] = _t(bn["bias"])
            sd[f"{tkey}.running_mean"] = _t(st["mean"])
            sd[f"{tkey}.running_var"] = _t(st["var"])

    enc = params["encoder"]
    for i in range(len(enc_channels)):
        sd[f"encoder.conv_layers.{3 * i}.weight"] = _conv(
            enc[f"Conv_{i}"]["kernel"])
        sd[f"encoder.conv_layers.{3 * i}.bias"] = _t(enc[f"Conv_{i}"]["bias"])
        put_bn(f"encoder.conv_layers.{3 * i + 1}", "encoder", f"BatchNorm_{i}")
    for name in ("mu", "logvar"):
        head = enc[f"head_{name}"]
        if topology == "spatial":
            sd[f"encoder.fc_{name}.weight"] = _conv(head["kernel"])
        else:
            ch = enc_channels[-1]
            w = np.asarray(head["kernel"]).T  # (latent, 16C) HWC-major
            latent = w.shape[0]
            sd[f"encoder.fc_{name}.weight"] = _t(
                w.reshape(latent, 4, 4, ch).transpose(0, 3, 1, 2)
                .reshape(latent, -1))
        sd[f"encoder.fc_{name}.bias"] = _t(head["bias"])

    dec = params["decoder"]
    if topology == "spatial":
        sd["decoder.conv_in.weight"] = _conv(dec["conv_in"]["kernel"])
        sd["decoder.conv_in.bias"] = _t(dec["conv_in"]["bias"])
        for i in range(2):
            ct = dec[f"ConvTranspose_{i}"]
            sd[f"decoder.deconv_layers.{3 * i}.weight"] = _conv_t(ct["kernel"])
            sd[f"decoder.deconv_layers.{3 * i}.bias"] = _t(ct["bias"])
            put_bn(f"decoder.deconv_layers.{3 * i + 1}", "decoder",
                   f"BatchNorm_{i}")
        sd["decoder.deconv_layers.6.weight"] = _conv_t(dec["out"]["kernel"])
        sd["decoder.deconv_layers.6.bias"] = _t(dec["out"]["bias"])
    else:
        ch = dec_channels[0]
        w = np.asarray(dec["fc_in"]["kernel"]).T  # (16C, latent) HWC rows
        latent = w.shape[1]
        sd["decoder.fc.weight"] = _t(
            w.reshape(4, 4, ch, latent).transpose(2, 0, 1, 3)
            .reshape(-1, latent))
        sd["decoder.fc.bias"] = _t(
            np.asarray(dec["fc_in"]["bias"]).reshape(4, 4, ch)
            .transpose(2, 0, 1).reshape(-1))
        for i, blk in enumerate(("deconv1", "deconv2")):
            ct = dec[f"ConvTranspose_{i}"]
            sd[f"decoder.{blk}.0.weight"] = _conv_t(ct["kernel"])
            sd[f"decoder.{blk}.0.bias"] = _t(ct["bias"])
            put_bn(f"decoder.{blk}.1", "decoder", f"BatchNorm_{i}")
        sd["decoder.output_layer.weight"] = _conv_t(dec["out"]["kernel"])
        sd["decoder.output_layer.bias"] = _t(dec["out"]["bias"])
    return sd


def transformer_state_dict_from_jax(params: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.Transformer`` from flax's ``params`` (nested
    dicts of numpy arrays). Dense kernels (in, out) become (out, in);
    attention's q/k/v kernels (D, H, hd) and biases (H, hd) flatten the
    heads, its output kernel (H, hd, D) flattens them on the input side.
    ``class_emb`` is carried whenever flax materialised it."""
    sd: Dict[str, torch.Tensor] = {
        "token_emb.weight": _t(params["token_emb"]["embedding"]),
        "pos_emb": _t(params["pos_emb"]),
        "ln_f.weight": _t(params["ln_f"]["scale"]),
        "ln_f.bias": _t(params["ln_f"]["bias"]),
        "head.weight": _t(np.asarray(params["head"]["kernel"]).T),
    }
    if "class_emb" in params:
        sd["class_emb.weight"] = _t(params["class_emb"]["embedding"])
    n_layers = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_layers):
        blk, pre = params[f"block_{i}"], f"blocks.{i}"
        for ln, name in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            sd[f"{pre}.{name}.weight"] = _t(blk[ln]["scale"])
            sd[f"{pre}.{name}.bias"] = _t(blk[ln]["bias"])
        for proj in ("query", "key", "value"):
            kern = np.asarray(blk["attn"][proj]["kernel"])
            sd[f"{pre}.attn.{proj}.weight"] = _t(
                kern.reshape(kern.shape[0], -1).T)
            sd[f"{pre}.attn.{proj}.bias"] = _t(
                np.asarray(blk["attn"][proj]["bias"]).reshape(-1))
        kern = np.asarray(blk["attn"]["out"]["kernel"])
        sd[f"{pre}.attn.out.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
        sd[f"{pre}.attn.out.bias"] = _t(blk["attn"]["out"]["bias"])
        for dense, name in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            sd[f"{pre}.{name}.weight"] = _t(np.asarray(
                blk[dense]["kernel"]).T)
            sd[f"{pre}.{name}.bias"] = _t(blk[dense]["bias"])
    return sd


def vqvae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for ``models.vqvae_baseline.VQVAE`` from flax's
    ``params`` (nested dicts of numpy arrays, ``{"enc": ..., "dec": ...}``):
    conv kernels HWIO -> OIHW, transposed-conv kernels HWIO -> IOHW with
    the spatial flip. The map is linear, so it carries gradients too."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def put(tkey: str, layer: Mapping, transposed: bool = False):
        sd[f"{tkey}.weight"] = (_conv_t if transposed else _conv)(
            layer["kernel"])
        sd[f"{tkey}.bias"] = _t(layer["bias"])

    def put_res(side: str, tree: Mapping):
        n_res = sum(1 for k in tree if k.startswith("ResBlock_"))
        for i in range(n_res):
            for j in range(2):
                put(f"{side}.res.{i}.conv_{j}", tree[f"ResBlock_{i}"][f"Conv_{j}"])

    enc, dec = params["enc"], params["dec"]
    for j in range(4):
        put(f"enc.conv_{j}", enc[f"Conv_{j}"])
    put_res("enc", enc)
    for j in range(2):
        put(f"dec.conv_{j}", dec[f"Conv_{j}"])
        put(f"dec.convt_{j}", dec[f"ConvTranspose_{j}"], transposed=True)
    put_res("dec", dec)
    return sd


def codebook_state_from_jax(mapping: Mapping):
    """``CodebookState`` from JAX's (a ``CodebookState`` or its
    ``_asdict()``: embed, cluster_size, embed_avg)."""
    from ..models.vqvae_baseline import CodebookState

    if hasattr(mapping, "_asdict"):
        mapping = mapping._asdict()
    return CodebookState(**{k: _t(mapping[k]) for k in
                            ("embed", "cluster_size", "embed_avg")})


def save_baseline_checkpoint(path: str | Path, model: torch.nn.Module,
                             optimizer, codebook, epoch: int) -> Path:
    """A baseline VQ-VAE checkpoint ``{'model', 'optimizer', 'codebook',
    'epoch'}`` (``optimizer`` a ``train.state.Optimizer`` or None), on the
    CPU, written atomically."""
    return save_checkpoint(path, {
        "model": cpu_state_dict(model),
        "optimizer": (optimizer.state_dict() if optimizer is not None
                      else None),
        "codebook": {k: v.detach().to("cpu", copy=True)
                     for k, v in codebook.as_dict().items()},
        "epoch": int(epoch)})


def load_baseline_checkpoint(path: str | Path, model_config: Mapping,
                             device=None):
    """(``VQVAE`` in eval mode, ``CodebookState``) from a baseline
    checkpoint; ``model_config`` holds the config's ``model``
    keys (in_channels, z_channels, hidden, n_res_blocks). ``path`` may be
    a directory (``best.pt`` in it) or name ``.../best``."""
    from ..models.vqvae_baseline import CodebookState, VQVAE

    dev = resolve_device(device)
    path = Path(path)
    if path.is_dir():
        path = path / "best.pt"
    raw = read_checkpoint(path)
    model = VQVAE(in_channels=int(model_config.get("in_channels", 3)),
                  z_channels=int(model_config.get("z_channels", 128)),
                  hidden=int(model_config.get("hidden", 256)),
                  n_res_blocks=int(model_config.get("n_res_blocks", 2)))
    model.load_state_dict(raw["model"])
    cb = CodebookState(**{k: raw["codebook"][k].to(dev) for k in
                          ("embed", "cluster_size", "embed_avg")})
    return model.to(dev).eval(), cb


def build_vae(config: Mapping[str, Any]) -> VAE:
    """``models.VAE`` from a stage config's ``vae`` section."""
    cfg = {k: config[k] for k in _ARCH_KEYS if k in config}
    for key in ("enc_channels", "dec_channels"):
        if key in cfg:
            cfg[key] = tuple(cfg[key])
    return VAE(**cfg)


def load_vae_state_dict(model: VAE, state_dict: Mapping[str, torch.Tensor]
                        ) -> VAE:
    """Strict load, except for BatchNorm's ``num_batches_tracked`` counters,
    which files written from JAX weights do not carry."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"VAE state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def save_checkpoint(path: str | Path, payload: Mapping[str, Any]) -> Path:
    """``torch.save`` to a temporary file beside ``path``, then rename it
    into place, so a reader never sees a half-written checkpoint. Under a
    process group only rank 0 writes (the ranks share one filesystem)."""
    path = Path(path)
    if not is_primary():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(dict(payload), tmp)
    os.replace(tmp, path)
    return path


def cpu_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached CPU copy of ``model.state_dict()``."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def auto_detect_vae_config(state_dict: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Any]:
    """The architecture of a reference-format VAE state dict: in/enc/dec
    channels, latent dim, norm type, topology and image size (32 px for 3
    channels, else 28), as ``vqvae_tpu.utils.checkpoint.
    auto_detect_vae_config`` reads it from a params tree."""
    enc = sorted((k for k in state_dict
                  if k.startswith("encoder.conv_layers.")
                  and k.endswith(".weight")
                  and state_dict[k].ndim == 4),
                 key=lambda k: int(k.split(".")[2]))
    if not enc:
        raise ValueError("not a VAE state dict: no encoder convs found")
    enc_channels = tuple(int(state_dict[k].shape[0]) for k in enc)
    in_channels = int(state_dict[enc[0]].shape[1])
    norm_type = ("batch" if any(k.endswith("running_var")
                                for k in state_dict) else "none")
    mu_w = state_dict["encoder.fc_mu.weight"]
    topology = "spatial" if mu_w.ndim == 4 else "flat"
    if topology == "spatial":
        dec0 = int(state_dict["decoder.conv_in.weight"].shape[0])
        stages = [f"decoder.deconv_layers.{i}.weight" for i in (0, 3)]
    else:
        dec0 = int(state_dict["decoder.fc.weight"].shape[0]) // 16
        stages = [f"decoder.{b}.0.weight" for b in ("deconv1", "deconv2")]
    dec_channels = (dec0,) + tuple(int(state_dict[k].shape[1])
                                   for k in stages)
    return {
        "in_channels": in_channels,
        "enc_channels": enc_channels,
        "dec_channels": dec_channels[:len(enc_channels)],
        "latent_dim": int(mu_w.shape[0]),
        "norm_type": norm_type,
        "output_image_size": 32 if in_channels == 3 else 28,
        "topology": topology,
    }


def read_checkpoint(path: str | Path) -> Dict[str, Any]:
    """The dict in a ``.pt`` checkpoint, on the CPU. A path without the
    suffix (``.../checkpoints/best`` or ``latest``, the JAX package's
    names) reads the sibling ``best.pt`` when that file exists."""
    path = Path(path)
    sibling = path.with_name(path.name + ".pt")
    if path.suffix != ".pt" and sibling.is_file():
        path = sibling
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory (a JAX orbax checkpoint?); the port reads "
            f"reference .pt files only — write one from the JAX weights with "
            f"vqvae_tpu.utils.torch_compat.export_reference_vae_checkpoint")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_vae_from_checkpoint(path: str | Path,
                             config: Optional[Mapping[str, Any]],
                             device: Optional[torch.device] = None) -> VAE:
    """Rebuild the VAE described by ``config`` (``None``: read from the
    weights, with the JAX loader's defaults mse + sigmoid) and load a
    reference ``{'model_state_dict', 'epoch'}`` ``.pt`` file into it (eval
    mode), on ``device`` (``None`` means ``"cuda"``). ``path`` may name
    ``.../checkpoints/best`` for the sibling ``best.pt``."""
    dev = resolve_device(device)
    raw = read_checkpoint(path)
    sd = raw.get("model_state_dict", raw.get("model", raw))
    if config is None:
        config = {**auto_detect_vae_config(sd), "recon_loss": "mse",
                  "mse_use_sigmoid": True}
    model = load_vae_state_dict(build_vae(config), sd)
    return model.to(dev).eval()

