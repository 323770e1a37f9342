"""Config loading: plain YAML -> attribute-accessible nested mapping.

The port's own copy of ``vqvae_tpu/config.py`` (same contract, same
stage YAMLs under ``configs/``): plain ``yaml.safe_load`` per stage with
dotted attribute access, defaulting and deep-merge for overrides.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Iterator, Mapping

import yaml


class Config(Mapping):
    """Immutable-ish nested mapping with attribute and item access.

    ``cfg.model.latent_dim`` and ``cfg["model"]["latent_dim"]`` both work.
    Missing keys raise ``KeyError``/``AttributeError``; use ``.get`` for
    optional knobs.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", dict(data or {}))

    def __getitem__(self, key: str) -> Any:
        val = self._data[key]
        return Config(val) if isinstance(val, dict) else val

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        raise TypeError("Config is read-only")

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _deep_merge(base: Mapping, override: Mapping) -> dict:
    out = {k: copy.deepcopy(v) for k, v in base.items()}
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return out


def load_config(path: str | Path,
                overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a YAML config file, optionally deep-merged with ``overrides``."""
    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(
            f"config root must be a mapping, got {type(data)} in {path}")
    if overrides:
        data = _deep_merge(data, overrides)
    return Config(data)
