from .checkpoint import (auto_detect_vae_config, build_vae,
                         load_vae_from_checkpoint, save_checkpoint,
                         vae_state_dict_from_jax)
from .images import save_image_grid
from .latents import flatten_spatial, load_latents, save_latents
from .logging import MetricsLogger

__all__ = [
    "auto_detect_vae_config",
    "build_vae",
    "load_vae_from_checkpoint",
    "save_checkpoint",
    "vae_state_dict_from_jax",
    "MetricsLogger",
    "save_image_grid",
    "flatten_spatial",
    "load_latents",
    "save_latents",
]
