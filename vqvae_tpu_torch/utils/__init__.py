from .checkpoint import (build_vae, load_vae_from_checkpoint,
                         save_checkpoint, vae_state_dict_from_jax)
from .latents import flatten_spatial, load_latents, save_latents

__all__ = [
    "build_vae",
    "load_vae_from_checkpoint",
    "save_checkpoint",
    "vae_state_dict_from_jax",
    "flatten_spatial",
    "load_latents",
    "save_latents",
]
