from .state import cosine_per_epoch_schedule, make_optimizer
from .vae_engine import VAEEngine

__all__ = ["VAEEngine", "cosine_per_epoch_schedule", "make_optimizer"]
