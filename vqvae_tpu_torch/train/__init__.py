from .state import cosine_per_epoch_schedule, make_optimizer
from .transformer_engine import TransformerEngine, sample_autoregressive
from .vae_engine import VAEEngine
from .vqvae_engine import VQVAEEngine

__all__ = ["VAEEngine", "VQVAEEngine", "TransformerEngine", "sample_autoregressive",
           "cosine_per_epoch_schedule", "make_optimizer"]
