from .transformer import Transformer, cross_entropy_loss, transformer_init_
from .vae import (VAE, BatchNorm, Decoder, Encoder, elbo_loss, flax_init_,
                  reparameterize)
from .vqvae_baseline import VQVAE, CodebookState

__all__ = ["VAE", "BatchNorm", "Decoder", "Encoder", "elbo_loss",
           "flax_init_", "reparameterize", "Transformer",
           "cross_entropy_loss", "transformer_init_", "VQVAE",
           "CodebookState"]
