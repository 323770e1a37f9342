from .vae import (VAE, BatchNorm, Decoder, Encoder, elbo_loss, flax_init_,
                  reparameterize)

__all__ = ["VAE", "BatchNorm", "Decoder", "Encoder", "elbo_loss",
           "flax_init_", "reparameterize"]
