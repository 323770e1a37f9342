from .transformer import Transformer, cross_entropy_loss, transformer_init_
from .vae import (VAE, BatchNorm, Decoder, Encoder, decode_to_image,
                  elbo_loss, flax_init_, reparameterize)
from .vqvae_baseline import VQVAE, CodebookState
from .autoencoder_kl import AutoencoderKL

__all__ = ["VAE", "BatchNorm", "Decoder", "Encoder", "decode_to_image",
           "elbo_loss", "flax_init_", "reparameterize", "Transformer",
           "cross_entropy_loss", "transformer_init_", "VQVAE",
           "CodebookState", "AutoencoderKL"]
