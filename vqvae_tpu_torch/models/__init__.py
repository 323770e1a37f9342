from .vae import VAE, Decoder, Encoder

__all__ = ["VAE", "Decoder", "Encoder"]
