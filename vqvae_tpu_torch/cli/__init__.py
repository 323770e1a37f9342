"""Stage entry points of the port: VAE training, the codebook stage and the
quality evaluators."""
from .build_codebook import build_codebook_main, load_codebook
from .quality_checks import (evaluate_codebook_health_main,
                             evaluate_quantization_loss_main,
                             evaluate_vae_quality_main, run_quality_stage)
from .train_vae import train_vae_main

__all__ = ["build_codebook_main", "load_codebook", "train_vae_main",
           "evaluate_vae_quality_main", "evaluate_quantization_loss_main",
           "evaluate_codebook_health_main", "run_quality_stage"]
