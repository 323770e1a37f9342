"""Stage entry points of the port: VAE training, the codebook stage, the
quality evaluators, the transformer prior, generation, evaluation and the
pipeline orchestrator."""
from .build_codebook import build_codebook_main, load_codebook
from .evaluate_model import evaluate_model_main
from .generate_samples import generate_samples_main
from .pipeline import run_pipeline
from .quality_checks import (evaluate_codebook_health_main,
                             evaluate_quantization_loss_main,
                             evaluate_vae_quality_main, run_quality_stage)
from .train_transformer import train_transformer_main
from .train_vae import train_vae_main

__all__ = ["build_codebook_main", "load_codebook", "train_vae_main",
           "evaluate_vae_quality_main", "evaluate_quantization_loss_main",
           "evaluate_codebook_health_main", "run_quality_stage",
           "train_transformer_main", "generate_samples_main",
           "evaluate_model_main", "run_pipeline"]

