"""Stage entry points of the port: VAE training, the codebook stage (the
spatial and the legacy builders), the quality evaluators, the transformer
prior, generation, evaluation, the pipeline orchestrator, and the EMA
VQ-VAE baseline's training, evaluation and codebook metrics."""
from .build_codebook import build_codebook_main, load_codebook
from .build_codebook_legacy import build_codebook_legacy_main
from .eval_codebook_metrics import eval_codebook_metrics_main
from .evaluate_baseline import evaluate_baseline_main
from .evaluate_model import evaluate_model_main
from .generate_samples import generate_samples_main
from .pipeline import run_baseline_pipeline, run_pipeline
from .quality_checks import (evaluate_codebook_health_main,
                             evaluate_quantization_loss_main,
                             evaluate_vae_quality_main, run_quality_stage)
from .train_baseline_vqvae import train_baseline_main
from .train_transformer import train_transformer_main
from .train_vae import train_vae_main

__all__ = ["build_codebook_main", "load_codebook",
           "build_codebook_legacy_main", "train_vae_main",
           "evaluate_vae_quality_main", "evaluate_quantization_loss_main",
           "evaluate_codebook_health_main", "run_quality_stage",
           "train_transformer_main", "generate_samples_main",
           "evaluate_model_main", "run_pipeline", "train_baseline_main",
           "evaluate_baseline_main", "eval_codebook_metrics_main",
           "run_baseline_pipeline"]
