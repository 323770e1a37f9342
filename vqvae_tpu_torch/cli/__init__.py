"""Stage entry points of the port (the codebook stage so far)."""
from .build_codebook import build_codebook_main, load_codebook

__all__ = ["build_codebook_main", "load_codebook"]
