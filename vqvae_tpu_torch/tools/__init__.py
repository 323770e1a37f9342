"""Command-line tools of the port (``python -m vqvae_tpu_torch.tools.<name>``)."""
