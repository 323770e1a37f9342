"""vqvae_tpu_torch — the PyTorch/CUDA port of vqvae_tpu for NVIDIA Hopper.

The JAX package ``vqvae_tpu`` stays the reference; this package mirrors its
layout and names (``ops/knn.py`` here is ``vqvae_tpu/ops/knn.py`` there) and
imports nothing from it. Plain tensor code is PyTorch; every Pallas kernel
of the JAX package on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``), where each kernel wrapper runs its plain PyTorch
version; see ``device.resolve_device``.
"""
