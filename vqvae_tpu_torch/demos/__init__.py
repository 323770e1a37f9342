"""The JAX package's demos, ported (``python -m vqvae_tpu_torch.demos.<name>``).

Each module has ``run(...) -> dict``, which computes and writes the JAX
demo's JSON or image artifacts under the same names, and ``main(argv)``,
which takes the JAX script's flags plus ``--device`` and then draws the
demo's matplotlib figure (imported only there, as the JAX demos do).
"""
