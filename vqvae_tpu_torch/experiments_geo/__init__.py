"""The geodesic experiments of ``experiments_geo/``, ported
(``python -m vqvae_tpu_torch.experiments_geo.<name>``): ``run(...) ->
dict`` computes and writes the results, ``main(argv)`` takes the JAX
script's flags plus ``--device``."""
