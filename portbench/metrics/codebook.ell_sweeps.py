"""Gauss-Seidel sweeps of k-medoids' ELL relaxation over the first traced
build: the program's counter ``vqvae.kmedoids.ell_sweeps`` (one a sweep of
``ops/ell.py``'s ``_ell_run``, every pass of the build summed). Fewer
sweeps to the same fixed point is less device work and fewer host reads.
Nothing from a program without the counter, or a build whose passes ran
on another engine."""
from portbench import spans


def read(trace, info):
    rows = spans.first_stretch("vqvae.codebook.build")
    if info.get("stage") != "codebook" or rows is None:
        return None
    sweeps = [r.count for r in rows
              if r.name == "vqvae.kmedoids.ell_sweeps" and r.count is not None]
    return float(sum(sweeps)) if sweeps else None
