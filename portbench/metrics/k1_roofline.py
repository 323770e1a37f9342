"""K1's share of its roofline: the least time an H100 needs for the
traced build's exact kNN (one distance product per query-row pair at the
TF32 peak, or each input byte once at the HBM rate, the larger), over the
device time of the kernels of ``csrc/knn_select.cu`` (prep, the two
walks, the bound and the final pass) in the build traced after the
window. Nothing when the trace holds none of them."""
import re

from portbench import yardstick

K1 = re.compile(r"\b(prep_kernel|walk_kernel|bound_kernel|final_kernel)\b")


def read(trace, info):
    builds = (info.get("traced") or {}).get("builds")
    if info.get("stage") != "codebook" or trace is None or not builds:
        return None
    seconds = trace.kernel_seconds(K1.search)
    if seconds <= 0:
        return None
    cfg = info["config"]
    n = info["nodes"]
    bound = yardstick.k1_bound_seconds(n, n, cfg["vae"]["latent_dim"],
                                       cfg["codebook"]["k"] + 1)
    return 100.0 * bound * builds / seconds
