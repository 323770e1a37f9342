"""The build's kNN distance products (one a node pair) and decoder JVPs
(two an edge, each twice the decoder's forward on a 1x1 latent), counted
by the benchmark from the shapes and the edges the builds made, over the
builds' host seconds, as a share of the H100's float32 peak."""
from portbench import yardstick


def read(trace, info):
    if info.get("stage") != "codebook" or not info.get("builds"):
        return None
    cfg = info["config"]
    n, d = info["nodes"], cfg["vae"]["latent_dim"]
    flops = (yardstick.knn_distance_flops(n, n, d)
             + yardstick.riemannian_flops(cfg, info["edges"]))
    return 100.0 * flops * info["builds"] / info["window_s"] \
        / yardstick.F32_FLOPS
