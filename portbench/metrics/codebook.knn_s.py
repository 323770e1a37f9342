"""Mean seconds of the build's ``knn`` step over the window's builds,
from ``build_codebook_main``'s own span (``timings_s`` in the
``codebook.npz`` it writes). Each step ends in a host copy, so the span
holds its device work."""


def read(trace, info):
    spans = [t["knn"] for t in info.get("timings", [])
             if "knn" in t]
    if info.get("stage") != "codebook" or not spans:
        return None
    return sum(spans) / len(spans)
