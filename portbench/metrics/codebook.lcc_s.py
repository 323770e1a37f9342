"""Mean seconds of the build's ``lcc`` step over the window's builds,
from ``build_codebook_main``'s own span (``timings_s`` in the
``codebook.npz`` it writes). Each step ends in a host copy, so the span
holds its device work. This span also holds the compressed write of
the LCC graph (``sparse.save_npz`` inside ``t_lcc``)."""


def read(trace, info):
    spans = [t["lcc"] for t in info.get("timings", [])
             if "lcc" in t]
    if info.get("stage") != "codebook" or not spans:
        return None
    return sum(spans) / len(spans)
