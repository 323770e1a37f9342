"""Mean seconds of the build's ``components`` step over the window's builds:
the largest connected component of that graph
(``largest_connected_component``, the native union-find). It is one of the
four parts of the CSR + LCC step, from ``build_codebook_main``'s own span
(``timings_s`` in the ``codebook.npz`` it writes). The four parts share
the clock readings at their boundaries, so they add up to
``codebook.lcc_s``. Nothing from a program whose builds do not time the
part."""


def read(trace, info):
    spans = [t["components"] for t in info.get("timings", [])
             if "components" in t]
    if info.get("stage") != "codebook" or not spans:
        return None
    return sum(spans) / len(spans)
