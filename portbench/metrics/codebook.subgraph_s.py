"""Mean seconds of the build's ``subgraph`` step over the window's builds:
the LCC's subgraph (scipy's fancy index and ``.tocsr()``; nothing to index
where the LCC is the whole graph). It is one of the four parts of the CSR
+ LCC step, from ``build_codebook_main``'s own span (``timings_s`` in the
``codebook.npz`` it writes). The four parts share the clock readings at
their boundaries, so they add up to ``codebook.lcc_s``. Nothing from a
program whose builds do not time the part."""


def read(trace, info):
    spans = [t["subgraph"] for t in info.get("timings", [])
             if "subgraph" in t]
    if info.get("stage") != "codebook" or not spans:
        return None
    return sum(spans) / len(spans)
