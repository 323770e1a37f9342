"""Mean seconds of the build's ``csr`` step over the window's builds: the
native assembly of the symmetric CSR graph from the edge list
(``symmetric_csr_from_edges``). It is one of the four parts of the CSR +
LCC step, from ``build_codebook_main``'s own span (``timings_s`` in the
``codebook.npz`` it writes). The four parts share the clock readings at
their boundaries, so they add up to ``codebook.lcc_s``. Nothing from a
program whose builds do not time the part."""


def read(trace, info):
    spans = [t["csr"] for t in info.get("timings", [])
             if "csr" in t]
    if info.get("stage") != "codebook" or not spans:
        return None
    return sum(spans) / len(spans)
