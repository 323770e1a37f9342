"""The ctypes bindings of the port's CUDA sources, checked on the host.

Each ops module declares the C functions of its kernel source and their
ctypes signatures; ``_build.load_cuda_library`` binds them after nvcc has
built the source on the card. Here, without nvcc, the declarations are
held against the ``extern "C"`` block of each source: the same functions,
the same number of arguments, and matching types.
"""
import ctypes
import importlib
import re

import pytest

from vqvae_tpu_torch._build import CSRC_DIR, NVCC_FLAGS

_C_TYPES = {"int": ctypes.c_int, "void*": ctypes.c_void_p,
            "const void*": ctypes.c_void_p, "const char*": ctypes.c_char_p}


def _c_functions(source: str):
    """name -> (argument types, return type) of the ``extern "C"`` block."""
    text = (CSRC_DIR / source).read_text()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    found = {}
    for ret, name, args in re.findall(
            r"^((?:const )?\w+\*?) (\w+)\(([^)]*)\)", block, re.M):
        types = [re.sub(r"\s*\w+$", "", a.strip()) for a in args.split(",")]
        found[name] = ([_C_TYPES[t] for t in types], _C_TYPES[ret])
    return found


@pytest.mark.parametrize("module,source", [
    ("knn_select", "knn_select.cu"),
    ("assign", "assign.cu"),
    ("gather_min", "gather_min.cu"),
])
def test_signatures_match_the_source(module, source):
    mod = importlib.import_module(f"vqvae_tpu_torch.ops.{module}")
    declared = {name: (list(args), ret)
                for name, (args, ret) in mod._SIGNATURES.items()}
    assert declared == _c_functions(source)


def test_kernels_build_for_hopper_only():
    flags = list(NVCC_FLAGS)
    assert flags[flags.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert flags.count("-gencode") == 1


def test_native_signatures_match_the_source():
    """The host library's declarations (``native._SIGNATURES``) against
    the ``extern "C"`` block of ``native/graph_core.cpp``."""
    from vqvae_tpu_torch import native

    ptr = ctypes.POINTER
    types = {"int64_t*": ptr(ctypes.c_int64), "int32_t*": ptr(ctypes.c_int32),
             "float*": ptr(ctypes.c_float), "int64_t": ctypes.c_int64,
             "int": ctypes.c_int, "void": None}
    text = native._SRC.read_text()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    found = {}
    for ret, name, args in re.findall(r"^(\w+) (vq_\w+)\(([^)]*)\)", block,
                                      re.M):
        arg_types = [re.sub(r"^const ", "", re.sub(r"\s*\w+$", "", a.strip()))
                     .replace(" ", "") for a in args.split(",")]
        found[name] = ([types[t] for t in arg_types], types[ret])
    declared = {name: (list(args), ret)
                for name, (args, ret) in native._SIGNATURES.items()}
    assert declared == found
    assert {"vq_dijkstra_multi_source_pred", "vq_knn_exact"} <= set(found)
