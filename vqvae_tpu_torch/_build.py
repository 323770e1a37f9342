"""Build-at-first-use for the port's native sources (host C++ and CUDA).

Each source compiles into a plain-C shared library under ``_build/`` next
to this file (a directory ``.gitignore`` lists), named by a hash of the
source and the compile command, so an edited source rebuilds and
concurrent processes never load a half-written file (each writes its own
temporary file and renames it into place). ``load_library`` builds a
source, loads it once per process and binds its C functions with ctypes;
``load_cuda_library`` does so for a kernel source under ``csrc/`` with
nvcc for sm_90a.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# Hopper only; -Xptxas -v reports registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (argtypes, restype) of a library's C functions
Signatures = Dict[str, Tuple[Sequence[type], Optional[type]]]
_libs: Dict[Path, ctypes.CDLL] = {}
# called with the seconds of each real build (``utils.profiling.CompileStats``)
BUILD_LISTENERS: List[Callable[[float], None]] = []


def compile_shared(src: Path, cmd: Sequence[str]) -> Tuple[Path, str]:
    """Compile ``src`` with ``cmd + ["-o", out, src]`` unless a library
    built from the same bytes and command exists; returns (path, compiler
    output, empty when the cached library was reused)."""
    src = Path(src)
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(cmd).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    for listener in BUILD_LISTENERS:
        listener(seconds)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels are built from source at first use")


def load_library(src: Path, cmd: Sequence[str], signatures: Signatures
                 ) -> Tuple[ctypes.CDLL, str]:
    """(library, compiler output) of ``src`` built with ``cmd``: built at
    first use (the output is empty when a built library was reused) and
    loaded once per process, with ``signatures`` bound."""
    lib = _libs.get(src)
    if lib is not None:
        return lib, ""
    path, log = compile_shared(src, cmd)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return _libs.setdefault(src, lib), log


def load_cuda_library(source: str, signatures: Signatures
                      ) -> Tuple[ctypes.CDLL, str]:
    """``load_library`` for ``csrc/<source>`` with nvcc for sm_90a."""
    return load_library(CSRC_DIR / source, [nvcc_path(), *NVCC_FLAGS],
                        signatures)
