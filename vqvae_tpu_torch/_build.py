"""Build-at-first-use for the port's native sources (host C++ and CUDA).

Each source compiles into a plain-C shared library under ``_build/`` next
to this file (a directory ``.gitignore`` lists), named by a hash of the
source and the compile command, so an edited source rebuilds and
concurrent processes never load a half-written file (each writes its own
temporary file and renames it into place).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"


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
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


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
