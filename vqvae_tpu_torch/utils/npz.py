"""A CSR matrix's ``.npz`` with its deflate spread over the host's threads.

``save_csr_npz(path, W)`` writes the archive that ``scipy.sparse.save_npz(
path, W)`` writes: the same members under the same names, each member the
same ``.npy`` bytes (``np.lib.format``'s header, then the array), stored
with deflate at zlib level 6 (``zipfile``'s default) and its CRC-32, so
``sparse.load_npz``, ``np.load`` and ``zipfile`` read it as theirs.
``save_npz`` deflates on one thread. Here each member is cut into pieces of
``CHUNK`` bytes, and a thread pool compresses them as raw deflate (zlib
releases the interpreter lock), each piece primed with the 32 KiB before
it and ended by a sync flush, the member's last by a finish, so the pieces
join into one deflate stream (pigz's scheme). The compressed size stays
within a few bytes a piece of ``save_npz``'s (``savez`` adds 20 bytes a
member of ZIP64 fields that this archive, which never needs them, leaves
out).

An archive that would need ZIP64 (4 GiB) goes to ``sparse.save_npz``
unchanged.
"""
from __future__ import annotations

import io
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
from scipy import sparse

from ..native import _threads

CHUNK = 1 << 20  # bytes of a member that one task compresses
_WINDOW = 1 << 15  # deflate's window: the most a piece refers back
_LEVEL = 6
_ZIP32 = 0xFFFFFFFF  # sizes and offsets past this need ZIP64
_VERSION = 20  # the ZIP version that deflate needs
_UNIX, _MODE = 3, 0o600 << 16  # as zipfile writes a member opened by name


def _members(W) -> Dict[str, np.ndarray]:
    """The arrays ``sparse.save_npz`` stores for a CSR matrix, in its
    order."""
    members = {"indices": W.indices, "indptr": W.indptr,
               "format": W.format.encode("ascii"), "shape": W.shape,
               "data": W.data}
    if isinstance(W, getattr(sparse, "sparray", ())):
        members["_is_array"] = True
    return {name: np.asanyarray(a) for name, a in members.items()}


class _Npy:
    """One member's ``.npy`` bytes: the header, then the array's bytes, read
    in place."""

    def __init__(self, a: np.ndarray):
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        buf = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            buf, np.lib.format.header_data_from_array_1_0(a))
        self.header = buf.getvalue()
        self.body = memoryview(a.reshape(-1).view(np.uint8))
        self.size = len(self.header) + len(self.body)

    def span(self, start: int, end: int):
        """The bytes ``[start, end)``."""
        h = len(self.header)
        if start >= h:
            return self.body[start - h:end - h]
        return self.header[start:end] + bytes(self.body[:max(end - h, 0)])

    def crc32(self) -> int:
        return zlib.crc32(self.body, zlib.crc32(self.header))


def _deflate(npy: _Npy, start: int) -> bytes:
    """Raw deflate of the piece at ``start``, primed with the bytes before
    it and flushed so that the next piece's stream follows on."""
    end = min(start + CHUNK, npy.size)
    prime = ({"zdict": npy.span(max(start - _WINDOW, 0), start)} if start
             else {})
    z = zlib.compressobj(_LEVEL, zlib.DEFLATED, -15, **prime)
    out = z.compress(npy.span(start, end))
    return out + z.flush(zlib.Z_FINISH if end == npy.size
                         else zlib.Z_SYNC_FLUSH)


def save_csr_npz(path, W) -> int:
    """Write the CSR matrix ``W`` as ``sparse.save_npz(path, W)`` does (see
    the module's notes). Returns the number of pieces the pool compressed,
    0 where it fell back to ``save_npz``."""
    if W.format != "csr":
        raise ValueError(f"expected a CSR matrix, got {W.format}")
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    members = {f"{name}.npy": _Npy(a) for name, a in _members(W).items()}
    total = sum(m.size for m in members.values())
    # deflate grows incompressible bytes by well under 1/256
    if total + (total >> 8) + (1 << 16) >= _ZIP32:
        sparse.save_npz(path, W)
        return 0
    t = time.localtime()
    dos = (t.tm_hour << 11 | t.tm_min << 5 | t.tm_sec // 2,
           (t.tm_year - 1980) << 9 | t.tm_mon << 5 | t.tm_mday)
    pieces = sum(-(-m.size // CHUNK) for m in members.values())
    with ThreadPoolExecutor(max(1, min(_threads(), pieces))) as pool:
        jobs = {name: [pool.submit(_deflate, m, a)
                       for a in range(0, m.size, CHUNK)]
                for name, m in members.items()}
        crcs = {name: m.crc32() for name, m in members.items()}
        central = []
        with open(path, "wb") as f:
            for name, m in members.items():
                data = [job.result() for job in jobs[name]]
                entry = struct.pack(
                    "<HHHHLLL", 0, 8, *dos, crcs[name], sum(map(len, data)),
                    m.size)
                offset = f.tell()
                f.write(struct.pack("<4sBB", b"PK\x03\x04", _VERSION, 0)
                        + entry + struct.pack("<HH", len(name), 0)
                        + name.encode())
                f.writelines(data)
                central.append(
                    struct.pack("<4sBBBB", b"PK\x01\x02", _VERSION, _UNIX,
                                _VERSION, 0) + entry
                    + struct.pack("<HHHHHLL", len(name), 0, 0, 0, 0, _MODE,
                                  offset) + name.encode())
            start = f.tell()
            f.writelines(central)
            f.write(struct.pack("<4sHHHHLLH", b"PK\x05\x06", 0, 0,
                                len(central), len(central), f.tell() - start,
                                start, 0))
    return pieces
