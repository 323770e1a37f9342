"""``utils/npz.save_csr_npz`` against ``scipy.sparse.save_npz``.

Each case writes a CSR matrix both ways and holds the threaded writer's
archive to scipy's: ``sparse.load_npz`` gives back the input, ``zipfile``
finds every CRC right, the member names and each member's bytes are
``save_npz``'s, and the compressed size is within 0.5 % of ``save_npz``'s
once the 20 bytes a member of ZIP64 fields that ``savez`` always writes
are added to ours. A member of one piece deflates to ``save_npz``'s very
bytes. The empty and one-piece graphs fit one piece a member; the others
are cut into small pieces, so the pool compresses several a member (at
16 KiB the primed window reaches back into the ``.npy`` header).
"""
import os
import zipfile

import numpy as np
import pytest
from scipy import sparse

from vqvae_tpu_torch.utils import npz


def _graph(n, k, data_dtype, index_dtype, array=False):
    """A symmetric kNN-like graph: ``k`` random neighbours a node, sorted
    columns, float lengths."""
    rng = np.random.default_rng(n * k)
    rows = np.repeat(np.arange(n), k)
    cols = (rows + rng.integers(1, n // 4 + 2, rows.size)) % n
    w = sparse.csr_matrix((rng.random(rows.size, np.float32) + 0.1,
                           (rows, cols)), shape=(n, n))
    w = w.maximum(w.T).tocsr()
    w.sort_indices()
    out = (sparse.csr_array if array else sparse.csr_matrix)(w)
    out.data = w.data.astype(data_dtype)
    # set after construction: scipy narrows int64 indices that fit int32
    out.indices = w.indices.astype(index_dtype)
    out.indptr = w.indptr.astype(index_dtype)
    return out


CASES = {
    "empty": (lambda: sparse.csr_matrix((7, 7), dtype=np.float32), None),
    "one_piece": (lambda: _graph(300, 6, np.float32, np.int32), None),
    **{f"pieces_{np.dtype(d).name}_{np.dtype(i).name}":
       ((lambda d=d, i=i: _graph(3000, 10, d, i)), 1 << 16)
       for d in (np.float32, np.float64) for i in (np.int32, np.int64)},
    "pieces_window_in_header": (
        lambda: _graph(3000, 10, np.float32, np.int32), 1 << 14),
    "pieces_csr_array": (
        lambda: _graph(3000, 10, np.float32, np.int32, array=True), 1 << 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_save_csr_npz_writes_save_npzs_archive(case, tmp_path, monkeypatch):
    make, chunk = CASES[case]
    if chunk is not None:
        monkeypatch.setattr(npz, "CHUNK", chunk)
    chunk = npz.CHUNK
    W = make()
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    pieces = npz.save_csr_npz(ours, W)
    sparse.save_npz(theirs, W)

    back, want = sparse.load_npz(ours), sparse.load_npz(theirs)
    assert type(back) is type(W) and back.shape == W.shape
    assert back.dtype == W.dtype and back.indices.dtype == want.indices.dtype
    assert np.array_equal(back.indptr, W.indptr)
    assert np.array_equal(back.indices, W.indices)
    assert np.array_equal(back.data, W.data)
    with np.load(ours) as f:
        assert f["indices"].dtype == W.indices.dtype
        assert f["data"].dtype == W.data.dtype

    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.testzip() is None
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
        infos = a.infolist()
        assert {i.compress_type for i in infos} == {zipfile.ZIP_DEFLATED}
        for i, j in zip(infos, b.infolist()):
            if i.file_size <= chunk:
                assert i.compress_size == j.compress_size, i.filename
    zip64 = 20 * len(infos)  # savez's extra field in each local header
    ratio = (os.path.getsize(ours) + zip64) / os.path.getsize(theirs)
    assert abs(ratio - 1) <= 0.005, ratio

    per_member = [-(-i.file_size // chunk) for i in infos]
    assert pieces == sum(per_member)
    assert max(per_member) == 1 if CASES[case][1] is None else \
        max(per_member) > 2


def test_save_csr_npz_takes_only_csr(tmp_path):
    with pytest.raises(ValueError, match="CSR"):
        npz.save_csr_npz(tmp_path / "g.npz", sparse.eye(3, format="csc"))


def test_save_csr_npz_leaves_zip64_sizes_to_save_npz(tmp_path, monkeypatch):
    monkeypatch.setattr(npz, "_ZIP32", 1 << 16)  # as if past 4 GiB
    W = _graph(3000, 10, np.float32, np.int32)
    assert npz.save_csr_npz(tmp_path / "ours.npz", W) == 0
    sparse.save_npz(tmp_path / "theirs.npz", W)
    with zipfile.ZipFile(tmp_path / "ours.npz") as a, \
            zipfile.ZipFile(tmp_path / "theirs.npz") as b:
        assert [(i.filename, i.file_size, i.compress_size, i.CRC)
                for i in a.infolist()] == \
            [(i.filename, i.file_size, i.compress_size, i.CRC)
             for i in b.infolist()]
    assert os.path.getsize(tmp_path / "ours.npz") == \
        os.path.getsize(tmp_path / "theirs.npz")
