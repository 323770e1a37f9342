"""The sharded kNN on the card: two ranks of a ``gloo`` group sharing
``cuda:0``, each launching kernel K1 on its block of the query rows,
against one process's search on the same card.

Every test needs a CUDA device and ``nvcc`` (the ``cuda`` marker) and skips
without one, deciding inside a fixture. The file imports no JAX:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_parallel_cuda.py``.

At 20,000 rows of D = 16 (the codebook stage's k = 20 + self, packed at
bins 1,024, query blocks of 8,192 rows, 4,096 a rank) each rank must launch K1,
and the gathered neighbours must equal one process's except at near-ties
(a differing neighbour within 1e-5 relative of the row's k-th distance; at
most 1e-3 of the rows), with the distances of equal rows identical.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_WORKER = r'''
import os, sys
import numpy as np
import torch
from vqvae_tpu_torch.ops.knn import knn_search
from vqvae_tpu_torch.ops.knn_select import fused_select
from vqvae_tpu_torch.parallel import init_distributed

mesh = init_distributed("gloo", device="cuda:0")
rng = np.random.default_rng(5)
centers = rng.normal(0, 3.0, size=(12, 16)).astype(np.float32)
z = centers[rng.integers(0, 12, size=20000)]
z = (z + rng.normal(0, 0.3, size=z.shape)).astype(np.float32)
fused_select.launches = 0
d, i = knn_search(z, 21, approx=True, query_tile=1024, query_block=8192,
                  device="cuda:0", mesh=mesh)
launches = fused_select.launches
d1, i1 = knn_search(z, 21, approx=True, query_tile=1024, query_block=8192,
                    device="cuda:0")
np.savez(os.path.join(sys.argv[1], f"rank{mesh.rank}.npz"), d=d, i=i,
         d1=d1, i1=i1, launches=launches)
'''


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (two ranks sharing the card)")
    return torch.device("cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, tmp: Path, timeout: float = 600):
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(tmp)], env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > t_end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, p in enumerate(procs):
        out = p.communicate()[0]
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"


@pytest.mark.cuda
def test_two_ranks_on_one_card_shard_k1(cuda_device, tmp_path):
    _launch(2, tmp_path)
    for rank in range(2):
        res = np.load(tmp_path / f"rank{rank}.npz")
        assert int(res["launches"]) > 0  # this rank ran K1 on its block
        i, d, i1, d1 = res["i"], res["d"], res["i1"], res["d1"]
        differ = np.nonzero((i != i1).any(1))[0]
        assert len(differ) <= 1e-3 * len(i)
        for r in differ:
            kth = max(float(d[r, -1]), float(d1[r, -1]))
            for c in set(i[r]) ^ set(i1[r]):
                src_i, src_d = (i, d) if c in set(i[r]) else (i1, d1)
                val = float(src_d[r][src_i[r] == c][0])
                assert abs(val - kth) <= 1e-5 * kth, (r, c, val, kth)
        same = np.setdiff1d(np.arange(len(i)), differ)
        np.testing.assert_array_equal(d[same], d1[same])


@pytest.mark.cuda
def test_nccl_refuses_more_ranks_than_cards(cuda_device, monkeypatch):
    """No backend is swapped: NCCL with more local ranks than cards raises
    before any group is started."""
    import torch.distributed as dist

    from vqvae_tpu_torch.parallel import init_distributed

    world = torch.cuda.device_count() + 1
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="one card per rank"):
        init_distributed("nccl")
    assert not dist.is_initialized()
