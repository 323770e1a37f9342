"""Device mesh over a ``torch.distributed`` process group — the port of
``vqvae_tpu/parallel/mesh.py``.

The JAX package runs one program over a mesh of local chips (multi-host
through ``jax.distributed``). The PyTorch idiom for the same thing is one
process per card, started by ``torchrun``, joined in a process group; the
port uses it for one host and for many alike. A ``Mesh`` names this
process's place in the group, and the ``data`` axis plays the same two
roles as in JAX:

- the batch axis of the three training engines (data parallelism: each
  rank takes its ``shard_range`` of every global batch, losses are
  normalized by global counts, gradients are summed over ranks);
- the work axis of the codebook kernels: kNN query blocks, Riemannian
  edge chunks, the source (K) axis of the ELL relaxation and the k-means||
  round state.

Without a process group ``get_mesh()`` is the world-size-1 mesh and every
helper is the identity, so single-process code is unchanged. Collectives
are explicit (``all_gather_rows``, ``all_reduce_sum``,
``all_reduce_min_argmin``, ...) where JAX's GSPMD inserts them.

Under ``gloo`` a collective takes host tensors: the helpers copy a CUDA
tensor to the host and back explicitly for that backend (counted in
``HOST_COPIES``). That is gloo's transport; the computation stays on the
card. ``nccl`` takes the CUDA tensors as they are.

Two JAX helpers have no counterpart here. ``run_on_cpu`` compiled
parameter initialization on the local CPU to dodge the TPU's remote
compiles; PyTorch compiles nothing at init. ``data_sharding``,
``replicated_sharding`` and ``source_sharding`` describe array placement
for GSPMD; with one process per card, ``shard_range`` and the explicit
collectives take their place.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"

# host round trips of CUDA tensors under gloo: calls and bytes each way
HOST_COPIES = {"calls": 0, "bytes": 0}


@dataclass(frozen=True)
class Mesh:
    """This process's place on the 1-D ``data`` mesh. ``group`` is None
    for the world-size-1 mesh of a process without a process group."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        """True when collectives run (a process group, of any size)."""
        return self.group is not None

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.group is not None \
            else None


def _rank_device() -> torch.device:
    """The card of this rank (``LOCAL_RANK``), or the CPU on a host
    without one. It names where this rank computes by default; entry
    points still resolve their device through ``device.resolve_device``,
    which never picks the CPU by itself."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def get_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the process group; without a group, the
    world-size-1 mesh. ``n_devices=1`` asks for this process alone (no
    collectives); any other ``n_devices`` must equal the world size."""
    if not dist.is_available() or not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"get_mesh({n_devices}): no process group is up (start the "
                f"ranks with torchrun and call init_distributed())")
        return Mesh(None, 0, 1, _rank_device())
    world = dist.get_world_size()
    if n_devices == 1 and world > 1:
        return Mesh(None, 0, 1, _rank_device())
    if n_devices not in (None, world):
        raise ValueError(f"get_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), world, _rank_device())


def init_distributed(backend: Optional[str] = None,
                     device=None) -> Mesh:
    """Join the process group ``torchrun`` describes; returns the mesh.

    Starts only when ``WORLD_SIZE`` and ``RANK`` are in the environment
    (opt-in, as JAX's ``maybe_init_distributed``), reads ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``), and is idempotent. ``backend``:
    ``None`` means ``nccl`` when the rank computes on a card (``device``
    not the CPU) and ``gloo`` otherwise; ``"gloo"`` may be named to put
    several ranks on one card. NCCL needs a card per rank: more local
    ranks than visible cards raise here, and no backend is swapped.
    """
    if dist.is_initialized():
        return get_mesh()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return get_mesh()
    world = int(os.environ["WORLD_SIZE"])
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu or not torch.cuda.is_available() \
            else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown process-group backend {backend!r}")
    if backend == "nccl":
        if on_cpu or not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA devices; ask for "
                               "'gloo' to run the ranks on the CPU")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_cards = torch.cuda.device_count()
        if local_world > n_cards:
            raise RuntimeError(
                f"backend 'nccl' needs one card per rank, but {local_world} "
                f"ranks share {n_cards} visible card(s) on this host; ask "
                f"for backend 'gloo' to put several ranks on one card")
        dev = (torch.device(device) if device is not None
               and torch.device(device).index is not None
               else _rank_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=world,
                            rank=int(os.environ["RANK"]))
    return get_mesh()


def is_primary() -> bool:
    """True on the process that writes artifacts, checkpoints, metrics and
    logs: rank 0 of the group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def local_device_count() -> int:
    """Cards visible to this process (1 on a host without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_range(n: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(start, stop) of this rank's contiguous block of a leading axis of
    ``n`` rows: the rows JAX's ``data_sharding`` puts on device ``rank``
    once the axis is padded to a multiple of the world size (the last
    blocks may be short or empty)."""
    if mesh is None or mesh.world_size == 1:
        return 0, n
    per = pad_to_multiple(n, mesh.world_size) // mesh.world_size
    start = min(mesh.rank * per, n)
    return start, min(start + per, n)


def shard_slice(n: int, mesh: Optional[Mesh]) -> slice:
    """``shard_range`` as a slice: this rank's rows of a global batch."""
    return slice(*shard_range(n, mesh))


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.group)


# -- collectives ---------------------------------------------------------------

def _to_transport(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of ``t`` where the backend takes it: gloo gets a host copy
    of a CUDA tensor (counted), nccl a host tensor on the rank's card
    (small bookkeeping scalars), else a clone."""
    backend = mesh.backend
    if t.is_cuda and backend == "gloo":
        HOST_COPIES["calls"] += 1
        HOST_COPIES["bytes"] += t.numel() * t.element_size()
        return t.detach().cpu()
    if not t.is_cuda and backend == "nccl":
        return t.detach().to(torch.device("cuda",
                                          torch.cuda.current_device()))
    return t.detach().clone()


def agree_any(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank when ``flag`` is true on any: a decision that
    depends on the host (its cores, its clock) taken alike by every rank,
    so no rank enters a collective the others skip."""
    if mesh is None or not mesh.distributed:
        return bool(flag)
    return bool(all_reduce(torch.tensor([int(bool(flag))]), mesh, "max")[0])


def all_reduce(t: torch.Tensor, mesh: Optional[Mesh],
               op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over ranks (``op`` sum, max or min)."""
    if mesh is None or not mesh.distributed:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    buf = _to_transport(t, mesh)
    dist.all_reduce(buf, op=red, group=mesh.group)
    return buf.to(t.device)


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return all_reduce(t, mesh, "sum")


def all_gather_rows(t: torch.Tensor, n: int,
                    mesh: Optional[Mesh]) -> torch.Tensor:
    """The (n, ...) tensor whose rows ``shard_range(n, mesh)`` this rank
    holds in ``t``, gathered from every rank in rank order."""
    if mesh is None or not mesh.distributed:
        return t
    per = pad_to_multiple(n, mesh.world_size) // mesh.world_size
    buf = _to_transport(t, mesh)
    if buf.shape[0] < per:
        buf = torch.cat([buf, buf.new_zeros((per - buf.shape[0],
                                             *buf.shape[1:]))])
    parts = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(parts, buf.contiguous(), group=mesh.group)
    return torch.cat(parts)[:n].to(t.device)


def _sortable(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 whose order is the floats' order (NaN excepted)."""
    b = v.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _unsortable(k: torch.Tensor) -> torch.Tensor:
    b = torch.where(k >= 0, k, k ^ 0x7FFFFFFF)
    return b.to(torch.int32).view(torch.float32)


def all_reduce_min_argmin(values: torch.Tensor, index: torch.Tensor,
                          mesh: Optional[Mesh]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per element, the minimum of float32 ``values`` over ranks and the
    global ``index`` (int, 0 <= index < 2**31) that came with it; among
    equal minima the lowest index wins, as ``jnp.argmin`` over the
    unsharded axis takes the first. One all-reduce of a packed int64 key
    (the value's order-preserving bits above the index)."""
    if mesh is None or not mesh.distributed:
        return values, index
    key = (_sortable(values) << 32) | index.to(torch.int64)
    key = all_reduce(key, mesh, "min")
    return _unsortable(key >> 32), (key & 0xFFFFFFFF).to(index.dtype)


def global_value(local: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``local`` over ranks as a value, with the gradient of
    this rank's term only: a loss built from it has the global value on
    every rank, and its gradient here is this rank's share of the global
    gradient, so summing the ranks' parameter gradients gives the
    gradient of the global loss (nonlinear terms such as ``|kl - C|``
    included)."""
    if mesh is None or not mesh.distributed:
        return local
    return local + (all_reduce(local.detach(), mesh, "sum")
                    - local.detach())


def sum_gradients(params, mesh: Optional[Mesh]) -> None:
    """Sum every parameter's ``.grad`` over ranks (one collective on the
    flattened gradients); a missing gradient counts as zeros."""
    if mesh is None or not mesh.distributed:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, "sum")
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n
