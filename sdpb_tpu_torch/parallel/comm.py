"""The process group of a multi-device solve and its collectives.

The JAX package drives every chip from one process and takes its
collectives from ``jax.lax`` inside ``shard_map`` (``psum``, ``pmax``,
``pmin``, ``all_gather``, ``psum_scatter``).  The port runs one process
(rank) per device over ``torch.distributed``; this module owns the
group, the rank's ``torch.device`` (explicit, never a global default)
and the collectives the solver uses:

- ``sum_int``: all-reduce SUM of int32 residues (exact whatever the
  order);
- ``max_`` / ``min_``: all-reduce MAX and MIN (float64 error norms,
  int32 column exponents and flags);
- ``all_gather``: a stacked copy of every rank's tensor, in rank order
  (the MP-valued sums add it up locally with a tree sum, as the JAX
  package does: a word-wise float all-reduce of MP words is not exact);
- ``broadcast`` and ``reduce_scatter_int`` (the row panels of
  ``dist_q``).

Backends: NCCL when each rank owns a GPU; gloo when ranks share a
device (CPU tensors, or several ranks on one card).  Gloo's collectives
on CUDA tensors are few, so under gloo a CUDA tensor goes through host
memory by ``stage_through_host``, always, and gloo's reduce-scatter is
an all-reduce and a slice (gloo has none).

A ``Comm`` without a group (``Comm.local``) is a world of one whose
collectives are the identity; a group of one rank (a world of one over
NCCL) still runs them.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib

import torch
import torch.distributed as dist

from ..utils import timers

#: seconds a collective waits for the other ranks before it fails
TIMEOUT_S = 900


def choose_backend(device: torch.device, ranks_per_host: int,
                   gpus_per_host: int) -> str:
    """NCCL when every rank of a host owns a GPU of its own, gloo when
    ranks share one (NCCL refuses two ranks on one GPU) or run on the
    CPU."""
    if device.type == "cuda" and ranks_per_host <= gpus_per_host:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Comm:
    """A rank of the group: its index, the world size, its device and
    the backend (None without a group)."""

    rank: int
    world: int
    device: torch.device
    backend: str | None = None

    @classmethod
    def local(cls, device) -> "Comm":
        return cls(rank=0, world=1, device=torch.device(device))

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def active(self) -> bool:
        return self.backend is not None

    # -- staging ---------------------------------------------------------

    def _run(self, fn, t):
        """Apply the in-place collective ``fn`` to a contiguous copy of
        ``t``, through host memory under gloo for CUDA tensors."""
        if self.backend == "gloo" and t.is_cuda:
            return stage_through_host(fn, t)
        buf = t.contiguous().clone()
        fn(buf)
        return buf

    # -- collectives -----------------------------------------------------

    def sum_int(self, t):
        """Exact all-reduce SUM of an integer tensor."""
        assert not t.is_floating_point(), t.dtype
        if not self.active:
            return t
        return self._run(lambda b: dist.all_reduce(b, dist.ReduceOp.SUM), t)

    def max_(self, t):
        if not self.active:
            return t
        return self._run(lambda b: dist.all_reduce(b, dist.ReduceOp.MAX), t)

    def min_(self, t):
        if not self.active:
            return t
        return self._run(lambda b: dist.all_reduce(b, dist.ReduceOp.MIN), t)

    def all_gather(self, t):
        """(world, *t.shape): every rank's tensor, in rank order."""
        if not self.active:
            return t[None]

        def gather(buf):
            parts = [torch.empty_like(buf) for _ in range(self.world)]
            dist.all_gather(parts, buf)
            return torch.stack(parts)

        if self.backend == "gloo" and t.is_cuda:
            return stage_through_host(gather, t, returns=True)
        return gather(t.contiguous())

    def broadcast(self, t, src: int):
        """``t`` of rank ``src`` on every rank (every rank passes a
        tensor of the same shape and dtype)."""
        if not self.active:
            return t
        return self._run(lambda b: dist.broadcast(b, src), t)

    def reduce_scatter_int(self, t):
        """Rank r's slice [r*n/D, (r+1)*n/D) of the SUM over ranks of
        the integer tensor ``t`` along axis 0 (n divisible by D)."""
        assert not t.is_floating_point(), t.dtype
        n = t.shape[0]
        assert n % self.world == 0, (n, self.world)
        rows = n // self.world
        if not self.active:
            return t
        if self.backend == "nccl":
            out = torch.empty((rows,) + t.shape[1:], dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, t.contiguous())
            return out
        total = self.sum_int(t)
        return total[self.rank * rows:(self.rank + 1) * rows].contiguous()

    # -- host decisions --------------------------------------------------

    def max_float(self, value: float) -> float:
        """The largest of every rank's host value."""
        if not self.active:
            return float(value)
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        return float(self.max_(t).cpu()[0])

    def any_(self, flag: bool) -> bool:
        return self.max_float(1.0 if flag else 0.0) > 0

    def check_replicated(self, t, what: str) -> None:
        """Raise unless ``t`` holds the same bytes on every rank: one
        64-bit checksum per rank, gathered."""
        if not self.active or self.world == 1:
            return
        timers.count("syncs", "comm.check_replicated")
        digest = hashlib.blake2b(t.detach().cpu().numpy().tobytes(),
                                 digest_size=8).digest()
        mine = torch.tensor([int.from_bytes(digest, "little", signed=True)],
                            dtype=torch.int64, device=self.device)
        sums = self.all_gather(mine).cpu().reshape(-1).tolist()
        if len(set(sums)) != 1:
            raise RuntimeError(
                f"{what}: the replicated value differs between ranks "
                f"(checksums by rank {sums})")

    def barrier(self) -> None:
        if self.active:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def stage_through_host(fn, t, returns: bool = False):
    """Run the gloo collective ``fn`` on a host copy of the CUDA tensor
    ``t`` and bring the result back to ``t``'s device: in place
    (``returns`` False) or ``fn``'s return value."""
    host = t.detach().to("cpu").contiguous().clone()
    out = fn(host)
    return (out if returns else host).to(t.device)


def init_process_group(rank: int, world: int, device, init_method: str,
                       backend: str | None = None,
                       timeout_s: float = TIMEOUT_S) -> Comm:
    """Join the group (``init_method`` env://, tcp://host:port or
    file://path) as ``rank`` of ``world`` on ``device``; ``backend``
    None takes NCCL for a CUDA device and gloo for the CPU."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return Comm(rank=rank, world=world, device=device, backend=backend)


def destroy(comm: Comm | None) -> None:
    if comm is not None and comm.active and dist.is_initialized():
        dist.destroy_process_group()
