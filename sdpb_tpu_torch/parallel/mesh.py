"""Block-sharded solves: every rank holds its share of each bucket's
blocks, and Q, dy, y and the scalars replicated.

The PyTorch counterpart of the JAX package's ``parallel/mesh.py``,
written for one process per device.  Where the JAX package runs each
phase under ``shard_map`` over a mesh axis, each rank here runs the
phase functions of ``solver/bucket_iteration.py`` on its own blocks;
they read the group and the masks from the MeshProblem and cross the
ranks where they reduce (see there).  This module shards:

- buckets are padded to a multiple of the world size with phantom
  blocks (c = B = 0, the bilinear bases of a real block so that their
  Cholesky factors stay positive definite, mask 0).  Phantoms never
  move (their dx, dX, dY are masked to zero) and are left out of every
  reduction.  With costs, each bucket's blocks are placed by the LPT
  permutation of ``solver/placement.py::bucket_device_permutation``;
- the Q reduction (``reduce_q_cholesky``) is the exact int32 all-reduce
  of each rank's per-prime residues, each rank's sum reduced mod p
  first (so the sum over ranks stays far below 2^31); every rank then
  restores Q and factors it with the same kernels, or, from
  ``DIST_Q_MIN_N`` up or when Q would crowd a device, reduce-scatters
  the residues and factors Q by row panels (``parallel/dist_q.py``).

Every replicated value is computed from the same bytes on every rank by
the same kernels, so the ranks agree bit for bit and take the same
branches; the driver checks ``y`` once an iteration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mp import core as mp
from ..mp import linalg as la
from ..solver import bucket_iteration as bi
from ..solver.data import BucketedProblem, BucketedState, SDPBucket
from .comm import Comm

#: dual dimensions from this one up always take the row-panel Q
#: (``dist_q``); below it the memory estimate decides
#: (``should_distribute_q``).  Tests lower it.
DIST_Q_MIN_N = 2048

#: share of a device's memory that the replicated Q working set (Q,
#: L_Q and the restore's temporaries, about 6 N^2 MP values) may take
#: before Q is distributed
DIST_Q_MEM_FRACTION = 0.10


@dataclasses.dataclass
class MeshProblem(BucketedProblem):
    """This rank's share of a BucketedProblem sharded over the ranks of
    ``comm``: each bucket holds this rank's slots (phantoms included,
    ``block_indices`` -1 there), ``masks`` is 1 on a real slot and 0 on
    a phantom, ``slots[i]`` is bucket i's global slot array (the bucket
    position of each padded slot, -1 for a phantom) and ``n_valid[i]``
    its real block count."""

    comm: Comm = None
    masks: list = None
    slots: list = None
    n_valid: list = None
    distribute_q: bool | None = None   # decided at the first Q

    @property
    def bucket_sizes(self) -> list:
        return self.n_valid


def bucket_slots(nb: int, n_dev: int, costs=None) -> np.ndarray:
    """The padded slot array of a bucket of ``nb`` blocks over
    ``n_dev`` ranks, as the JAX package's ``shard_problem`` places it:
    the LPT permutation when costs are given and the bucket has more
    blocks than ranks (unless it is the identity), else the blocks in
    order followed by phantoms."""
    from ..solver.placement import bucket_device_permutation

    if costs is not None and nb > n_dev:
        slots, _ = bucket_device_permutation(costs, n_dev)
        if not np.array_equal(slots[slots >= 0], np.arange(nb)):
            return slots
    pad = (-nb) % n_dev
    return np.concatenate([np.arange(nb), np.full(pad, -1)]).astype(np.int64)


def _local(slots, comm: Comm):
    per = len(slots) // comm.world
    return slots[comm.rank * per:(comm.rank + 1) * per]


def _take(arr, slots, zero_phantoms: bool, device):
    """Rows of ``arr`` at ``slots`` (phantoms: a copy of the first
    block, or zeros), on ``device``."""
    idx = torch.as_tensor(np.where(slots >= 0, slots, 0), device=arr.device)
    out = arr.index_select(0, idx)
    if zero_phantoms:
        keep = torch.as_tensor(slots >= 0, device=arr.device)
        out = bi.mask_blocks(out, keep)
    return out.to(device)


def shard_problem(problem: BucketedProblem, comm: Comm,
                  costs=None) -> MeshProblem:
    """This rank's share of ``problem`` (on any device) on
    ``comm.device``.  ``costs``: per-bucket lists of per-block costs
    (``placement.read_block_costs``), for the LPT placement."""
    dev = comm.device
    buckets, masks, all_slots = [], [], []
    for i, bk in enumerate(problem.buckets):
        slots = bucket_slots(bk.nb, comm.world,
                             None if costs is None else costs[i])
        comm.check_replicated(torch.as_tensor(slots),
                              f"bucket {i}'s placement")
        mine = _local(slots, comm)
        data = SDPBucket(
            c=_take(bk.c, mine, True, dev), B=_take(bk.B, mine, True, dev),
            q=tuple(_take(q, mine, False, dev) for q in bk.q),
            u=tuple(_take(u, mine, False, dev) for u in bk.u),
            shape=bk.shape,
            block_indices=tuple(bk.block_indices[s] if s >= 0 else -1
                                for s in mine))
        buckets.append(data)
        masks.append(torch.as_tensor((mine >= 0).astype(np.float64),
                                     dtype=problem.b.dtype, device=dev))
        all_slots.append(slots)
    return MeshProblem(
        objective_const=problem.objective_const.to(dev),
        b=problem.b.to(dev), buckets=buckets, comm=comm, masks=masks,
        slots=all_slots, n_valid=[bk.nb for bk in problem.buckets])


def shard_state(state: BucketedState, mproblem: MeshProblem
                ) -> BucketedState:
    """This rank's share of a BucketedState in block order (a
    checkpoint of any world size); phantom slots get a copy of the
    bucket's first block (positive definite, frozen by the mask)."""
    dev = mproblem.comm.device
    x, X, Y = [], [], []
    for i, slots in enumerate(mproblem.slots):
        mine = _local(slots, mproblem.comm)
        x.append(_take(state.x[i], mine, False, dev))
        X.append(tuple(_take(state.X[i][p], mine, False, dev)
                       for p in range(2)))
        Y.append(tuple(_take(state.Y[i][p], mine, False, dev)
                       for p in range(2)))
    return BucketedState(x=x, y=state.y.to(dev), X=X, Y=Y)


def unshard_state(mstate: BucketedState, mproblem: MeshProblem,
                  device="cpu") -> BucketedState:
    """Every rank's blocks gathered, in block order, without phantoms,
    on ``device`` (for checkpoints and solutions); collective."""
    from .multihost import replicate

    comm = mproblem.comm
    x, X, Y = [], [], []
    for i, slots in enumerate(mproblem.slots):
        pos = np.nonzero(slots >= 0)[0]
        inv = np.empty(mproblem.n_valid[i], dtype=np.int64)
        inv[slots[pos]] = pos

        def take(a):
            full = replicate(comm, a)
            return full.index_select(
                0, torch.as_tensor(inv, device=full.device)).to(device)

        x.append(take(mstate.x[i]))
        X.append(tuple(take(mstate.X[i][p]) for p in range(2)))
        Y.append(tuple(take(mstate.Y[i][p]) for p in range(2)))
    return BucketedState(x=x, y=mstate.y.to(device), X=X, Y=Y)


def should_distribute_q(problem: MeshProblem) -> bool:
    """Distribute Q by row panels from DIST_Q_MIN_N up, or when the
    replicated working set would take more than DIST_Q_MEM_FRACTION of
    a rank's device (the reference always distributes Q,
    `initialize_schur_complement_solver.cxx:95-104`).  The ranks agree:
    the memory test is all-reduced."""
    n = problem.dual_dim
    if n >= DIST_Q_MIN_N:
        return True
    comm = problem.comm
    if comm.world < 2:
        return False
    from ..solver.memory import detect_device_memory

    item = 4 if problem.dtype == torch.float32 else 8
    q_bytes = 6 * n * n * problem.k * item
    mem = detect_device_memory(comm.device) or 0
    return comm.any_(bool(mem) and q_bytes > DIST_Q_MEM_FRACTION * mem)


@dataclasses.dataclass
class DistLQ:
    """Row panels of the lower Cholesky factor of the padded Q."""

    l_local: torch.Tensor     # (rows_loc, N1, K): this rank's rows
    comm: Comm
    n: int                    # the unpadded dual dimension

    def solve(self, rhs):
        """Q^-1 rhs, replicated."""
        from . import dist_q

        return dist_q.dist_cholesky_solve(self.comm, self.l_local, rhs,
                                          self.n)

    def condition(self) -> float:
        """(max diag / min diag)^2 of the factor, over every rank."""
        comm, rl = self.comm, self.l_local.shape[0]
        r0 = comm.rank * rl
        d = mp.fst(la.diag(self.l_local[:, r0:r0 + rl]))
        d = d[:max(0, self.n - r0)].to(torch.float64)
        ext = torch.stack([d.amax(), -d.amin()]) if d.numel() else \
            torch.tensor([0.0, float("-inf")], dtype=torch.float64,
                         device=d.device)
        ext = comm.max_(ext.to(comm.device)).cpu()
        return float((ext[0] / -ext[1]) ** 2)


def reduce_q_cholesky(problem: MeshProblem, q_sum, d_sum, e_col, finite,
                      plan):
    """L_Q from this rank's summed residues: each rank's sums reduced
    mod p (so that the sum over ranks stays < 2^31), then an int32
    all-reduce and every rank restoring and factoring Q, or a
    reduce-scatter and the row-panel factor (a DistLQ)."""
    from ..ops import mpmm

    comm = problem.comm
    q_sum = mpmm.reduce_residues_mod(q_sum, plan)
    d_sum = mpmm.reduce_residues_mod(d_sum, plan)
    if problem.distribute_q is None:
        # once, so that a later iteration's free memory cannot change it
        problem.distribute_q = should_distribute_q(problem)
    if problem.distribute_q:
        from . import dist_q

        l_loc = dist_q.restore_cholesky(comm, q_sum, e_col, finite, plan,
                                        problem.k, problem.dtype)
        return DistLQ(l_local=l_loc, comm=comm, n=problem.dual_dim)
    n = q_sum.shape[-1]
    both = comm.sum_int(torch.cat([q_sum.reshape(q_sum.shape[0], -1),
                                   d_sum], dim=1))
    return bi.restore_q_cholesky(both[:, :n * n].reshape(q_sum.shape),
                                 both[:, n * n:], e_col, finite, plan,
                                 problem.k, problem.dtype)
