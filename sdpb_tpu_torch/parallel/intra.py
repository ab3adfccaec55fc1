"""One PSD block sharded by rows over every rank: its dense MP linear
algebra as row-panel collectives.

The PyTorch counterpart of the JAX package's ``parallel/intra.py``.
The reference gives a block too large for one rank to a group of ranks
with a 2-D block-cyclic grid (`Block_Map.hxx:8-14`,
`sdpb/solve.cxx:31`); here the block's rows are split over the ranks
and the kernels are those of ``parallel/dist_q.py``:

- ``cholesky``: the row-panel blocked right-looking factorization;
- ``solve_lower`` / ``solve_lower_t`` / ``cholesky_solve``: the
  panel-by-panel substitutions, a matrix right-hand side included;
- ``syrk`` / ``gemm``: X^T X and X^T Y through the CRT pipeline with an
  exact int32 all-reduce of the residues over the row shards (the
  column scales are all-reduced MAX first), bit for bit the
  single-device product.

Layout: a row-sharded array is this rank's rows (n/D, ..., K) of an
(n, ..., K) array, n divisible by the rank count; replicated operands
are whole on every rank.
"""

from __future__ import annotations

import torch

from . import dist_q
from .comm import Comm


def shard_rows(comm: Comm, a):
    """This rank's rows of (n, ..., K), on its device; n must be
    divisible by the rank count."""
    n = a.shape[0]
    if n % comm.world:
        raise ValueError(f"row count {n} not divisible by the {comm.world} "
                         "ranks; pad the block first")
    rows = n // comm.world
    return a[comm.rank * rows:(comm.rank + 1) * rows].to(comm.device)


def gather_rows(comm: Comm, a_loc):
    """The whole row-sharded array on every rank (a transient copy)."""
    from .multihost import replicate

    return replicate(comm, a_loc)


def cholesky(comm: Comm, a_loc):
    """Lower Cholesky of a row-sharded symmetric MP matrix (n, n, K);
    returns this rank's rows of the factor."""
    return dist_q.cholesky_rowpanel(comm, a_loc)


def solve_lower(comm: Comm, l_loc, b):
    """X = L^-1 B; L row-sharded, B (n, K) or (n, m, K) replicated."""
    return dist_q.solve_lower_rowpanel(comm, l_loc, b)


def solve_lower_t(comm: Comm, l_loc, b):
    return dist_q.solve_lower_t_rowpanel(comm, l_loc, b)


def cholesky_solve(comm: Comm, l_loc, b):
    return solve_lower_t(comm, l_loc, solve_lower(comm, l_loc, b))


def _plan(x_loc, comm: Comm):
    from ..ops import mpmm

    n = x_loc.shape[0] * comm.world
    return mpmm.plan_for(mpmm.precision_of(x_loc.dtype, x_loc.shape[-1]), n)


def _col_exponents(comm: Comm, x_loc):
    from ..ops import mpmm

    return comm.max_(mpmm.exponents(x_loc).amax(dim=0))


def _restore(comm: Comm, res_sum, e_a, e_b, plan, k_out, dtype, *inputs):
    """Sum over ranks, CRT restore, unscale; NaN when any rank's input
    was not finite."""
    from ..ops import exact, mpmm

    res_sum = mpmm.reduce_residues_mod(comm.sum_int(
        mpmm.reduce_residues_mod(res_sum, plan)), plan)
    planes = exact.crt_restore_planes(res_sum, plan)
    w = mpmm.planes_to_mp_dev(planes, plan, k_out, dtype)
    out = mpmm.scale_pow2(w, e_a[:, None] + e_b[None, :])
    bad = torch.stack([~torch.isfinite(x[..., 0].abs().amax())
                       for x in inputs]).any().to(torch.int32)
    bad = comm.max_(bad.reshape(1))[0] > 0
    return torch.where(bad, torch.nan, out)


def syrk(comm: Comm, x_loc, k_out: int | None = None):
    """Exact X^T X of a row-sharded MP matrix (n, m, K) -> replicated
    (m, m, k_out): per-shard residue SYRK and an exact int32
    all-reduce (`bigint_syrk` over the block's group of ranks)."""
    from ..ops import exact, mpmm

    k_out = k_out if k_out is not None else x_loc.shape[-1]
    plan = _plan(x_loc, comm)
    e_col = _col_exponents(comm, x_loc)
    q_res = exact.syrk_residues_split(mpmm._residues(x_loc, e_col, plan),
                                      plan)
    return _restore(comm, q_res, e_col, e_col, plan, k_out, x_loc.dtype,
                    x_loc)


def gemm(comm: Comm, x_loc, y_loc, k_out: int | None = None):
    """Exact X^T Y of row-sharded MP matrices (n, mx, K), (n, my, K) ->
    replicated (mx, my, k_out), by per-shard residue products and an
    exact int32 all-reduce."""
    from ..ops import exact, mpmm

    k_out = k_out if k_out is not None else x_loc.shape[-1]
    plan = _plan(x_loc, comm)
    e_x = _col_exponents(comm, x_loc)
    e_y = _col_exponents(comm, y_loc)
    c_res = exact.gemm_residues_split(mpmm._residues(x_loc, e_x, plan),
                                      mpmm._residues(y_loc, e_y, plan), plan)
    return _restore(comm, c_res, e_x, e_y, plan, k_out, x_loc.dtype,
                    x_loc, y_loc)
