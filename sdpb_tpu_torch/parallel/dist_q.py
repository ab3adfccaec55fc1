"""The distributed N x N Q: a reduce-scatter of its residues and the
row-panel Cholesky factorization and solves.

The PyTorch counterpart of the JAX package's ``parallel/dist_q.py``.
Rank d owns the contiguous row panel [d*rows_loc, (d+1)*rows_loc) of
Q, N padded to n_ranks * rows_loc with an identity corner:

1. the per-prime int32 residues of Q are reduce-scattered over the row
   axis: integer adds cannot round, so the reduction is exact (the
   reference's reduce, `bigint_syrk/restore_and_reduce.cxx:14-33`);
2. each rank restores its own row panel to MP words;
3. the blocked right-looking Cholesky takes the panel of one rank at a
   time: its owner broadcasts the diagonal block, every rank factors
   it (O((N/D)^3), repeated on each rank), the ranks below it solve
   their rows of the panel column, the column is gathered, and each
   rank updates its own trailing rows (the O(N^3) bulk, split D ways);
4. the forward and backward substitutions for dy walk the panels: the
   owner solves its panel and broadcasts it; the backward one adds up
   the other ranks' parts by a gathered MP tree sum.

The same MP arithmetic as the replicated path; only the blocking of the
Cholesky differs, so the results agree to rounding (far below the
precision).  The functions take and return this rank's rows; right-hand
sides and solutions are replicated.
"""

from __future__ import annotations

import torch

from ..mp import core as mp
from ..mp import linalg as la
from .comm import Comm


def padded_rows(n: int, n_dev: int) -> int:
    """Rows per rank after padding N up to a multiple of n_dev."""
    return -(-n // n_dev)


def restore_rows(comm: Comm, q_scat, e_col, finite, plan, k: int, dtype,
                 n: int):
    """CRT-restore this rank's row panel of Q, residues (P, rows_loc, N)
    summed over ranks, to MP words (rows_loc, N1, K), with 1 on the
    padded diagonal and NaN everywhere when an input was not finite."""
    from ..ops import exact, mpmm

    rows_loc = q_scat.shape[1]
    row0 = comm.rank * rows_loc
    n1 = comm.world * rows_loc
    q_scat = mpmm.reduce_residues_mod(q_scat, plan)
    planes = exact.crt_restore_planes(q_scat, plan)
    w = mpmm.planes_to_mp_dev(planes, plan, k, dtype)
    e_pad = torch.nn.functional.pad(e_col, (0, n1 - n))
    e_row = e_pad[row0:row0 + rows_loc]
    q_loc = mpmm.scale_pow2(w, e_row[:, None] + e_col[None, :])
    q_loc = torch.where(finite, q_loc, torch.nan)
    if n1 > n:
        q_loc = torch.nn.functional.pad(q_loc, (0, 0, 0, n1 - n))
        rows = torch.arange(rows_loc, device=q_loc.device)
        glob = row0 + rows
        pad = glob >= n
        if bool(pad.any()):
            one = torch.as_tensor(mp.one_np(k, dtype), device=q_loc.device)
            q_loc[rows[pad], glob[pad]] = one
    return q_loc


def restore_cholesky(comm: Comm, q_part, e_col, finite, plan, k: int, dtype):
    """This rank's rows of L_Q from its per-prime residues of Q
    (P, N, N) int32 in [0, p): reduce-scatter, restore, factor."""
    n = q_part.shape[-1]
    rows_loc = padded_rows(n, comm.world)
    n1 = comm.world * rows_loc
    # rows first, padded: the reduce-scatter splits the leading axis
    q_rows = torch.nn.functional.pad(q_part.transpose(0, 1),
                                     (0, 0, 0, 0, 0, n1 - n))
    q_scat = comm.reduce_scatter_int(q_rows).transpose(0, 1)
    q_loc = restore_rows(comm, q_scat, e_col, finite, plan, k, dtype, n)
    return cholesky_rowpanel(comm, q_loc)


def _lower_rows(comm: Comm, a_loc):
    """Zero the entries of this rank's rows above the global diagonal."""
    rows_loc, n1 = a_loc.shape[0], a_loc.shape[1]
    g = comm.rank * rows_loc + torch.arange(rows_loc, device=a_loc.device)
    cols = torch.arange(n1, device=a_loc.device)
    keep = (g[:, None] >= cols[None, :])[:, :, None]
    return torch.where(keep, a_loc, torch.zeros((), dtype=a_loc.dtype,
                                                device=a_loc.device))


def cholesky_rowpanel(comm: Comm, a_loc):
    """Lower Cholesky of a row-sharded symmetric MP matrix: ``a_loc``
    (rows_loc, N1, K) are this rank's rows; returns its rows of L."""
    rows_loc, n1, k = a_loc.shape
    me = comm.rank
    a = a_loc.clone()
    for pi in range(comm.world):
        j = pi * rows_loc
        diag_loc = a[:, j:j + rows_loc]
        l11 = la.cholesky(comm.broadcast(diag_loc, pi))
        if me == pi:
            col = l11
        elif me > pi:
            col = la.transpose(la.solve_lower(l11, la.transpose(diag_loc)))
        else:
            col = torch.zeros_like(l11)
        a[:, j:j + rows_loc] = col
        src = col if me > pi else torch.zeros_like(col)
        panel = comm.all_gather(src).flatten(0, 1)       # (N1, rows_loc)
        if me > pi and j + rows_loc < n1:
            upd = la.matmul(col, panel[j + rows_loc:], transpose_b=True)
            a[:, j + rows_loc:] = mp.sub(a[:, j + rows_loc:], upd)
    return _lower_rows(comm, a)


def _as_matrix(b):
    return (b[:, None, :], True) if b.dim() == 2 else (b, False)


def solve_lower_rowpanel(comm: Comm, l_loc, b):
    """x = L^-1 b for row-sharded L and replicated b (N1, K) or
    (N1, M, K); returns replicated x.  One broadcast per panel."""
    b, vec = _as_matrix(b)
    rows_loc = l_loc.shape[0]
    x = torch.zeros_like(b)
    for pi in range(comm.world):
        j = pi * rows_loc
        xp = torch.zeros_like(b[j:j + rows_loc])
        if comm.rank == pi:
            s = b[j:j + rows_loc]
            if j:
                s = mp.sub(s, la.matmul(l_loc[:, :j], x[:j]))
            xp = la.solve_lower(l_loc[:, j:j + rows_loc], s)
        x[j:j + rows_loc] = comm.broadcast(xp, pi)
    return x[:, 0] if vec else x


def solve_lower_t_rowpanel(comm: Comm, l_loc, b):
    """x = L^-T b, backward over the panels: the contribution of the
    rows below panel pi, (L^T)[panel, below] x[below], is the sum over
    the ranks below of their panel-column blocks, gathered and added by
    an MP tree sum."""
    b, vec = _as_matrix(b)
    rows_loc = l_loc.shape[0]
    me = comm.rank
    row0 = me * rows_loc
    x = torch.zeros_like(b)
    for pi in reversed(range(comm.world)):
        j = pi * rows_loc
        contrib = torch.zeros_like(b[j:j + rows_loc])
        if me > pi:
            contrib = la.matmul(l_loc[:, j:j + rows_loc],
                                x[row0:row0 + rows_loc], transpose_a=True)
        acc = mp.sum_(comm.all_gather(contrib), axis=0)
        xp = torch.zeros_like(contrib)
        if me == pi:
            xp = la.solve_lower_t(l_loc[:, j:j + rows_loc],
                                  mp.sub(b[j:j + rows_loc], acc))
        x[j:j + rows_loc] = comm.broadcast(xp, pi)
    return x[:, 0] if vec else x


def dist_cholesky_solve(comm: Comm, l_loc, rhs, n: int):
    """A^-1 rhs for the row panels of L_Q (N1 padded rows); rhs (N, K)
    replicated; returns (N, K), replicated."""
    n1 = l_loc.shape[0] * comm.world
    if n1 > n:
        rhs = torch.nn.functional.pad(rhs, (0, 0, 0, n1 - n))
    x = solve_lower_rowpanel(comm, l_loc, rhs)
    x = solve_lower_t_rowpanel(comm, l_loc, x)
    return x[:n]
