"""The solver for problems whose PSD blocks exceed one device: every
block's X-sized state sharded by rows over every rank.

The PyTorch counterpart of the JAX package's
``parallel/intra_solver.py``.  The reference gives a block too large for
one rank to a group of ranks with a 2-D grid, so that its Cholesky,
Trsm and Syrk span them (`Block_Map.hxx:8-14`, `sdpb/solve.cxx:31`).
Here:

- the persistent per-block state (X, Y, their Cholesky factors, the
  primal residue P, the S Cholesky, dX, dY) lives as each rank's rows,
  padded to a multiple of the rank count with an identity corner,
  which divides the largest terms of the memory by the rank count;
- factorizations and triangular solves are the row-panel kernels of
  ``parallel/intra.py``; the pairings' products are its exact SYRK and
  GEMM with an int32 all-reduce over the row shards;
- a product whose contracted axis is a row-sharded one gathers that
  operand first (a transient full copy), so that every MP matmul is
  local: a word-wise sum over ranks would not be an MP add;
- the small data (c, B, the bases), x, y, Q, the Schur factors' L^-1 B
  and the pairings are replicated; blocks are processed one at a time,
  so one full-size transient lives at a time.

The step lengths gather the congruence matrix for the float64 ``eigh``
of ``solver/iteration.py::min_eig_mp``, as the JAX package does (a
distributed eigensolver is the known limit of this path).  The driver
dispatches on ``IntraProblem``; ``apps/sdpb.py`` routes a problem here
when the memory estimate is over the limit and ``intra_would_fit``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..mp import core as mp
from ..mp import linalg as la
from ..solver import bucket_iteration as bi
from ..solver import iteration as it
from ..solver.data import BucketedState, SDPBucket, SDPProblem, SolverState
from . import intra
from .comm import Comm


@dataclasses.dataclass
class IntraProblem:
    """An SDPProblem (replicated on ``comm.device``) whose per-block PSD
    matrices are row-sharded over the ranks of ``comm``."""

    problem: SDPProblem
    comm: Comm

    @property
    def b(self):
        return self.problem.b

    @property
    def objective_const(self):
        return self.problem.objective_const

    @property
    def blocks(self):
        return self.problem.blocks

    @property
    def dual_dim(self):
        return self.problem.dual_dim

    @property
    def total_psd_rows(self):
        return self.problem.total_psd_rows

    @property
    def k(self) -> int:
        return self.problem.b.shape[-1]

    @property
    def dtype(self):
        return self.problem.b.dtype

    @property
    def device(self):
        return self.problem.b.device


def _pad_to(n: int, d: int) -> int:
    return -(-n // d) * d


def _view(bl) -> SDPBucket:
    """One block as a bucket of one (the per-block functions of
    ``solver/iteration.py`` take a leading block axis)."""
    return SDPBucket(c=bl.c[None], B=bl.B[None],
                     q=tuple(q[None] for q in bl.q),
                     u=tuple(u[None] for u in bl.u), shape=bl.shape)


def _pad_rows(a, n1: int):
    """(n, ..., K) -> (n1, ..., K), zero rows appended."""
    pad = [0, 0] * (a.dim() - 1) + [0, n1 - a.shape[0]]
    return torch.nn.functional.pad(a, pad)


def _pad_square(a, n1: int):
    """(n, n, K) -> (n1, n1, K), zeros appended."""
    n = a.shape[0]
    return torch.nn.functional.pad(a, (0, 0, 0, n1 - n, 0, n1 - n))


def _row0(comm: Comm, a_loc) -> int:
    return comm.rank * a_loc.shape[0]


def _diag_index(comm: Comm, a_loc):
    r = torch.arange(a_loc.shape[0], device=a_loc.device)
    return r, _row0(comm, a_loc) + r


def _add_diag_rows(comm: Comm, a_loc, s):
    """A + s I on this rank's rows (s an MP scalar)."""
    r, c = _diag_index(comm, a_loc)
    d = a_loc[r, c]
    out = a_loc.clone()
    out[r, c] = mp.add(d, s.expand(d.shape))
    return out


def _valid(comm: Comm, a_loc, n: int):
    """This rank's rows of the unpadded n x n matrix."""
    rows = max(0, min(a_loc.shape[0], n - _row0(comm, a_loc)))
    return a_loc[:rows, :n]


def _eye_rows(comm: Comm, n: int, k: int, scale, dtype, device):
    """This rank's rows of the padded (n1, n1) matrix scale * I (1 on
    the padded diagonal)."""
    n1 = _pad_to(n, comm.world)
    rows = n1 // comm.world
    out = torch.zeros((rows, n1, k), dtype=dtype, device=device)
    r = torch.arange(rows, device=device)
    g = comm.rank * rows + r
    sv = torch.as_tensor(mp.from_f64_np(float(scale), k, dtype),
                         device=device)
    one = torch.as_tensor(mp.one_np(k, dtype), device=device)
    out[r, g] = torch.where((g < n)[:, None], sv, one)
    return out


def _empty(k, dtype, device):
    return torch.zeros((0, 0, k), dtype=dtype, device=device)


def initial_state(ip: IntraProblem, scale_primal, scale_dual) -> SolverState:
    k, dt, dev = ip.k, ip.dtype, ip.device
    x, X, Y = [], [], []
    for bl in ip.blocks:
        x.append(mp.zeros((bl.shape.schur_size,), k, dev, dt))
        X.append(tuple(_eye_rows(ip.comm, n, k, scale_primal, dt, dev)
                       if n else _empty(k, dt, dev)
                       for n in bl.shape.psd_sizes))
        Y.append(tuple(_eye_rows(ip.comm, n, k, scale_dual, dt, dev)
                       if n else _empty(k, dt, dev)
                       for n in bl.shape.psd_sizes))
    return SolverState(x=x, y=mp.zeros((ip.dual_dim,), k, dev, dt),
                       X=X, Y=Y)


def to_bucketed_state(ip: IntraProblem, state: SolverState, buckets,
                      device="cpu") -> BucketedState:
    """The whole state, unpadded, in the layout of a BucketedProblem's
    ``buckets`` (checkpoints and solutions); collective."""
    def full(a_loc, n):
        if not n:
            return a_loc.new_zeros((0, 0, a_loc.shape[-1]))
        return intra.gather_rows(ip.comm, a_loc)[:n, :n]

    blocks = [(state.x[j], tuple(full(state.X[j][p], bl.shape.psd_size(p))
                                 for p in range(2)),
               tuple(full(state.Y[j][p], bl.shape.psd_size(p))
                     for p in range(2)))
              for j, bl in enumerate(ip.blocks)]
    x, X, Y = [], [], []
    for bk in buckets:
        js = list(bk.block_indices)
        x.append(torch.stack([blocks[j][0] for j in js]).to(device))
        X.append(tuple(torch.stack([blocks[j][1][p] for j in js]).to(device)
                       for p in range(2)))
        Y.append(tuple(torch.stack([blocks[j][2][p] for j in js]).to(device)
                       for p in range(2)))
    return BucketedState(x=x, y=state.y.to(device), X=X, Y=Y)


def compute_residues(ip: IntraProblem, state: SolverState):
    comm, k, dt = ip.comm, ip.k, ip.dtype
    L_X, L_Y, ax, ay, dual_res, primal_res = [], [], [], [], [], []
    derr, perr = [], []
    cx = mp.zeros((), k, ip.device, dt)
    bx = mp.zeros((ip.dual_dim,), k, ip.device, dt)
    for bl, x, Xb, Yb in zip(ip.blocks, state.x, state.X, state.Y):
        bk = _view(bl)
        w = [wp[0] for wp in it.weighted_sum(bk, x[None])]
        lxs, lys, axs, ays, prs = [], [], [], [], []
        m, pts = bl.shape.m, bl.shape.pts
        for p in range(2):
            n_p = bl.shape.psd_size(p)
            if n_p == 0:
                lxs.append(Xb[p])
                lys.append(Yb[p])
                prs.append(w[p])
                continue
            n1 = Xb[p].shape[1]
            lx = intra.cholesky(comm, Xb[p])
            ly = intra.cholesky(comm, Yb[p])
            lxs.append(lx)
            lys.append(ly)
            u = _pad_rows(bl.u[p], n1)
            # A_X_inv = (L^-1 U)^T (L^-1 U): distributed Trsm and SYRK
            t = intra.solve_lower(comm, lx, u)
            axf = it._make_symmetric_lower(
                intra.syrk(comm, intra.shard_rows(comm, t)))
            # A_Y = U^T (Y U): local rows of Y U, distributed GEMM
            yu = la.matmul(Yb[p], u)
            ayf = it._make_symmetric_lower(
                intra.gemm(comm, intra.shard_rows(comm, u), yu))
            axs.append(axf.reshape(1, m, pts, m, pts, k))
            ays.append(ayf.reshape(1, m, pts, m, pts, k))
            # P = sum_p A_p x_p - X on this rank's rows; the padded
            # diagonal of X is 1, so it is added back there
            pr = mp.sub(intra.shard_rows(comm, _pad_square(w[p], n1)), Xb[p])
            r, c = _diag_index(comm, pr)
            pad = c >= n_p
            if bool(pad.any()):
                d = pr[r[pad], c[pad]]
                one = torch.as_tensor(mp.one_np(k, dt), device=pr.device)
                pr[r[pad], c[pad]] = mp.add(d, one.expand(d.shape))
            prs.append(pr)
            perr.append(bi._max_abs_approx(pr))
        L_X.append(tuple(lxs))
        L_Y.append(tuple(lys))
        ax.append(axs)
        ay.append(ays)
        dres = it.dual_residues(bk, ays, state.y)[0]
        dual_res.append(dres)
        derr.append(bi._max_abs_approx(dres))
        primal_res.append(tuple(prs))
        cx = mp.add(cx, mp.dot(bl.c, x, axis=0))
        bx = mp.add(bx, la.matvec(bl.B, x, transpose=True))
    p_err, = bi._max_over_ranks(comm, [torch.stack(perr).amax()])
    return bi.combine_residues(ip, state.y, cx, bx, torch.stack(derr).amax(),
                               p_err, L_X, L_Y, ax, ay, dual_res, primal_res)


def _chol_big(comm: Comm, a):
    """Row-panel Cholesky of a replicated matrix, padded with an
    identity corner; (this rank's rows of L, padded size)."""
    n, k = a.shape[0], a.shape[-1]
    n1 = _pad_to(n, comm.world)
    ap = _pad_square(a, n1)
    if n1 > n:
        idx = torch.arange(n, n1, device=a.device)
        ap[idx, idx] = torch.as_tensor(mp.one_np(k, a.dtype), device=a.device)
    return intra.cholesky(comm, intra.shard_rows(comm, ap)), n1


def _congruence(comm: Comm, L_loc, dM_loc, n_p: int):
    """L^-1 dM L^-T through the distributed solves, whole on every rank
    (for the float64 eigensolver)."""
    z = intra.solve_lower(comm, L_loc, intra.gather_rows(comm, dM_loc))
    c = intra.solve_lower(comm, L_loc, la.transpose(z))
    return la.transpose(c)[:n_p, :n_p]


def _search(ip, state, res, minus_XY, L_S, nS, LinvB, L_Q, beta_mu, dXdY):
    """One Newton direction (`compute_search_direction.cxx:44-96`) with
    row-sharded X-sized tensors and distributed factor solves."""
    comm = ip.comm
    R_blocks, dx = [], []
    for i, bl in enumerate(ip.blocks):
        Rb, Z = [], []
        for p in range(2):
            n_p = bl.shape.psd_size(p)
            if n_p == 0:
                Rb.append(minus_XY[i][p])
                continue
            R = _add_diag_rows(comm, mp.sub(minus_XY[i][p], dXdY[i][p]),
                               beta_mu)
            Rb.append(R)
            yf = intra.gather_rows(comm, state.Y[i][p])
            z = mp.sub(la.matmul(res.primal_res[i][p], yf), R)
            z = intra.cholesky_solve(comm, res.L_X[i][p],
                                     intra.gather_rows(comm, z))
            Z.append(la.symmetrize(z)[:n_p, :n_p][None])
        R_blocks.append(tuple(Rb))
        dx.append(it.schur_rhs(_view(bl), res.dual_res[i][None], Z)[0])
    dy_rhs = res.primal_res_p
    for i, bl in enumerate(ip.blocks):
        s = bl.shape.schur_size
        d = intra.solve_lower(comm, L_S[i], _pad_rows(dx[i][:, None], nS[i]))
        dx[i] = d[:s, 0]
        dy_rhs = mp.sub(dy_rhs, la.matvec(LinvB[i], dx[i], transpose=True))
    dy = la.cholesky_solve(L_Q, dy_rhs)
    dX, dY = [], []
    for i, bl in enumerate(ip.blocks):
        s = bl.shape.schur_size
        d = mp.add(dx[i], la.matvec(LinvB[i], dy))
        d = intra.solve_lower_t(comm, L_S[i], _pad_rows(d[:, None], nS[i]))
        dx[i] = d[:s, 0]
        w = [wp[0] for wp in it.weighted_sum(_view(bl), dx[i][None])]
        dXb, dYb = [], []
        for p in range(2):
            if bl.shape.psd_size(p) == 0:
                dXb.append(w[p])
                dYb.append(w[p])
                continue
            n1 = state.X[i][p].shape[1]
            dxp = mp.add(intra.shard_rows(comm, _pad_square(w[p], n1)),
                         res.primal_res[i][p])
            dXb.append(dxp)
            yf = intra.gather_rows(comm, state.Y[i][p])
            t = mp.sub(la.matmul(dxp, yf), R_blocks[i][p])
            t = intra.cholesky_solve(comm, res.L_X[i][p],
                                     intra.gather_rows(comm, t))
            dYb.append(intra.shard_rows(comm, mp.neg(la.symmetrize(t))))
        dX.append(tuple(dXb))
        dY.append(tuple(dYb))
    return dx, dX, dy, dY


def compute_step(ip: IntraProblem, state: SolverState, res, params,
                 is_primal_and_dual_feasible: bool):
    """The predictor-corrector step with row-sharded blocks."""
    from ..ops import mpmm

    comm, k, dt, dev = ip.comm, ip.k, ip.dtype, ip.device
    feasible = bool(is_primal_and_dual_feasible)
    const = lambda a: torch.as_tensor(a, device=dev)

    # Schur complements, their row-sharded factors, L^-1 B and Q (from
    # replicated L^-1 B: every rank restores the same Q)
    L_S, LinvB, nS = [], [], []
    for i, bl in enumerate(ip.blocks):
        S = it.schur_complement(_view(bl), res.ax[i], res.ay[i])[0]
        ls, n1s = _chol_big(comm, S)
        lb = intra.solve_lower(comm, ls, _pad_rows(bl.B, n1s))
        L_S.append(ls)
        LinvB.append(lb[:bl.shape.schur_size])
        nS.append(n1s)
    total_rows = sum(bl.shape.schur_size for bl in ip.blocks)
    plan = mpmm.plan_for(mpmm.precision_of(dt, k), total_rows)
    e_col = torch.stack([mpmm.exponents(lb).amax(dim=0)
                         for lb in LinvB]).amax(dim=0)
    finite = torch.stack([torch.isfinite(lb[..., 0].abs().amax())
                          for lb in LinvB]).all()
    q_sum = d_sum = None
    for lb in LinvB:
        q_res, d_res = bi._q_residues(lb[None], e_col, plan)
        q_sum = q_res if q_sum is None else q_sum + q_res
        d_sum = d_res if d_sum is None else d_sum + d_res
    L_Q = bi.restore_q_cholesky(q_sum, d_sum, e_col, finite, plan, k, dt)

    # -XY, mu, R error
    minus_XY = []
    tr = mp.zeros((), k, dev, dt)
    for i, bl in enumerate(ip.blocks):
        mb = []
        for p in range(2):
            n_p = bl.shape.psd_size(p)
            if n_p == 0:
                mb.append(state.X[i][p])
                continue
            yf = intra.gather_rows(comm, state.Y[i][p])
            mxy = mp.neg(la.matmul(state.X[i][p], yf))
            mb.append(mxy)
            r, c = _diag_index(comm, mxy)
            dg = mxy[r[c < n_p], c[c < n_p]]
            if dg.shape[0]:
                tr = mp.add(tr, mp.sum_(dg, axis=0))
        minus_XY.append(tuple(mb))
    tr, = bi._sum_over_ranks(comm, [tr])
    mu, terminate_max_c = bi.mu_of_trace(ip, tr,
                                         params.max_complementarity_mp())
    r_err = torch.zeros((), dtype=mp.approx(mu).dtype, device=dev)
    for i, bl in enumerate(ip.blocks):
        for p in it.parities(bl.shape):
            rr = _valid(comm, _add_diag_rows(comm, minus_XY[i][p], mu),
                        bl.shape.psd_size(p))
            if rr.shape[0]:
                r_err = torch.maximum(r_err, bi._max_abs_approx(rr))
    r_err, = bi._max_over_ranks(comm, [r_err])
    R_error = mp.const_word(r_err, k, dt)

    beta_pred = const(params.predictor_beta(feasible))
    zeros = [tuple(torch.zeros_like(Xp) for Xp in Xb) for Xb in state.X]
    dx, dX, dy, dY = _search(ip, state, res, minus_XY, L_S, nS, LinvB, L_Q,
                             mp.mul(beta_pred, mu), zeros)

    # corrector centering parameter
    frob = mp.zeros((), k, dev, dt)
    for i, bl in enumerate(ip.blocks):
        for p in it.parities(bl.shape):
            n_p = bl.shape.psd_size(p)
            prod = mp.mul(_valid(comm, mp.add(state.X[i][p], dX[i][p]), n_p),
                          _valid(comm, mp.add(state.Y[i][p], dY[i][p]), n_p))
            if prod.shape[0]:
                frob = mp.add(frob, mp.sum_(prod.reshape(-1, k), axis=0))
    frob, = bi._sum_over_ranks(comm, [frob])
    beta_c = bi.beta_of_frobenius(ip, frob, mu, feasible,
                                  params.feasible_centering_mp(),
                                  params.infeasible_centering_mp())

    dXdY = [tuple(la.matmul(dX[i][p], intra.gather_rows(comm, dY[i][p]))
                  if bl.shape.psd_size(p) else dX[i][p] for p in range(2))
            for i, bl in enumerate(ip.blocks)]
    dx, dX, dy, dY = _search(ip, state, res, minus_XY, L_S, nS, LinvB, L_Q,
                             mp.mul(beta_c, mu), dXdY)

    # step lengths and the update
    inf = mp.const_word(torch.tensor(float("inf"), dtype=dt, device=dev),
                        k, dt)
    lam_p = lam_d = inf
    for i, bl in enumerate(ip.blocks):
        for p in it.parities(bl.shape):
            n_p = bl.shape.psd_size(p)
            cX = _congruence(comm, res.L_X[i][p], dX[i][p], n_p)
            lam_p = it.min_mp(lam_p, it.min_eig_mp(cX[None])[0])
            cY = _congruence(comm, res.L_Y[i][p], dY[i][p], n_p)
            lam_d = it.min_mp(lam_d, it.min_eig_mp(cY[None])[0])
    gamma = params.step_length_reduction
    alpha_p = it.alpha_mp(lam_p, gamma, k)
    alpha_d = it.alpha_mp(lam_d, gamma, k)
    if feasible:
        alpha_p = alpha_d = it.min_mp(alpha_p, alpha_d)
    new_x = [mp.add(x, it.scale_mp(d, alpha_p)) for x, d in zip(state.x, dx)]
    new_X = [tuple(mp.add(state.X[i][p], it.scale_mp(dX[i][p], alpha_p))
                   if bl.shape.psd_size(p) else state.X[i][p]
                   for p in range(2)) for i, bl in enumerate(ip.blocks)]
    new_Y = [tuple(mp.add(state.Y[i][p], it.scale_mp(dY[i][p], alpha_d))
                   if bl.shape.psd_size(p) else state.Y[i][p]
                   for p in range(2)) for i, bl in enumerate(ip.blocks)]
    new_state = SolverState(x=new_x, y=mp.add(state.y,
                                              it.scale_mp(dy, alpha_d)),
                            X=new_X, Y=new_Y)
    info = bi.StepInfo(
        mu=mu, beta_corrector=beta_c, primal_step=mp.fst(alpha_p),
        dual_step=mp.fst(alpha_d), R_error=R_error,
        terminate_max_complementarity=terminate_max_c,
        q_cond=float(la.cholesky_condition_estimate(L_Q)))
    return new_state, info
