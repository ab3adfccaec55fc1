"""Bucketed interior-point iteration: every phase runs per bucket on the
bucket's block axis, with small cross-bucket combiners.

The phase structure mirrors `SDP_Solver/run/run.cxx` and `step.cxx`
as the JAX package's ``solver/bucket_iteration.py`` lays it out
(residues -> Schur/Q -> -XY, mu -> predictor -> corrector centering ->
corrector -> step lengths and update).  The only cross-bucket objects
are reductions: c.x, B^T x, the Q residues (summed as exact integers
before one CRT restore), the dy right-hand side, trace(XY), the
Frobenius products and the error maxima.

The same phases run a block-sharded problem (``parallel/mesh.py``'s
MeshProblem): each rank runs them on its own blocks, a bucket's mask
zeroes its phantom blocks where they would reach a reduction, and each
cross-bucket reduction crosses the ranks first (``problem.comm``): the
Q residues as an exact int32 all-reduce, the small MP sums gathered and
tree-summed in rank order, the error maxima all-reduced.  On one device
(``comm`` None) the collectives are left out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mp import core as mp
from ..mp import linalg as la
from ..parallel.comm import Comm
from ..utils import timers
from . import iteration as it
from .data import BucketedProblem, BucketedState


class Residues(NamedTuple):
    primal_objective: torch.Tensor
    dual_objective: torch.Tensor
    duality_gap: torch.Tensor
    dual_error: torch.Tensor
    primal_error_P: torch.Tensor
    primal_error_p: torch.Tensor
    L_X: list
    L_Y: list
    ax: list
    ay: list
    dual_res: list
    primal_res: list
    primal_res_p: torch.Tensor


class StepInfo(NamedTuple):
    mu: torch.Tensor
    beta_corrector: torch.Tensor
    primal_step: torch.Tensor
    dual_step: torch.Tensor
    R_error: torch.Tensor
    terminate_max_complementarity: torch.Tensor
    q_cond: float = 0.0
    max_block_cond: float = 0.0
    max_block_cond_name: str = ""


def _const(arr, like):
    return torch.as_tensor(np.asarray(arr), device=like.device)


def _max_abs_approx(a):
    return mp.approx(a).abs().amax()


def _comm(problem) -> Comm:
    """The ranks the problem's blocks are spread over (a world of one
    on one device, whose collectives are the identity)."""
    return problem.comm or Comm.local(problem.device)


def _mask(problem, bi: int):
    """Bucket ``bi``'s mask of real blocks (None: every block real)."""
    return None if problem.masks is None else problem.masks[bi]


def _masked(v, mask):
    return v if mask is None else mask_blocks(v, mask)


def _sum_over_ranks(comm: Comm, parts):
    """Each of the same-shape MP values ``parts`` summed over the ranks
    in one gather: a tree sum in rank order, exact as a local sum (a
    word-wise all-reduce of MP words is not)."""
    if comm.world == 1:
        return parts
    return list(mp.sum_(comm.all_gather(torch.stack(parts)),
                        axis=0).unbind(0))


def _max_over_ranks(comm: Comm, vals):
    """The largest of every rank's float scalars ``vals``, all-reduced
    as float64 (exact for float32), in the dtype of the first."""
    if not comm.active:
        return vals
    t = comm.max_(torch.stack([v.to(torch.float64).reshape(())
                               for v in vals]))
    return [t[i].to(vals[0].dtype) for i in range(len(vals))]


# ---------------------------------------------------------------------------
# Phase 1: residues
# ---------------------------------------------------------------------------

def _residues_bucket(bk, x, X, Y, y, mask=None):
    pars = it.parities(bk.shape)
    L_X = tuple(la.cholesky(X[p]) if p in pars else X[p] for p in range(2))
    L_Y = tuple(la.cholesky(Y[p]) if p in pars else Y[p] for p in range(2))
    ax, ay = it.pairings(bk, L_X, Y)
    dual_res = it.dual_residues(bk, ay, y)
    derr = _max_abs_approx(_masked(dual_res, mask))
    w = it.weighted_sum(bk, x)
    primal_res = tuple(mp.sub(w[p], X[p]) if p in pars else w[p]
                       for p in range(2))
    perr = torch.stack([_max_abs_approx(_masked(primal_res[p], mask))
                        for p in pars]).amax()
    # a phantom block has c = B = 0
    cx = mp.sum_(mp.dot(bk.c, x, axis=-1), axis=0)
    bx = mp.sum_(la.matvec(bk.B, x, transpose=True, vdims=1), axis=0)
    return L_X, L_Y, ax, ay, dual_res, primal_res, derr, perr, cx, bx


@timers.span("phases", "residues")
def compute_residues(problem: BucketedProblem,
                     state: BucketedState) -> Residues:
    comm = _comm(problem)
    parts = [_residues_bucket(bk, state.x[bi], state.X[bi], state.Y[bi],
                              state.y, _mask(problem, bi))
             for bi, bk in enumerate(problem.buckets)]
    sums = _sum_over_ranks(comm, [torch.cat([p[8][None], p[9]])
                                  for p in parts])
    cx, bx = sums[0][0], sums[0][1:]
    for s in sums[1:]:
        cx, bx = mp.add(cx, s[0]), mp.add(bx, s[1:])
    derr, perr = _max_over_ranks(comm, [
        torch.stack([p[6] for p in parts]).amax(),
        torch.stack([p[7] for p in parts]).amax()])
    return combine_residues(
        problem, state.y, cx, bx, derr, perr,
        [p[0] for p in parts], [p[1] for p in parts],
        [p[2] for p in parts], [p[3] for p in parts],
        [p[4] for p in parts], [p[5] for p in parts])


def combine_residues(problem, y, cx, bx, derr, perr, L_X, L_Y, ax, ay,
                     dual_res, primal_res) -> Residues:
    """Objectives, gap and errors from the summed c.x and B^T x and the
    largest dual and primal residues (float scalars)."""
    k, dt = problem.k, problem.dtype
    one = _const(mp.one_np(k, dt), problem.b)
    primal_objective = mp.add(problem.objective_const, cx)
    dual_objective = mp.add(problem.objective_const,
                            mp.dot(problem.b, y, axis=0))
    gap_num = mp.abs_(mp.sub(primal_objective, dual_objective))
    gap_den = mp.max_(mp.add(mp.abs_(primal_objective),
                             mp.abs_(dual_objective)), one)
    duality_gap = mp.div(gap_num, gap_den)
    primal_res_p = mp.sub(problem.b, bx)
    to_mp = lambda v: mp.const_word(v, k, dt)
    return Residues(
        primal_objective, dual_objective, duality_gap,
        to_mp(derr), to_mp(perr), to_mp(_max_abs_approx(primal_res_p)),
        L_X, L_Y, ax, ay, dual_res, primal_res, primal_res_p)


# ---------------------------------------------------------------------------
# Phase 2a: Schur factorization and Q
# ---------------------------------------------------------------------------

def _schur_chol_bucket(bk, ax, ay):
    """S-Cholesky and L^-1 B for one bucket, L^-1 B through the explicit
    blocked inverse (tiny diagonal inversions plus CRT matmuls)."""
    S = it.schur_complement(bk, ax, ay)
    ls = la.cholesky(S)
    if la.use_inverse_panels(ls):
        lb = la.matmul(la.lower_inverse(ls), bk.B)
    else:
        lb = la.solve_lower(ls, bk.B)
    return ls, lb


def q_plan(problem: BucketedProblem):
    from ..ops import mpmm

    # over the real blocks (a phantom's rows are zero), so that a sharded
    # Q comes out bit for bit the one-device Q
    total_rows = sum(n * bk.shape.schur_size
                     for n, bk in zip(problem.bucket_sizes, problem.buckets))
    return mpmm.plan_for(mpmm.precision_of(problem.dtype, problem.k),
                         total_rows)


def q_block_chunk(problem: BucketedProblem, max_bytes: int | None):
    """Blocks per Q-residue call so the residue pipeline's buffers stay
    under ``max_bytes`` (--maxSharedMemory; exact whatever the tiling)."""
    if not max_bytes:
        return None
    plan = q_plan(problem)
    worst = max(bk.shape.schur_size for bk in problem.buckets)
    per_block = worst * problem.dual_dim * (plan.n_digits * 4
                                            + 2 * plan.n_primes)
    return max(1, int(max_bytes) // max(1, per_block))


def _q_residues(lb, e_col, plan):
    """Per-prime Q residues of stacked L^-1 B blocks, plus the
    independently computed diagonal (the corruption invariant,
    `compute_Q.cxx:66-92`)."""
    from ..ops import exact, mpmm

    nb, schur, n, k = lb.shape
    x = lb.reshape(nb * schur, n, k)
    u = mpmm.scale_pow2(x, -e_col[None, :])
    r_split = exact.residues_split(mpmm.digits_dev(u, plan), plan)
    return (exact.syrk_residues_split(r_split, plan),
            exact.syrk_diag_residues_split(r_split, plan))


def schur_factorize(problem: BucketedProblem, res: Residues,
                    max_q_bytes: int | None = None):
    from ..ops import mpmm

    comm = _comm(problem)
    plan = q_plan(problem)
    chunk = q_block_chunk(problem, max_q_bytes)
    L_S, LinvB, lb_q = [], [], []
    e_col = finite = None
    for bi, bk in enumerate(problem.buckets):
        ls, lb = _schur_chol_bucket(bk, res.ax[bi], res.ay[bi])
        L_S.append(ls)
        LinvB.append(lb)
        # a phantom has B = 0, so L^-1 B = 0; masked all the same, so
        # that nothing of it reaches Q
        lb = _masked(lb, _mask(problem, bi))
        lb_q.append(lb)
        e = mpmm.exponents(lb).amax(dim=(0, 1))
        f = torch.isfinite(lb[..., 0].abs().amax())
        e_col = e if e_col is None else torch.maximum(e_col, e)
        finite = f if finite is None else finite & f
    if comm.active:
        e_col = comm.max_(e_col)
        finite = comm.min_(finite.to(torch.int32)) > 0
    q_sum = d_sum = None
    for bi, bk in enumerate(problem.buckets):
        step = bk.nb if chunk is None else min(chunk, bk.nb)
        for j in range(0, bk.nb, step):
            q_res, d_res = _q_residues(lb_q[bi][j:j + step], e_col, plan)
            if q_sum is None:
                q_sum, d_sum = q_res, d_res
            else:
                q_sum, d_sum = q_sum + q_res, d_sum + d_res
    if comm.active:
        from ..parallel import mesh

        return L_S, LinvB, mesh.reduce_q_cholesky(problem, q_sum, d_sum,
                                                  e_col, finite, plan)
    return L_S, LinvB, restore_q_cholesky(q_sum, d_sum, e_col, finite,
                                          plan, problem.k, problem.dtype)


def restore_q_cholesky(q_sum, d_sum, e_col, finite, plan, k: int, dtype):
    """Q from the summed per-prime residues, checked against the
    independently summed diagonal (`compute_Q.cxx:66-92`), and its
    Cholesky factor; NaN where an input was not finite."""
    from ..ops import mpmm

    q_sum = mpmm.reduce_residues_mod(q_sum, plan)
    Q = mpmm.restore_q_mp(q_sum, e_col, plan, k, dtype)
    dg = torch.diagonal(q_sum, dim1=-2, dim2=-1)
    finite = finite & (dg == mpmm.reduce_residues_mod(d_sum, plan)).all()
    Q = torch.where(finite, Q, torch.nan)
    return la.cholesky(Q)


# ---------------------------------------------------------------------------
# Phase 2b: -XY, mu, R_error
# ---------------------------------------------------------------------------

def compute_xy_mu(problem: BucketedProblem, state: BucketedState,
                  max_complementarity):
    k, dt, dev = problem.k, problem.dtype, problem.device
    comm = _comm(problem)
    minus_XY, traces = [], []
    for bi, bk in enumerate(problem.buckets):
        pars = it.parities(bk.shape)
        mask = _mask(problem, bi)
        mb = []
        t = mp.zeros((), k, dev, dt)
        for p in range(2):
            if p not in pars:
                mb.append(state.X[bi][p])
                continue
            mxy = mp.neg(la.matmul(state.X[bi][p], state.Y[bi][p]))
            mb.append(mxy)
            t = mp.add(t, mp.sum_(_masked(la.trace(mxy), mask), axis=0))
        minus_XY.append(tuple(mb))
        traces.append(t)
    traces = _sum_over_ranks(comm, traces)
    tr = traces[0]
    for t in traces[1:]:
        tr = mp.add(tr, t)
    mu, terminate = mu_of_trace(problem, tr, max_complementarity)
    r_err, = _max_over_ranks(comm, [torch.stack([
        _max_abs_approx(_masked(la.add_diag(minus_XY[bi][p], mu),
                                _mask(problem, bi)))
        for bi, bk in enumerate(problem.buckets)
        for p in it.parities(bk.shape)]).amax()])
    return minus_XY, mu, mp.const_word(r_err, k, dt), terminate


def mu_of_trace(problem, tr, max_complementarity):
    """mu = -trace(XY) / (PSD rows) and the maxComplementarity flag."""
    k, dt = problem.k, problem.dtype
    rows = torch.tensor(float(problem.total_psd_rows), dtype=dt,
                        device=tr.device)
    mu = mp.div(mp.neg(tr), mp.const_word(rows, k, dt))
    return mu, mp.cmp_lt(_const(max_complementarity, tr), mu)


# ---------------------------------------------------------------------------
# Phase 2c: one Newton direction (predictor and corrector)
# ---------------------------------------------------------------------------

def _search_pre_bucket(bk, Y, L_X, primal_res, dual_res, minus_XY, L_S,
                       LinvB, beta_mu, dXdY, mask=None):
    """Z, R, the L_S-forward-solved dx, and the dy-rhs contribution
    (``mask`` zeroes the dx of a sharded bucket's phantom blocks)."""
    pars = it.parities(bk.shape)
    Rb, Zb = [], []
    for p in range(2):
        if p not in pars:
            Rb.append(minus_XY[p])
            Zb.append(minus_XY[p])
            continue
        R = la.add_diag(mp.sub(minus_XY[p], dXdY[p]), beta_mu)
        Rb.append(R)
        py = la.matmul(primal_res[p], Y[p])
        z = la.cholesky_solve(L_X[p], mp.sub(py, R))
        Zb.append(la.symmetrize(z))
    dx = it.schur_rhs(bk, dual_res, [Zb[p] for p in pars])
    dx = la.solve_lower(L_S, dx)
    dx = _masked(dx, mask)
    dy_part = mp.sum_(la.matvec(LinvB, dx, transpose=True, vdims=1), axis=0)
    return tuple(Rb), dx, dy_part


def _search_post_bucket(bk, dx, dy, L_S, LinvB, Y, L_X, primal_res, R):
    """Back-substitute dx, then dX and dY for one bucket."""
    pars = it.parities(bk.shape)
    dx = mp.add(dx, la.matvec(LinvB, dy, vdims=1))
    dx = la.solve_lower_t(L_S, dx)
    w = it.weighted_sum(bk, dx)
    dXb, dYb = [], []
    for p in range(2):
        if p not in pars:
            dXb.append(w[p])
            dYb.append(w[p])
            continue
        dxp = mp.add(w[p], primal_res[p])
        dXb.append(dxp)
        t = la.matmul(dxp, Y[p])
        t = la.cholesky_solve(L_X[p], mp.sub(t, R[p]))
        dYb.append(mp.neg(la.symmetrize(t)))
    return dx, tuple(dXb), tuple(dYb)


def search_direction(problem: BucketedProblem, state: BucketedState,
                     res: Residues, minus_XY, L_S, LinvB, L_Q, beta_mu,
                     dXdY):
    """One Newton solve (`compute_search_direction.cxx:44-96`); the
    predictor passes zero dXdY."""
    R_list, dx_list, dy_parts = [], [], []
    for bi, bk in enumerate(problem.buckets):
        R, dx, dy_part = _search_pre_bucket(
            bk, state.Y[bi], res.L_X[bi], res.primal_res[bi],
            res.dual_res[bi], minus_XY[bi], L_S[bi], LinvB[bi], beta_mu,
            dXdY[bi], _mask(problem, bi))
        R_list.append(R)
        dx_list.append(dx)
        dy_parts.append(dy_part)
    dy_rhs = res.primal_res_p
    for dy_part in _sum_over_ranks(_comm(problem), dy_parts):
        dy_rhs = mp.sub(dy_rhs, dy_part)
    if isinstance(L_Q, torch.Tensor):
        dy = la.cholesky_solve(L_Q, dy_rhs)
    else:
        dy = L_Q.solve(dy_rhs)          # parallel/mesh.py's DistLQ
    dX, dY = [], []
    for bi, bk in enumerate(problem.buckets):
        dx, dXb, dYb = _search_post_bucket(
            bk, dx_list[bi], dy, L_S[bi], LinvB[bi], state.Y[bi],
            res.L_X[bi], res.primal_res[bi], R_list[bi])
        mask = _mask(problem, bi)
        dx_list[bi] = _masked(dx, mask)
        dX.append(tuple(_masked(d, mask) for d in dXb))
        dY.append(tuple(_masked(d, mask) for d in dYb))
    return dx_list, dX, dy, dY


def zeros_like_XY(state: BucketedState):
    return [tuple(torch.zeros_like(Xp) for Xp in Xb) for Xb in state.X]


def pair_products(problem: BucketedProblem, dX, dY):
    return [tuple(la.matmul(dX[bi][p], dY[bi][p])
                  if p in it.parities(bk.shape) else dX[bi][p]
                  for p in range(2))
            for bi, bk in enumerate(problem.buckets)]


# ---------------------------------------------------------------------------
# Phase 2d: corrector centering parameter
# ---------------------------------------------------------------------------

def corrector_beta(problem: BucketedProblem, state: BucketedState, dX, dY,
                   mu, feasible: bool, feasible_centering,
                   infeasible_centering):
    """`corrector_centering_parameter.cxx:12-31`."""
    k, dt, dev = problem.k, problem.dtype, problem.device
    frobs = []
    for bi, bk in enumerate(problem.buckets):
        f = mp.zeros((), k, dev, dt)
        for p in it.parities(bk.shape):
            per = la.frobenius(mp.add(state.X[bi][p], dX[bi][p]),
                               mp.add(state.Y[bi][p], dY[bi][p]))
            f = mp.add(f, mp.sum_(_masked(per, _mask(problem, bi)),
                                  axis=0))
        frobs.append(f)
    frobs = _sum_over_ranks(_comm(problem), frobs)
    frob = frobs[0]
    for f in frobs[1:]:
        frob = mp.add(frob, f)
    return beta_of_frobenius(problem, frob, mu, feasible,
                             feasible_centering, infeasible_centering)


def beta_of_frobenius(problem, frob, mu, feasible: bool,
                      feasible_centering, infeasible_centering):
    """The corrector's beta from the summed Tr((X+dX)(Y+dY))."""
    k, dt, dev = problem.k, problem.dtype, frob.device
    rows = torch.tensor(float(problem.total_psd_rows), dtype=dt, device=dev)
    r = mp.div(frob, mp.mul_f64(mu, rows))
    one = mp.const_word(torch.tensor(1.0, dtype=dt, device=dev), k, dt)
    beta = mp.where(mp.cmp_lt(r, one), mp.mul(r, r), r)
    if feasible:
        return mp.min_(mp.max_(_const(feasible_centering, mu), beta), one)
    return mp.max_(_const(infeasible_centering, mu), beta)


# ---------------------------------------------------------------------------
# Phase 2e: step lengths and update
# ---------------------------------------------------------------------------

def mask_blocks(v, mask):
    """Zero the blocks of ``v`` (leading block axis) where ``mask`` is
    0: a sharded bucket's phantom blocks."""
    keep = (mask > 0).reshape(mask.shape + (1,) * (v.dim() - 1))
    return torch.where(keep, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device))


def _min_mp_over(lams):
    """MP min over the leading axis by monotonic-key argmin."""
    idx = torch.argmin(mp.lead(lams), dim=0)
    return torch.take_along_dim(lams, idx[None, ..., None], dim=0)[0]


def _lambda_bucket(bk, L_X, dX, L_Y, dY, mask=None):
    """The bucket's smallest eigenvalues of L^-1 dX L^-T and
    L^-1 dY L^-T; ``mask`` leaves a sharded bucket's phantom blocks
    out (an MP +inf in their place)."""
    k, dt = bk.c.shape[-1], bk.c.dtype
    inf = mp.const_word(torch.tensor(float("inf"), dtype=dt,
                                     device=bk.c.device), k, dt)

    def least(lams):
        if mask is not None:
            lams = torch.where(mask[:, None] > 0, lams, inf.expand_as(lams))
        return _min_mp_over(lams)

    lam_p, lam_d = inf, inf
    for p in it.parities(bk.shape):
        cp = la.lower_inverse_congruence(L_X[p], dX[p])
        lam_p = it.min_mp(lam_p, least(it.min_eig_mp(cp)))
        cd = la.lower_inverse_congruence(L_Y[p], dY[p])
        lam_d = it.min_mp(lam_d, least(it.min_eig_mp(cd)))
    return lam_p, lam_d


def apply_step(problem: BucketedProblem, state: BucketedState, res,
               dx, dX, dy, dY, feasible: bool, gamma: float):
    """Step lengths (`step_length.cxx`) and the update
    (`step.cxx:206-224`), in full MP."""
    comm = _comm(problem)
    lams = torch.stack([
        torch.stack(_lambda_bucket(bk, res.L_X[bi], dX[bi], res.L_Y[bi],
                                   dY[bi], _mask(problem, bi)))
        for bi, bk in enumerate(problem.buckets)])      # (buckets, 2, K)
    if comm.active:
        lams = comm.all_gather(lams).flatten(0, 1)
    lam_p = _min_mp_over(lams[:, 0])
    lam_d = _min_mp_over(lams[:, 1])
    k = problem.k
    alpha_p = it.alpha_mp(lam_p, gamma, k)
    alpha_d = it.alpha_mp(lam_d, gamma, k)
    if feasible:
        alpha_p = alpha_d = it.min_mp(alpha_p, alpha_d)
    scale = it.scale_mp
    new_x, new_X, new_Y = [], [], []
    for bi in range(len(problem.buckets)):
        X, Y = state.X[bi], state.Y[bi]
        new_x.append(mp.add(state.x[bi], scale(dx[bi], alpha_p)))
        new_X.append(tuple(mp.add(X[p], scale(dX[bi][p], alpha_p))
                           if X[p].numel() else X[p] for p in range(2)))
        new_Y.append(tuple(mp.add(Y[p], scale(dY[bi][p], alpha_d))
                           if Y[p].numel() else Y[p] for p in range(2)))
    new_state = BucketedState(x=new_x, y=mp.add(state.y, scale(dy, alpha_d)),
                              X=new_X, Y=new_Y)
    return new_state, mp.fst(alpha_p), mp.fst(alpha_d)


#: the names of conditions()'s factors, by kind
_FACTOR_NAMES = ("schur_complement_cholesky.block_{j}",
                 "X_cholesky.block_{j}_0", "Y_cholesky.block_{j}_0",
                 "X_cholesky.block_{j}_1", "Y_cholesky.block_{j}_1")


def conditions(problem, res, L_S, L_Q):
    """Cholesky condition estimates ((max diag / min diag)^2): Q's, and
    the largest block one with its name, over every rank."""
    comm = _comm(problem)
    if isinstance(L_Q, torch.Tensor):
        timers.count("syncs", "conditions.float")
        q_cond = float(la.cholesky_condition_estimate(L_Q))
    else:
        q_cond = L_Q.condition()        # parallel/mesh.py's DistLQ
    best = (0.0, -1.0, -1.0)            # (condition, kind, block)
    for bi, bk in enumerate(problem.buckets):
        groups = [(0, L_S[bi])]
        for p in it.parities(bk.shape):
            groups += [(1 + 2 * p, res.L_X[bi][p]),
                       (2 + 2 * p, res.L_Y[bi][p])]
        for kind, L in groups:
            timers.count("syncs", "conditions.cpu")
            conds = la.cholesky_condition_estimate(L).cpu().numpy()
            for pos, j in enumerate(bk.block_indices):
                if j >= 0 and conds[pos] > best[0]:
                    best = (float(conds[pos]), float(kind), float(j))
    if comm.active:
        timers.count("syncs", "conditions.cpu")
        every = comm.all_gather(torch.tensor(
            best, dtype=torch.float64, device=comm.device)).cpu().numpy()
        best = tuple(every[int(np.argmax(every[:, 0]))])
    max_c, kind, j = best
    if kind < 0:
        return q_cond, 0.0, ""
    return q_cond, float(max_c), _FACTOR_NAMES[int(kind)].format(j=int(j))


def compute_step(problem: BucketedProblem, state: BucketedState,
                 res: Residues, params, is_primal_and_dual_feasible: bool):
    """The predictor-corrector step; returns (new_state, StepInfo).  Each
    phase is a layer span of ``phases``."""
    phase = lambda name: timers.scope("phases", name)
    feasible = bool(is_primal_and_dual_feasible)
    with phase("schur"):
        L_S, LinvB, L_Q = schur_factorize(
            problem, res, max_q_bytes=params.max_shared_memory_bytes)
    with phase("xy_mu"):
        minus_XY, mu, R_error, terminate_max_c = compute_xy_mu(
            problem, state, params.max_complementarity_mp())
    with phase("predictor"):
        beta_pred = _const(params.predictor_beta(feasible), mu)
        dx, dX, dy, dY = search_direction(
            problem, state, res, minus_XY, L_S, LinvB, L_Q,
            mp.mul(beta_pred, mu), zeros_like_XY(state))
    with phase("beta_pairs"):
        beta_corrector = corrector_beta(
            problem, state, dX, dY, mu, feasible,
            params.feasible_centering_mp(), params.infeasible_centering_mp())
        dXdY = pair_products(problem, dX, dY)
    with phase("corrector"):
        dx, dX, dy, dY = search_direction(
            problem, state, res, minus_XY, L_S, LinvB, L_Q,
            mp.mul(beta_corrector, mu), dXdY)
    with phase("apply_step"):
        new_state, alpha_p, alpha_d = apply_step(
            problem, state, res, dx, dX, dy, dY, feasible,
            params.step_length_reduction)
    with phase("conditions"):
        q_cond, max_c, max_name = conditions(problem, res, L_S, L_Q)
    info = StepInfo(mu=mu, beta_corrector=beta_corrector,
                    primal_step=alpha_p, dual_step=alpha_d,
                    R_error=R_error,
                    terminate_max_complementarity=terminate_max_c,
                    q_cond=q_cond, max_block_cond=max_c,
                    max_block_cond_name=max_name)
    return new_state, info
