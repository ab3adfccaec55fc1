"""Bucketed interior-point iteration: every phase runs per bucket on the
bucket's block axis, with small cross-bucket combiners.

The phase structure mirrors `SDP_Solver/run/run.cxx` and `step.cxx`
as the JAX package's ``solver/bucket_iteration.py`` lays it out
(residues -> Schur/Q -> -XY, mu -> predictor -> corrector centering ->
corrector -> step lengths and update).  The only cross-bucket objects
are reductions: c.x, B^T x, the Q residues (summed as exact integers
before one CRT restore), the dy right-hand side, trace(XY), the
Frobenius products and the error maxima.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mp import core as mp
from ..mp import linalg as la
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


# ---------------------------------------------------------------------------
# Phase 1: residues
# ---------------------------------------------------------------------------

def _residues_bucket(bk, x, X, Y, y):
    pars = it.parities(bk.shape)
    L_X = tuple(la.cholesky(X[p]) if p in pars else X[p] for p in range(2))
    L_Y = tuple(la.cholesky(Y[p]) if p in pars else Y[p] for p in range(2))
    ax, ay = it.pairings(bk, L_X, Y)
    dual_res = it.dual_residues(bk, ay, y)
    derr = _max_abs_approx(dual_res)
    w = it.weighted_sum(bk, x)
    primal_res = tuple(mp.sub(w[p], X[p]) if p in pars else w[p]
                       for p in range(2))
    perr = torch.stack([_max_abs_approx(primal_res[p]) for p in pars]).amax()
    cx = mp.sum_(mp.dot(bk.c, x, axis=-1), axis=0)
    bx = mp.sum_(la.matvec(bk.B, x, transpose=True, vdims=1), axis=0)
    return L_X, L_Y, ax, ay, dual_res, primal_res, derr, perr, cx, bx


def compute_residues(problem: BucketedProblem,
                     state: BucketedState) -> Residues:
    parts = [_residues_bucket(bk, state.x[bi], state.X[bi], state.Y[bi],
                              state.y)
             for bi, bk in enumerate(problem.buckets)]
    k, dt = problem.k, problem.dtype
    one = _const(mp.one_np(k, dt), problem.b)
    cx = parts[0][8]
    for p in parts[1:]:
        cx = mp.add(cx, p[8])
    bx = parts[0][9]
    for p in parts[1:]:
        bx = mp.add(bx, p[9])
    primal_objective = mp.add(problem.objective_const, cx)
    dual_objective = mp.add(problem.objective_const,
                            mp.dot(problem.b, state.y, axis=0))
    gap_num = mp.abs_(mp.sub(primal_objective, dual_objective))
    gap_den = mp.max_(mp.add(mp.abs_(primal_objective),
                             mp.abs_(dual_objective)), one)
    duality_gap = mp.div(gap_num, gap_den)
    primal_res_p = mp.sub(problem.b, bx)
    to_mp = lambda v: mp.const_word(v, k, dt)
    return Residues(
        primal_objective, dual_objective, duality_gap,
        to_mp(torch.stack([p[6] for p in parts]).amax()),
        to_mp(torch.stack([p[7] for p in parts]).amax()),
        to_mp(_max_abs_approx(primal_res_p)),
        [p[0] for p in parts], [p[1] for p in parts],
        [p[2] for p in parts], [p[3] for p in parts],
        [p[4] for p in parts], [p[5] for p in parts], primal_res_p)


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

    total_rows = sum(bk.nb * bk.shape.schur_size for bk in problem.buckets)
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

    plan = q_plan(problem)
    chunk = q_block_chunk(problem, max_q_bytes)
    L_S, LinvB = [], []
    e_col = finite = None
    for bi, bk in enumerate(problem.buckets):
        ls, lb = _schur_chol_bucket(bk, res.ax[bi], res.ay[bi])
        L_S.append(ls)
        LinvB.append(lb)
        e = mpmm.exponents(lb).amax(dim=(0, 1))
        f = torch.isfinite(lb[..., 0].abs().amax())
        e_col = e if e_col is None else torch.maximum(e_col, e)
        finite = f if finite is None else finite & f
    q_sum = d_sum = None
    for bi, bk in enumerate(problem.buckets):
        step = bk.nb if chunk is None else min(chunk, bk.nb)
        for j in range(0, bk.nb, step):
            q_res, d_res = _q_residues(LinvB[bi][j:j + step], e_col, plan)
            if q_sum is None:
                q_sum, d_sum = q_res, d_res
            else:
                q_sum, d_sum = q_sum + q_res, d_sum + d_res
    q_sum = mpmm.reduce_residues_mod(q_sum, plan)
    Q = mpmm.restore_q_mp(q_sum, e_col, plan, problem.k, problem.dtype)
    dg = torch.diagonal(q_sum, dim1=-2, dim2=-1)
    finite = finite & (dg == mpmm.reduce_residues_mod(d_sum, plan)).all()
    Q = torch.where(finite, Q, torch.nan)
    return L_S, LinvB, la.cholesky(Q)


# ---------------------------------------------------------------------------
# Phase 2b: -XY, mu, R_error
# ---------------------------------------------------------------------------

def compute_xy_mu(problem: BucketedProblem, state: BucketedState,
                  max_complementarity):
    k, dt, dev = problem.k, problem.dtype, problem.device
    minus_XY, tr = [], None
    for bi, bk in enumerate(problem.buckets):
        pars = it.parities(bk.shape)
        mb = []
        t = mp.zeros((), k, dev, dt)
        for p in range(2):
            if p not in pars:
                mb.append(state.X[bi][p])
                continue
            mxy = mp.neg(la.matmul(state.X[bi][p], state.Y[bi][p]))
            mb.append(mxy)
            t = mp.add(t, mp.sum_(la.trace(mxy), axis=0))
        minus_XY.append(tuple(mb))
        tr = t if tr is None else mp.add(tr, t)
    rows = torch.tensor(float(problem.total_psd_rows), dtype=dt, device=dev)
    mu = mp.div(mp.neg(tr), mp.const_word(rows, k, dt))
    terminate = mp.cmp_lt(_const(max_complementarity, tr), mu)
    r_err = torch.stack([
        _max_abs_approx(la.add_diag(minus_XY[bi][p], mu))
        for bi, bk in enumerate(problem.buckets)
        for p in it.parities(bk.shape)]).amax()
    return minus_XY, mu, mp.const_word(r_err, k, dt), terminate


# ---------------------------------------------------------------------------
# Phase 2c: one Newton direction (predictor and corrector)
# ---------------------------------------------------------------------------

def _search_pre_bucket(bk, Y, L_X, primal_res, dual_res, minus_XY, L_S,
                       LinvB, beta_mu, dXdY):
    """Z, R, the L_S-forward-solved dx, and the dy-rhs contribution."""
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
    R_list, dx_list, dy_rhs = [], [], res.primal_res_p
    for bi, bk in enumerate(problem.buckets):
        R, dx, dy_part = _search_pre_bucket(
            bk, state.Y[bi], res.L_X[bi], res.primal_res[bi],
            res.dual_res[bi], minus_XY[bi], L_S[bi], LinvB[bi], beta_mu,
            dXdY[bi])
        R_list.append(R)
        dx_list.append(dx)
        dy_rhs = mp.sub(dy_rhs, dy_part)
    dy = la.cholesky_solve(L_Q, dy_rhs)
    dX, dY = [], []
    for bi, bk in enumerate(problem.buckets):
        dx, dXb, dYb = _search_post_bucket(
            bk, dx_list[bi], dy, L_S[bi], LinvB[bi], state.Y[bi],
            res.L_X[bi], res.primal_res[bi], R_list[bi])
        dx_list[bi] = dx
        dX.append(dXb)
        dY.append(dYb)
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
    frob = None
    for bi, bk in enumerate(problem.buckets):
        f = mp.zeros((), k, dev, dt)
        for p in it.parities(bk.shape):
            per = la.frobenius(mp.add(state.X[bi][p], dX[bi][p]),
                               mp.add(state.Y[bi][p], dY[bi][p]))
            f = mp.add(f, mp.sum_(per, axis=0))
        frob = f if frob is None else mp.add(frob, f)
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

def _min_mp_over(lams):
    """MP min over the leading axis by monotonic-key argmin."""
    idx = torch.argmin(mp.lead(lams), dim=0)
    return torch.take_along_dim(lams, idx[None, ..., None], dim=0)[0]


def _lambda_bucket(bk, L_X, dX, L_Y, dY):
    k, dt = bk.c.shape[-1], bk.c.dtype
    inf = mp.const_word(torch.tensor(float("inf"), dtype=dt,
                                     device=bk.c.device), k, dt)
    lam_p, lam_d = inf, inf
    for p in it.parities(bk.shape):
        cp = la.lower_inverse_congruence(L_X[p], dX[p])
        lam_p = it.min_mp(lam_p, _min_mp_over(it.min_eig_mp(cp)))
        cd = la.lower_inverse_congruence(L_Y[p], dY[p])
        lam_d = it.min_mp(lam_d, _min_mp_over(it.min_eig_mp(cd)))
    return lam_p, lam_d


def apply_step(problem: BucketedProblem, state: BucketedState, res,
               dx, dX, dy, dY, feasible: bool, gamma: float):
    """Step lengths (`step_length.cxx`) and the update
    (`step.cxx:206-224`), in full MP."""
    lams = [_lambda_bucket(bk, res.L_X[bi], dX[bi], res.L_Y[bi], dY[bi])
            for bi, bk in enumerate(problem.buckets)]
    lam_p = _min_mp_over(torch.stack([lp for lp, _ in lams]))
    lam_d = _min_mp_over(torch.stack([ld for _, ld in lams]))
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


def _conditions(problem, res, L_S, L_Q):
    """Cholesky condition estimates ((max diag / min diag)^2): Q's, and
    the largest block one with its name."""
    q_cond = float(la.cholesky_condition_estimate(L_Q))
    max_c, max_name = 0.0, ""
    for bi, bk in enumerate(problem.buckets):
        groups = [("schur_complement_cholesky.block_{j}", L_S[bi])]
        for p in it.parities(bk.shape):
            groups.append((f"X_cholesky.block_{{j}}_{p}", res.L_X[bi][p]))
            groups.append((f"Y_cholesky.block_{{j}}_{p}", res.L_Y[bi][p]))
        for fmt, L in groups:
            conds = la.cholesky_condition_estimate(L).cpu().numpy()
            for pos, j in enumerate(bk.block_indices):
                if conds[pos] > max_c:
                    max_c, max_name = float(conds[pos]), fmt.format(j=j)
    return q_cond, max_c, max_name


def compute_step(problem: BucketedProblem, state: BucketedState,
                 res: Residues, params, is_primal_and_dual_feasible: bool,
                 timers=None):
    """The predictor-corrector step; returns (new_state, StepInfo)."""
    import contextlib

    scoped = timers.scoped if timers is not None else \
        (lambda name: contextlib.nullcontext())
    feasible = bool(is_primal_and_dual_feasible)
    with scoped("schur"):
        L_S, LinvB, L_Q = schur_factorize(
            problem, res, max_q_bytes=params.max_shared_memory_bytes)
    with scoped("xy_mu"):
        minus_XY, mu, R_error, terminate_max_c = compute_xy_mu(
            problem, state, params.max_complementarity_mp())
    with scoped("predictor"):
        beta_pred = _const(params.predictor_beta(feasible), mu)
        dx, dX, dy, dY = search_direction(
            problem, state, res, minus_XY, L_S, LinvB, L_Q,
            mp.mul(beta_pred, mu), zeros_like_XY(state))
    with scoped("beta_pairs"):
        beta_corrector = corrector_beta(
            problem, state, dX, dY, mu, feasible,
            params.feasible_centering_mp(), params.infeasible_centering_mp())
        dXdY = pair_products(problem, dX, dY)
    with scoped("corrector"):
        dx, dX, dy, dY = search_direction(
            problem, state, res, minus_XY, L_S, LinvB, L_Q,
            mp.mul(beta_corrector, mu), dXdY)
    with scoped("update"):
        new_state, alpha_p, alpha_d = apply_step(
            problem, state, res, dx, dX, dy, dY, feasible,
            params.step_length_reduction)
        q_cond, max_c, max_name = _conditions(problem, res, L_S, L_Q)
    info = StepInfo(mu=mu, beta_corrector=beta_corrector,
                    primal_step=alpha_p, dual_step=alpha_d,
                    R_error=R_error,
                    terminate_max_complementarity=terminate_max_c,
                    q_cond=q_cond, max_block_cond=max_c,
                    max_block_cond_name=max_name)
    return new_state, info
