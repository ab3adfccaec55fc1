"""The plain reference: one primal-dual interior-point iteration of SDPB
(the stock predictor-corrector step of Simmons-Duffin's SDPB, arXiv
1502.02033, section 3, and its solver parameters' defaults) on the
bootstrap-shaped problems of the benchmark, in the multiprecision
tensors of ``mpt``.

Blocks come in buckets of one shape (m, pts): for parity p the basis q_p
(h_p x pts) gives the PSD block of size m h_p, U_p = I_m (x) q_p, and the
constraint (r <= s, k), flattened as (s(s+1)/2 + r) pts + k, has

    A_(r,s,k) = 1/2 (E_rs + E_sr) (x) q_k q_k^T     (on each parity)

so that Tr(A_(r,s,k) M) = (U^T M U)[(r,k),(s,k)].  The iteration works
from its inputs alone: inverses by Newton-Schulz (no Cholesky), the
Schur complement from its defining trace formula, Q = sum B^T S^-1 B,
the two Newton directions, and the step lengths from float64 minimum
eigenvalues (the only float64 quantity, compared loosely).

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import mpt


@dataclasses.dataclass
class Bucket:
    m: int
    pts: int
    c: mpt.MP                 # (nb, P)
    B: mpt.MP                 # (nb, P, N)
    U: list                   # per parity: MP (nb, m h, m pts)
    q: list                   # per parity: float64 (nb, h, pts)

    @property
    def nb(self) -> int:
        return self.c.shape[0]

    @property
    def T(self) -> int:
        return self.m * (self.m + 1) // 2

    def tuples(self):
        """(r, s) of each tuple t = s(s+1)/2 + r."""
        rs = [(r, s) for s in range(self.m) for r in range(s + 1)]
        return (np.array([r for r, _ in rs]), np.array([s for _, s in rs]))


@dataclasses.dataclass
class Problem:
    buckets: list
    b: mpt.MP                 # (N,)
    objective_const: mpt.MP   # ()
    L: int

    @property
    def psd_rows(self) -> int:
        return sum(bk.nb * sum(u.shape[1] for u in bk.U)
                   for bk in self.buckets)


@dataclasses.dataclass
class State:
    x: list                   # per bucket: MP (nb, P)
    y: mpt.MP                 # (N,)
    X: list                   # per bucket: [MP (nb, n_p, n_p) per parity]
    Y: list


def problem_of(data: dict, L: int, device) -> Problem:
    """The reference's problem from the generator's float64 arrays."""
    f = lambda a: mpt.from_f64(torch.as_tensor(np.asarray(a, np.float64),
                                               device=device), L)
    buckets = []
    for bk in data["buckets"]:
        m, pts = bk["m"], bk["pts"]
        U, q = [], []
        for qp in bk["q"]:
            nb, h, _ = qp.shape
            if h == 0:
                continue
            u = np.zeros((nb, m, h, m, pts))
            for a in range(m):
                u[:, a, :, a, :] = qp
            U.append(f(u.reshape(nb, m * h, m * pts)))
            q.append(torch.as_tensor(qp, device=device))
        buckets.append(Bucket(m=m, pts=pts, c=f(bk["c"]), B=f(bk["B"]),
                              U=U, q=q))
    return Problem(buckets=buckets, b=f(data["b"]),
                   objective_const=f(np.float64(data["objective_const"])),
                   L=L)


def cold_start(problem: Problem, scale: float) -> State:
    """x = y = 0, X = Y = scale I."""
    L, dev = problem.L, problem.b.d.device
    x, X = [], []
    for bk in problem.buckets:
        x.append(mpt.zeros((bk.nb, bk.c.shape[1]), L, dev))
        X.append([mpt.from_f64(scale * torch.eye(
            u.shape[1], dtype=torch.float64, device=dev).expand(
                bk.nb, u.shape[1], u.shape[1]), L) for u in bk.U])
    return State(x=x, y=mpt.zeros((problem.b.shape[0],), L, dev), X=X,
                 Y=[list(p) for p in X])


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _sym(a: mpt.MP) -> mpt.MP:
    return mpt.mul_pow2(mpt.add(a, a.transpose()), -1)


def _pairing(U: mpt.MP, M: mpt.MP, m: int, pts: int) -> mpt.MP:
    """U^T M U as (nb, m, pts, m, pts)."""
    t = mpt.matmul(U.transpose(), mpt.matmul(M, U))
    return t.reshape(t.shape[0], m, pts, m, pts)


def _diag_traces(bk: Bucket, pair: list) -> mpt.MP:
    """Tr(A_(r,s,k) M) = sum_parity (U^T M U)[r,k,s,k], (nb, P)."""
    r, s = bk.tuples()
    dev = bk.c.d.device
    ri = torch.as_tensor(r, device=dev)[:, None]
    si = torch.as_tensor(s, device=dev)[:, None]
    k = torch.arange(bk.pts, device=dev)[None, :]
    out = None
    for pm in pair:
        g = pm[(slice(None), ri, k, si, k)]          # (nb, T, pts)
        out = g if out is None else mpt.add(out, g)
    return out.reshape(bk.nb, bk.T * bk.pts)


def _weighted(bk: Bucket, a: mpt.MP) -> list:
    """W(a) = sum_p a_p A_p on each parity, (nb, m h, m h)."""
    m, pts, nb = bk.m, bk.pts, bk.nb
    dev = a.d.device
    A = np.arange(m)
    hi, lo = np.maximum(A[:, None], A[None, :]), np.minimum(A[:, None],
                                                           A[None, :])
    t_of = torch.as_tensor((hi * (hi + 1)) // 2 + lo, device=dev)
    a_t = a.reshape(nb, bk.T, pts)
    w = a_t[(slice(None), t_of)]                       # (nb, m, m, pts)
    diag = torch.as_tensor(A[:, None] == A[None, :], device=dev)
    w = mpt.where(diag[None, :, :, None].expand(w.shape), w,
                  mpt.mul_pow2(w, -1))
    out = []
    for U, q in zip(bk.U, bk.q):
        h = q.shape[1]
        qm = mpt.from_f64(q, a.L)                      # (nb, h, pts)
        g = mpt.mul(qm[:, None, None], w[:, :, :, None, :])
        full = mpt.matmul(g, qm.transpose()[:, None, None])   # (nb,m,m,h,h)
        out.append(full.movedim(3, 2).reshape(nb, m * h, m * h))
    return out


def _trace_prod(a: mpt.MP, b: mpt.MP) -> mpt.MP:
    """sum over every block of Tr(a b) for symmetric a, b."""
    flat = mpt.mul(a, b)
    return mpt.sum_(flat.reshape(-1), 0)


def _add_diag(a: mpt.MP, v: mpt.MP) -> mpt.MP:
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=a.d.device)
    return mpt.add(a, mpt.where(eye.expand(a.shape), v.expand(*a.shape),
                                mpt.zeros(a.shape, a.L, a.d.device)))


def _mpf(x: mpt.MP, ctx):
    return mpt.to_mpf(x, ctx)


# ---------------------------------------------------------------------------
# One iteration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Iteration:
    primal_objective: object   # mpmath
    dual_objective: object
    duality_gap: object
    primal_error_P: float
    primal_error_p: float
    dual_error: float
    mu: object
    beta_corrector: object
    objective_scale: tuple     # the sums of |terms| of each objective
    error_scale: tuple         # the largest |term| of each error's residue
    dx: list                   # corrector direction, per bucket
    dX: list
    dy: mpt.MP
    dY: list
    primal_step: float
    dual_step: float


def iterate(problem: Problem, st: State, params: dict,
            ctx) -> Iteration:
    """The residues and the predictor-corrector step from ``st``."""
    L, dev = problem.L, problem.b.d.device
    N = problem.b.shape[0]
    mpc = lambda v: mpt.from_mpf(ctx.mpf(v), L, dev)

    # residues
    Xi, AX, AY, d, P = [], [], [], [], []
    big_P = big_d = 0.0
    f64 = mpt.to_f64
    for bi, bk in enumerate(problem.buckets):
        xi = [mpt.inverse(Xp) for Xp in st.X[bi]]
        Xi.append(xi)
        AX.append([_pairing(U, v, bk.m, bk.pts) for U, v in zip(bk.U, xi)])
        AY.append([_pairing(U, v, bk.m, bk.pts)
                   for U, v in zip(bk.U, st.Y[bi])])
        By = mpt.matmul(bk.B, st.y.reshape(1, N, 1)).reshape(bk.nb, -1)
        traces = _diag_traces(bk, AY[bi])
        d.append(mpt.sub(mpt.sub(bk.c, traces), By))
        W = _weighted(bk, st.x[bi])
        P.append([mpt.sub(w, Xp) for w, Xp in zip(W, st.X[bi])])
        big_d = max(big_d, mpt.max_abs_f64(bk.c), mpt.max_abs_f64(traces),
                    float((f64(bk.B).abs() @ f64(st.y).abs()).max()))
        big_P = max([big_P] + [mpt.max_abs_f64(v) for v in W + st.X[bi]])
    cx = mpt.sum_(mpt.cat([mpt.mul(bk.c, st.x[bi]).reshape(-1)
                           for bi, bk in enumerate(problem.buckets)], 0), 0)
    Btx = None
    for bi, bk in enumerate(problem.buckets):
        part = mpt.matmul(bk.B.reshape(-1, N).transpose(),
                          st.x[bi].reshape(-1, 1)).reshape(N)
        Btx = part if Btx is None else mpt.add(Btx, part)
    pvec = mpt.sub(problem.b, Btx)
    big_p = max([mpt.max_abs_f64(problem.b)] + [
        float((f64(bk.B).reshape(-1, N).abs().T
               @ f64(st.x[bi]).reshape(-1).abs()).max())
        for bi, bk in enumerate(problem.buckets)])
    by = mpt.dot(problem.b, st.y, 0)
    oc = _mpf(problem.objective_const, ctx)
    po = oc + _mpf(cx, ctx)
    do = oc + _mpf(by, ctx)
    gap = abs(po - do) / max(ctx.mpf(1), abs(po) + abs(do))
    scale_po = abs(oc) + float(sum(
        (mpt.to_f64(bk.c) * mpt.to_f64(st.x[bi])).abs().sum().item()
        for bi, bk in enumerate(problem.buckets)))
    scale_do = abs(oc) + float((mpt.to_f64(problem.b)
                                * mpt.to_f64(st.y)).abs().sum().item())
    perr_P = max(mpt.max_abs_f64(p) for Pb in P for p in Pb)
    perr_p = mpt.max_abs_f64(pvec)
    derr = max(mpt.max_abs_f64(v) for v in d)
    primal_error = max(perr_P, perr_p)
    feasible = (primal_error < float(params["primal_error"])
                and derr < float(params["dual_error"]))

    # mu and -XY
    XY = [[mpt.matmul(Xp, Yp) for Xp, Yp in zip(st.X[bi], st.Y[bi])]
          for bi in range(len(problem.buckets))]
    tr = None
    for bi in range(len(problem.buckets)):
        for Xp, Yp in zip(st.X[bi], st.Y[bi]):
            t = _trace_prod(Xp, Yp)
            tr = t if tr is None else mpt.add(tr, t)
    rows = problem.psd_rows
    mu = _mpf(tr, ctx) / rows

    # Schur complement, its inverse, Q and Q^-1
    Si, SiB = [], []
    for bi, bk in enumerate(problem.buckets):
        r, s = bk.tuples()
        ri = torch.as_tensor(r, device=dev)
        si = torch.as_tensor(s, device=dev)
        k = torch.arange(bk.pts, device=dev)

        def g(t, a, b):
            return t[(slice(None), a[:, None, None, None], k[None, :, None, None],
                      b[None, None, :, None], k[None, None, None, :])]

        S = None
        for ax, ay in zip(AX[bi], AY[bi]):
            for (a1, b1), (a2, b2) in (((si, ri), (ri, si)),
                                       ((ri, ri), (si, si)),
                                       ((si, si), (ri, ri)),
                                       ((ri, si), (si, ri))):
                term = mpt.mul(g(ax, a1, b1), g(ay, a2, b2))
                S = term if S is None else mpt.add(S, term)
        S = mpt.mul_pow2(S, -2).reshape(bk.nb, bk.T * bk.pts,
                                        bk.T * bk.pts)
        Si.append(mpt.inverse(S))
        SiB.append(mpt.matmul(Si[bi], bk.B))
    B_all = mpt.cat([bk.B.reshape(-1, N) for bk in problem.buckets], 0)
    SiB_all = mpt.cat([v.reshape(-1, N) for v in SiB], 0)
    Qi = mpt.inverse(mpt.matmul(B_all.transpose(), SiB_all))

    def direction(R):
        rhs = []
        for bi, bk in enumerate(problem.buckets):
            Z = [_sym(mpt.matmul(xi, mpt.sub(mpt.matmul(Pp, Yp), Rp)))
                 for xi, Pp, Yp, Rp in zip(Xi[bi], P[bi], st.Y[bi], R[bi])]
            trz = _diag_traces(bk, [_pairing(U, z, bk.m, bk.pts)
                                    for U, z in zip(bk.U, Z)])
            rhs.append(mpt.neg(mpt.add(d[bi], trz)))
        u = [mpt.matmul(Si[bi], rhs[bi].reshape(bk.nb, -1, 1)).reshape(
            bk.nb, -1) for bi, bk in enumerate(problem.buckets)]
        Btu = None
        for bi, bk in enumerate(problem.buckets):
            part = mpt.matmul(bk.B.reshape(-1, N).transpose(),
                              u[bi].reshape(-1, 1)).reshape(N)
            Btu = part if Btu is None else mpt.add(Btu, part)
        dy = mpt.matmul(Qi, mpt.sub(pvec, Btu).reshape(N, 1)).reshape(N)
        dx, dX, dY = [], [], []
        for bi, bk in enumerate(problem.buckets):
            Bdy = mpt.matmul(bk.B, dy.reshape(1, N, 1)).reshape(bk.nb, -1)
            v = mpt.add(rhs[bi], Bdy).reshape(bk.nb, -1, 1)
            dxb = mpt.matmul(Si[bi], v).reshape(bk.nb, -1)
            W = _weighted(bk, dxb)
            dXb = [mpt.add(w, Pp) for w, Pp in zip(W, P[bi])]
            dYb = [mpt.neg(_sym(mpt.matmul(xi, mpt.sub(mpt.matmul(dXp, Yp),
                                                        Rp))))
                   for xi, dXp, Yp, Rp in zip(Xi[bi], dXb, st.Y[bi], R[bi])]
            dx.append(dxb)
            dX.append(dXb)
            dY.append(dYb)
        return dx, dX, dy, dY

    beta_p = ctx.mpf(0) if feasible else ctx.mpf(params["infeasible_centering"])
    bmu = mpc(beta_p * mu)
    R = [[_add_diag(mpt.neg(xy), bmu) for xy in XY[bi]]
         for bi in range(len(problem.buckets))]
    dx, dX, dy, dY = direction(R)

    frob = None
    for bi in range(len(problem.buckets)):
        for Xp, dXp, Yp, dYp in zip(st.X[bi], dX[bi], st.Y[bi], dY[bi]):
            t = _trace_prod(mpt.add(Xp, dXp), mpt.add(Yp, dYp))
            frob = t if frob is None else mpt.add(frob, t)
    ratio = _mpf(frob, ctx) / (mu * rows)
    beta = ratio * ratio if ratio < 1 else ratio
    if feasible:
        beta = min(max(ctx.mpf(params["feasible_centering"]), beta),
                   ctx.mpf(1))
    else:
        beta = max(ctx.mpf(params["infeasible_centering"]), beta)
    bmu = mpc(beta * mu)
    R = [[mpt.sub(_add_diag(mpt.neg(XY[bi][p]), bmu),
                  mpt.matmul(dX[bi][p], dY[bi][p]))
          for p in range(len(XY[bi]))]
         for bi in range(len(problem.buckets))]
    dx, dX, dy, dY = direction(R)

    gamma = float(params["step_length_reduction"])

    def step(M, dM):
        lam = float("inf")
        for bi in range(len(problem.buckets)):
            for Mp, dMp in zip(M[bi], dM[bi]):
                Lc = torch.linalg.cholesky(mpt.to_f64(Mp))
                t = torch.linalg.solve_triangular(Lc, mpt.to_f64(dMp),
                                                  upper=False)
                c = torch.linalg.solve_triangular(
                    Lc, t.transpose(-1, -2), upper=False)
                c = (c + c.transpose(-1, -2)) / 2
                lam = min(lam, torch.linalg.eigvalsh(c).amin().item())
        return 1.0 if lam > -gamma else -gamma / lam

    ap, ad = step(st.X, dX), step(st.Y, dY)
    if feasible:
        ap = ad = min(ap, ad)
    return Iteration(
        primal_objective=po, dual_objective=do, duality_gap=gap,
        primal_error_P=perr_P, primal_error_p=perr_p, dual_error=derr,
        mu=mu, beta_corrector=beta, objective_scale=(scale_po, scale_do),
        error_scale=(big_P, big_p, big_d),
        dx=dx, dX=dX, dy=dy, dY=dY, primal_step=ap, dual_step=ad)


def advance(st: State, it: Iteration, L: int) -> State:
    """The reference's own next iterate (its float64 step lengths)."""
    dev = st.y.d.device
    ap = mpt.from_f64(torch.tensor(it.primal_step, dtype=torch.float64,
                                   device=dev), L)
    ad = mpt.from_f64(torch.tensor(it.dual_step, dtype=torch.float64,
                                   device=dev), L)
    return State(
        x=[mpt.add(x, mpt.mul(dx, ap)) for x, dx in zip(st.x, it.dx)],
        y=mpt.add(st.y, mpt.mul(it.dy, ad)),
        X=[[mpt.add(a, mpt.mul(b, ap)) for a, b in zip(Xb, dXb)]
           for Xb, dXb in zip(st.X, it.dX)],
        Y=[[mpt.add(a, mpt.mul(b, ad)) for a, b in zip(Yb, dYb)]
           for Yb, dYb in zip(st.Y, it.dY)])
