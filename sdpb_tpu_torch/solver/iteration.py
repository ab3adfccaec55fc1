"""Per-block kernels of one interior-point iteration, batched over a
bucket's leading block axis.

These are the functions of the JAX package's ``solver/iteration.py``
that ``bucket_iteration`` calls under ``vmap``; here they take the
bucket axis explicitly (axis 0 of every block array) and pass
``vdims=1`` to ``matmul`` so that its routing sees per-block shapes, as
it does under ``vmap``.  Counterparts: ``pairings`` = _pairings_block,
``dual_residues`` = _dual_residues_block, ``weighted_sum`` =
_weighted_sum_block, ``schur_rhs`` = _schur_rhs_block,
``schur_complement`` = _schur_complement_block, ``min_eig_mp`` =
_min_eig_mp (float64 eigh here).  Reference anchors: pairings
`run/compute_bilinear_pairings/*`, residues `compute_dual_residues_and_
error.cxx`, weighted sums `constraint_matrix_weighted_sum.cxx`, Schur
RHS `compute_schur_RHS.cxx`, Schur complement
`compute_schur_complement.cxx`, step lengths `step_length.cxx`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mp import core as mp
from ..mp import linalg as la


def parities(shape):
    """Indices of non-empty parity blocks (odd basis can be empty)."""
    return [p for p in range(2) if shape.psd_size(p) > 0]


def _make_symmetric_lower(a):
    """Mirror the lower triangle to the upper (El::MakeSymmetric(LOWER))."""
    n = a.shape[-3]
    idx = torch.arange(n, device=a.device)
    lower = (idx[:, None] >= idx[None, :])[:, :, None]
    return torch.where(lower, a, a.transpose(-3, -2))


def _idx(a, device):
    return torch.as_tensor(a, device=device)


def pairings(bk, L_X, Y):
    """A_X_inv = U^T X^{-1} U and A_Y = U^T Y U per parity, as
    (nb, m, pts, m, pts, S)."""
    m, pts = bk.shape.m, bk.shape.pts
    ax, ay = [], []
    for p in parities(bk.shape):
        u = bk.u[p]
        t = la.solve_lower(L_X[p], u)
        ax_full = _make_symmetric_lower(la.matmul(t, t, transpose_a=True,
                                                  vdims=1))
        yu = la.matmul(Y[p], u, vdims=1)
        ay_full = _make_symmetric_lower(la.matmul(u, yu, transpose_a=True,
                                                  vdims=1))
        nb, k = ax_full.shape[0], ax_full.shape[-1]
        ax.append(ax_full.reshape(nb, m, pts, m, pts, k))
        ay.append(ay_full.reshape(nb, m, pts, m, pts, k))
    return ax, ay


def dual_residues(bk, ay_list, y):
    """d[p] = c[p] - Tr(A_p Y) - (B y)_p, with
    Tr(A_(s,r,k) Y) = sum_parity A_Y[r, k, s, k]."""
    s_idx, r_idx = bk.shape.tuple_indices()
    pts = bk.shape.pts
    nb, k = bk.c.shape[0], bk.c.shape[-1]
    dev = bk.c.device
    r_i, s_i = _idx(r_idx, dev)[:, None], _idx(s_idx, dev)[:, None]
    kk = torch.arange(pts, device=dev)[None, :]
    tr = mp.zeros((nb, bk.shape.n_tuples, pts), k, dev, bk.c.dtype)
    for ay in ay_list:
        tr = mp.add(tr, ay[:, r_i, kk, s_i, kk, :])
    d = mp.sub(bk.c, tr.reshape(nb, bk.shape.schur_size, k))
    return mp.sub(d, la.matvec(bk.B, y, vdims=1))


def weighted_sum(bk, a_vec):
    """sum_p a[p] A_p as a parity pair of dense matrices: sub-block
    (r, s) is coeff * q diag(a_(s,r,:)) q^T, coeff 1 on diagonal tuples
    and 1/2 off it, symmetrized."""
    m, pts = bk.shape.m, bk.shape.pts
    nb, k = a_vec.shape[0], a_vec.shape[-1]
    dev = a_vec.device
    a_t = a_vec.reshape(nb, bk.shape.n_tuples, pts, k)
    A = np.arange(m)
    hi = np.maximum(A[:, None], A[None, :])
    lo = np.minimum(A[:, None], A[None, :])
    t_of = (hi * (hi + 1)) // 2 + lo
    w = a_t[:, _idx(t_of.reshape(-1), dev)].reshape(nb, m, m, pts, k)
    half = torch.as_tensor(np.where(A[:, None] == A[None, :], 1.0, 0.5),
                           dtype=a_vec.dtype, device=dev)
    w = mp.mul_pow2(w, half[:, :, None])
    out = []
    for p in range(2):
        h = bk.shape.he if p == 0 else bk.shape.ho
        if h == 0:
            out.append(mp.zeros((nb, 0, 0), k, dev, a_vec.dtype))
            continue
        q = bk.q[p]                                   # (nb, h, pts, S)
        tmp = mp.mul(q[:, None, None], w[:, :, :, None, :, :])
        qt = la.transpose(q)[:, None, None].expand(nb, m, m, pts, h, k)
        full = la.matmul(tmp, qt, vdims=1)            # (nb, m, m, h, h)
        full = full.movedim(3, 2)
        out.append(full.reshape(nb, m * h, m * h, k))
    return out


def schur_rhs(bk, dres, Z):
    """dx[p] = -d[p] - Tr(A_p Z) with
    Tr(A_(s,r,k) Z) = sum_parity (q^T Z[r,s] q)_kk."""
    m, pts = bk.shape.m, bk.shape.pts
    nb, k = dres.shape[0], dres.shape[-1]
    dev = dres.device
    s_idx, r_idx = bk.shape.tuple_indices()
    r_i, s_i = _idx(r_idx, dev)[:, None], _idx(s_idx, dev)[:, None]
    kk = torch.arange(pts, device=dev)[None, :]
    total = mp.zeros((nb, bk.shape.n_tuples, pts), k, dev, dres.dtype)
    for p, Zp in zip(parities(bk.shape), Z):
        h = bk.shape.he if p == 0 else bk.shape.ho
        q = bk.q[p]
        z4 = Zp.reshape(nb, m, h, m, h, k)
        qb = q[:, None, None].expand(nb, m, h, h, pts, k)
        m1 = la.matmul(z4, qb, vdims=1)               # (nb, m, h, m, pts)
        term = mp.sum_(mp.mul(q[:, None, :, None, :, :], m1), axis=2)
        total = mp.add(total, term[:, r_i, s_i, kk, :])
    return mp.sub(mp.neg(dres), total.reshape(nb, bk.shape.schur_size, k))


def schur_complement(bk, ax_list, ay_list):
    """Schur block (nb, schur, schur, S) from the 4-term symmetrized
    product of pairing sub-blocks."""
    pts = bk.shape.pts
    s_idx, r_idx = bk.shape.tuple_indices()
    T = bk.shape.n_tuples
    dev = bk.c.device
    nb, k = bk.c.shape[0], bk.c.shape[-1]
    s0, r0 = _idx(s_idx[:, None], dev), _idx(r_idx[:, None], dev)
    s1, r1 = _idx(s_idx[None, :], dev), _idx(r_idx[None, :], dev)
    ku = torch.arange(pts, device=dev)[None, None, :, None]
    kv = torch.arange(pts, device=dev)[None, None, None, :]

    def g(t, a, b):
        return t[:, a[..., None, None], ku, b[..., None, None], kv, :]

    acc = None
    for ax, ay in zip(ax_list, ay_list):
        term = mp.mul(g(ax, s0, r1), g(ay, r0, s1))
        term = mp.add(term, mp.mul(g(ax, r0, r1), g(ay, s0, s1)))
        term = mp.add(term, mp.mul(g(ax, s0, s1), g(ay, r0, r1)))
        term = mp.add(term, mp.mul(g(ax, r0, s1), g(ay, s0, r1)))
        acc = term if acc is None else mp.add(acc, term)
    acc = mp.mul_pow2(acc, 0.25)
    acc = acc.movedim(3, 2)                   # (nb, T, pts, T, pts, S)
    return _make_symmetric_lower(acc.reshape(nb, T * pts, T * pts, k))


# ---------------------------------------------------------------------------
# Step lengths
# ---------------------------------------------------------------------------

def min_eig_mp(c_mp):
    """lambda_min of symmetric MP matrices (nb, n, n, K) -> (nb, K):
    a float64 ``eigh`` for the eigenvector, then the MP Rayleigh
    quotient v^T C v / v^T v (`step_length/min_eigenvalue.cxx` role)."""
    k, dt = c_mp.shape[-1], c_mp.dtype
    w, v = torch.linalg.eigh(mp.approx(c_mp).to(torch.float64))
    vm = mp.const_word(v[..., :, 0], k, dt)            # (nb, n, K)
    cv = la.matvec(c_mp, vm, vdims=1)
    num = mp.dot(vm, cv, axis=-1)
    den = mp.dot(vm, vm, axis=-1)
    rq = mp.div(num, den)
    fallback = mp.const_word(w[..., 0], k, dt)
    ok = torch.isfinite(mp.approx(rq))[..., None]
    return torch.where(ok, rq, fallback)


def min_mp(a, b):
    """min of two MP scalars by leading-value compare; NaN is sticky."""
    fa = mp.fst(a)
    return torch.where(((fa <= mp.fst(b)) | torch.isnan(fa))[..., None],
                       a, b)


def alpha_mp(lam, gamma: float, k: int):
    """step = min(1, -gamma/lambda_min), in full MP; gamma is rounded to
    the word dtype first, as in the JAX package (float32 for limbs)."""
    dev, dt = lam.device, lam.dtype
    g = mp.const_word(torch.tensor(gamma, dtype=dt, device=dev), k, dt)
    one = mp.const_word(torch.tensor(1.0, dtype=dt, device=dev), k, dt)
    safe = mp.fst(lam) > -float(gamma)
    lam_safe = torch.where(safe[..., None], -one, lam)
    a = mp.div(mp.neg(g), lam_safe)
    return mp.where(safe, one, a)


def scale_mp(arr, alpha):
    """arr * alpha for an MP scalar alpha (S,), broadcast over batch."""
    return mp.mul(arr, alpha.expand(arr.shape))
