"""Dense linear algebra on MP matrices (..., n, m, K), both formats.

The PyTorch counterpart of the JAX package's ``mp/linalg.py``, on the
route the accelerator takes there:

- ``matmul`` sends large products (batched ones too) to the exact
  integer CRT pipeline (``ops/mpmm.py``) and small ones to the plain
  elementwise MP product with a tree sum;
- for limbs (float32), ``cholesky``, ``solve_lower`` and
  ``solve_lower_t`` are panel-blocked around the two limb kernels
  (``ops/limb_kernels.py``), with trailing updates as CRT matmuls, for
  any number of rows, and ``lower_inverse`` builds L^-1 from
  kernel-inverted diagonal blocks;
- for float64 expansions they are the JAX package's own expansion
  routes, written over a leading batch axis where the JAX package
  vmaps: panels of 32 around the column loops of the Cholesky and the
  substitution, each loop one launch of its kernel
  (``ops/expansion_kernels.py``) on the card.

Routing follows the tensor's device, not a global: CUDA tensors launch
the kernels, CPU tensors run their plain versions, and both take the
same route.  Every function accepts leading batch axes.
"""

from __future__ import annotations

import math

import torch

from . import core
from ..ops import expansion_kernels as ek
from ..ops import limb_kernels as lk
from ..utils import timers

_span = timers.span("linalg")


def _panel(routine: str):
    """One panel step of a blocked route: a span of layer ``panels``
    named ``<routine>.panel``, and a count of ``("panels", routine)``.
    Only the routes that block (more than 2 * _PANEL rows) open it."""
    timers.count("panels", routine)
    return timers.scope("panels", f"{routine}.panel")


# Contraction chunk of the plain limb matmul: bounds its product tensor.
_MATMUL_CHUNK = 128

# Work thresholds (contraction * output elements) for the CRT route.
_INT_BACKEND_MIN_WORK = 16 * 1024
_INT_BACKEND_MIN_WORK_PER_BATCH = 2 * 1024

_PANEL = 32


def _int_backend_ok(a_shape, p: int) -> bool:
    """The accelerator's routing rule for a @ b with a (..., m, n, S)
    and p output columns.  ``a_shape`` excludes axes the JAX package
    maps with vmap, so the rule sees the same shapes there and here."""
    if len(a_shape) < 3:
        return False
    work = a_shape[-3] * a_shape[-2] * p
    if len(a_shape) == 3:
        return work >= _INT_BACKEND_MIN_WORK
    batch = math.prod(a_shape[:-3])
    return (work >= _INT_BACKEND_MIN_WORK_PER_BATCH
            and batch * work >= _INT_BACKEND_MIN_WORK)


@_span
def matmul(a, b, transpose_a: bool = False, transpose_b: bool = False,
           vdims: int = 0):
    """Limb matrix product a @ b: (..., m, n, S) x (..., n, p, S) ->
    (..., m, p, S).  ``a is b`` with one side transposed is a SYRK.
    ``vdims`` leading axes are per-block axes that the JAX package
    vmaps over; they do not count as batch for the routing rule."""
    syrk = a is b and transpose_a != transpose_b
    if transpose_a:
        a = a.transpose(-3, -2)
    if transpose_b:
        b = b.transpose(-3, -2)
    crt = _int_backend_ok(a.shape[vdims:], b.shape[-2])
    timers.route("crt" if crt else "plain")
    return _product(a, b, crt, syrk)


def _product(a, b, crt: bool, syrk: bool = False):
    """a @ b on the route given: the CRT pipeline or the plain limb
    product with a tree sum.  Either way each output entry depends only
    on its own row of a and column of b."""
    n = a.shape[-2]
    assert b.shape[-3] == n, (a.shape, b.shape)
    if crt:
        from ..ops import mpmm

        plan = mpmm.plan_for(core.precision_bits_of(a.shape[-1], a.dtype),
                             n)
        at = a.transpose(-3, -2)
        if syrk:
            return mpmm.syrk_mp_batched(at, plan)
        return mpmm.gemm_mp_batched(at, b, plan)
    out = None
    for start in range(0, n, _MATMUL_CHUNK):
        stop = min(start + _MATMUL_CHUNK, n)
        prod = core.mul(a[..., :, start:stop, None, :],
                        b[..., None, start:stop, :, :])
        part = core.sum_(prod, axis=-2)
        out = part if out is None else core.add(out, part)
    return out


@_span
def matvec(a, x, transpose: bool = False, vdims: int = 0):
    """(..., n, m, S) @ (..., m, S) -> (..., n, S), through ``matmul``
    with a width-1 right operand."""
    if transpose:
        a = a.transpose(-3, -2)
    xb = x[..., None, :].expand(a.shape[:-3] + x.shape[-2:-1] + (1,)
                                + x.shape[-1:])
    return matmul(a, xb, vdims=vdims)[..., 0, :]


def transpose(a):
    return a.transpose(-3, -2)


@_span
def symmetrize(a):
    """(A + A^T)/2."""
    return core.mul_pow2(core.add(a, transpose(a)), 0.5)


def diag(a):
    return torch.diagonal(a, dim1=-3, dim2=-2).movedim(-1, -2)


@_span
def add_diag(a, s):
    """A + s*I for an MP scalar s (S,) or a float."""
    n = a.shape[-3]
    d = diag(a)
    if torch.is_tensor(s) and s.dim() >= 1 and s.shape[-1] == a.shape[-1]:
        new_d = core.add(d, s.expand(d.shape))
    else:
        new_d = core.add_f64(d, s)
    out = a.clone()
    idx = torch.arange(n, device=a.device)
    out[..., idx, idx, :] = new_d
    return out


@_span
def trace(a):
    """Sum of the diagonal (leading batch axes kept)."""
    return core.sum_(diag(a), axis=-1)


@_span
def frobenius(a, b):
    """Tr(a^T b) over the trailing matrix axes (batch axes kept)."""
    prod = core.mul(a, b)
    flat = prod.reshape(prod.shape[:-3] + (-1, prod.shape[-1]))
    return core.sum_(flat, axis=-1)


# ---------------------------------------------------------------------------
# Cholesky and triangular solves (blocked around the limb kernels)
# ---------------------------------------------------------------------------

def _eye(n: int, k: int, device, dtype=torch.float32):
    out = torch.zeros((n, n, k), dtype=dtype, device=device)
    idx = torch.arange(n, device=device)
    out[idx, idx] = torch.as_tensor(core.one_np(k, dtype), device=device)
    return out


def _pad_identity(a, npad: int):
    """Extend (..., n, n, S) to (..., n+npad, n+npad, S) with an
    identity corner."""
    n, k = a.shape[-3], a.shape[-1]
    out = torch.zeros(a.shape[:-3] + (n + npad, n + npad, k),
                      dtype=a.dtype, device=a.device)
    out[..., :n, :n, :] = a
    idx = torch.arange(n, n + npad, device=a.device)
    out[..., idx, idx, :] = torch.as_tensor(core.one_np(k, a.dtype),
                                            device=a.device)
    return out


# The panel loops below update only the trailing block.  The JAX
# package's static-shape loop (and the port before it) added each
# panel's product to the whole matrix, so an entry already final took
# one addition of a zero per remaining panel, and a non-finite panel
# poisoned the whole matrix through the CRT product (on the plain
# route, the columns of the right-hand side that it touched).  Both
# effects are kept, so the bits are those of the whole-matrix form:
# ``_zero_adds`` gives the finished entries their additions (stopping
# once one leaves them unchanged), and the loops NaN what that form's
# products would have poisoned.

def _zero_adds(x, count: int):
    """x after ``count`` additions of a zero limb value."""
    zero = core.neg(torch.zeros_like(x))
    for _ in range(count):
        y = core.add(x, zero)
        timers.count("syncs", "linalg._zero_adds")
        if torch.equal(y.view(torch.int32), x.view(torch.int32)):
            break
        x = y
    return x


def _nonfinite(a):
    """Per matrix of a (BB, r, c, S): a slot 0 that is not finite."""
    if a.shape[1] == 0 or a.shape[2] == 0:
        return torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    return ~torch.isfinite(a[..., 0].abs().amax(dim=(-2, -1)))


def _poison(out, bad, bad_cols=None):
    """NaN the matrices flagged in ``bad`` (BB,) and the columns
    flagged in ``bad_cols`` (BB, m)."""
    out = torch.where(bad[:, None, None, None], torch.nan, out)
    if bad_cols is not None:
        out = torch.where(bad_cols[:, None, :, None], torch.nan, out)
    return out


def _cholesky_limb_batched(a):
    """Batched blocked limb Cholesky, a (BB, n, n, S): L11 by the
    Cholesky kernel, L21 by the solve kernel on the transposed panel,
    trailing update by a CRT SYRK."""
    BB, n, k = a.shape[0], a.shape[-3], a.shape[-1]
    nb = _PANEL
    if n <= 2 * nb:
        return lk.cholesky_unblocked_batched(a.contiguous())
    npad = (-n) % nb
    mat = _pad_identity(a, npad) if npad else a.clone()
    N = n + npad
    npanels = N // nb
    # N >= 96 puts every whole-matrix update on the CRT route
    didx = torch.arange(nb, device=a.device)
    bad = torch.zeros(BB, dtype=torch.bool, device=a.device)
    for pi in range(npanels):
        with _panel("cholesky"):
            j, e = pi * nb, (pi + 1) * nb
            l11 = lk.cholesky_unblocked_batched(
                mat[:, j:e, j:e].contiguous())
            mat[:, j:e, j:e] = l11
            if e < N:
                inv_d = core.recip(l11[:, didx, didx, :])
                l21 = lk.solve_unblocked_batched(
                    l11, mat[:, e:, j:e].transpose(1, 2).contiguous(),
                    inv_d).transpose(1, 2)
                mat[:, e:, j:e] = l21
                bad |= _nonfinite(l21)
                upd = _product(l21, l21.transpose(1, 2), True, syrk=True)
                mat[:, e:, e:] = core.add(mat[:, e:, e:], core.neg(upd))
            mat[:, j:, j:e] = _zero_adds(mat[:, j:, j:e], npanels - pi)
    rows = torch.arange(N, device=a.device)
    lower = (rows[:, None] >= rows[None, :])[:, :, None]
    out = torch.where(lower, _poison(mat, bad), 0.0)
    return out[:, :n, :n] if npad else out


@_span
def cholesky(a):
    """Lower Cholesky of symmetric positive-definite MP matrices
    (..., n, n, K); a non-PD input gives NaNs."""
    batch = a.shape[:-3]
    flat = a.reshape((-1,) + a.shape[-3:])
    out = _cholesky_limb_batched(flat) if core.is_limb(a) \
        else _cholesky_exp_batched(flat)
    return out.reshape(batch + out.shape[1:])


def _solve_limb_batched(l, b, transpose: bool):
    """Batched blocked triangular solve, l (BB, n, n, S), b (BB, n, m, S):
    per panel one solve-kernel call plus one CRT matmul update of the
    rows still pending."""
    BB, n, k = l.shape[0], l.shape[-3], l.shape[-1]
    m = b.shape[-2]
    nb = _PANEL
    didx = torch.arange(n, device=l.device)
    inv_d = core.recip(l[:, didx, didx, :])
    if n <= 2 * nb:
        return lk.solve_unblocked_batched(l.contiguous(), b.contiguous(),
                                          inv_d, transpose=transpose)
    npad = (-n) % nb
    if npad:
        l = _pad_identity(l, npad)
        x = torch.cat([b, torch.zeros((BB, npad, m, k), dtype=b.dtype,
                                      device=b.device)], dim=1)
        onev = torch.as_tensor(core.one_np(k), device=l.device)
        inv_d = torch.cat([inv_d, onev.expand(BB, npad, k)], dim=1)
    else:
        x = b.clone()
    N = n + npad
    npanels = N // nb
    crt = _int_backend_ok((BB, N, nb, k), m)
    bad = torch.zeros(BB, dtype=torch.bool, device=l.device)
    bad_cols = torch.zeros((BB, m), dtype=torch.bool, device=l.device)
    routine = "solve_t" if transpose else "solve"
    for t in range(npanels):
        with _panel(routine):
            pi = npanels - 1 - t if transpose else t
            j, e = pi * nb, (pi + 1) * nb
            xp = lk.solve_unblocked_batched(
                l[:, j:e, j:e].contiguous(), x[:, j:e].contiguous(),
                inv_d[:, j:e].contiguous(), transpose=transpose)
            # the pending rows: above the panel (L^-T) or below it (L^-1)
            rows = slice(0, j) if transpose else slice(e, N)
            lpart = l[:, j:e, rows].transpose(1, 2) if transpose \
                else l[:, rows, j:e]
            if crt:
                bad |= _nonfinite(xp) | _nonfinite(lpart)
            else:
                bad_cols |= ~torch.isfinite(xp[..., 0]).all(dim=1)
            if lpart.shape[1]:
                x[:, rows] = core.add(x[:, rows],
                                      core.neg(_product(lpart, xp, crt)))
            x[:, j:e] = _zero_adds(xp, npanels - t)
    x = _poison(x, bad, bad_cols)
    return x[:, :n] if npad else x


def _route_solve(l, b, transpose: bool):
    vec = b.dim() == l.dim() - 1
    if vec:
        b = b[..., None, :]
    batch = l.shape[:-3]
    b = b.expand(batch + b.shape[-3:])
    solve = _solve_limb_batched if core.is_limb(l) else _solve_exp_batched
    out = solve(l.reshape((-1,) + l.shape[-3:]),
                b.reshape((-1,) + b.shape[-3:]), transpose)
    out = out.reshape(batch + out.shape[1:])
    return out[..., 0, :] if vec else out


@_span
def solve_lower(l, b):
    """X = L^{-1} B, panel-blocked forward substitution."""
    return _route_solve(l, b, transpose=False)


@_span
def solve_lower_t(l, b):
    """X = L^{-T} B, panel-blocked backward substitution."""
    return _route_solve(l, b, transpose=True)


# ---------------------------------------------------------------------------
# The expansion routes (float64 words): the JAX package's panel loops
# around the column-loop kernels, over a leading batch axis BB
# ---------------------------------------------------------------------------

def _lower_mask(n: int, device):
    rows = torch.arange(n, device=device)
    return (rows[:, None] >= rows[None, :])[:, :, None]


def _cholesky_exp_batched(a):
    """Panel-blocked right-looking Cholesky of a (BB, n, n, K): a
    panel's column loop by the panel kernel, on the panel's rows from
    its pivot block down, then the trailing update, one SYRK of the
    panel added to the whole matrix (the JAX package's loop).  The
    JAX package's panel also carries the rows above it, zeroed; they
    and the pivot block's upper triangle are upper entries, never read
    and dropped at the end, so the factor's bits are the same."""
    n, nb = a.shape[1], _PANEL
    if n <= 2 * nb:
        return ek.exp_cholesky_panel(a)
    npad = (-n) % nb
    mat = _pad_identity(a, npad) if npad else a.clone()
    N = n + npad
    for pi in range(N // nb):
        with _panel("cholesky"):
            j = pi * nb
            C = ek.exp_cholesky_panel(mat[:, j:, j:j + nb])
            mat[:, j:, j:j + nb] = C
            P = torch.zeros_like(mat[:, :, :nb])
            P[:, j + nb:] = C[:, nb:]
            upd = _product(P, P.transpose(1, 2),
                           _int_backend_ok(P.shape[1:], N), syrk=True)
            mat = core.add(mat, core.neg(upd))
    out = torch.where(_lower_mask(N, a.device), mat, 0.0)
    return out[:, :n, :n] if npad else out


def _solve_exp_batched(l, b, transpose: bool):
    """Panel-blocked substitution, l (BB, n, n, K), b (BB, n, m, K):
    per panel one unblocked solve plus one MP matmul update of the
    whole right-hand side (the JAX package's loop)."""
    BB, n, k = l.shape[0], l.shape[1], l.shape[-1]
    m = b.shape[-2]
    nb = _PANEL
    if n <= 2 * nb:
        didx = torch.arange(n, device=l.device)
        return ek.exp_solve_unblocked(l, b, core.recip(l[:, didx, didx, :]),
                                      transpose)
    npad = (-n) % nb
    if npad:
        l = _pad_identity(l, npad)
        b = torch.cat([b, b.new_zeros((BB, npad, m, k))], dim=1)
    N = n + npad
    npanels = N // nb
    didx = torch.arange(N, device=l.device)
    inv_d = core.recip(l[:, didx, didx, :])
    rows = torch.arange(N, device=l.device)
    x = b.clone()
    routine = "solve_t" if transpose else "solve"
    for t in range(npanels):
        with _panel(routine):
            pi = npanels - 1 - t if transpose else t
            j, e = pi * nb, (pi + 1) * nb
            xp = ek.exp_solve_unblocked(l[:, j:e, j:e], x[:, j:e],
                                        inv_d[:, j:e], transpose)
            x[:, j:e] = xp
            if transpose:
                lpart = torch.where((rows < j)[None, :, None], l[:, j:e],
                                    0.0).transpose(1, 2)
            else:
                lpart = torch.where((rows >= e)[:, None, None],
                                    l[:, :, j:e], 0.0)
            upd = _product(lpart, xp, _int_backend_ok(lpart.shape[1:], m))
            x = core.add(x, core.neg(upd))
    return x[:, :n] if npad else x


def use_inverse_panels(l) -> bool:
    """True when matrix-rhs triangular solves go through the explicit
    blocked inverse, as on the accelerator route (always, for limbs)."""
    return core.is_limb(l)


@_span
def lower_inverse(l):
    """T = L^{-1} for lower-triangular L (..., n, n, S), blocked:
    diagonal blocks invert through the solve kernel against an identity
    rhs; off-diagonal block rows are matmuls
    T[i, :i] = -T[i][i] (L[i, :i] T[:i, :i])."""
    batch = l.shape[:-3]
    out = _lower_inverse_batched(l.reshape((-1,) + l.shape[-3:]))
    return out.reshape(batch + out.shape[1:])


def _unblocked_inverse(l, eye, inv_d):
    """L^-1 of small lower-triangular blocks against an identity rhs
    through the solve kernel of the format."""
    if core.is_limb(l):
        return lk.solve_unblocked_batched(l.contiguous(), eye, inv_d)
    return ek.exp_solve_unblocked(l, eye, inv_d)


def _lower_inverse_batched(l):
    BB, n, k = l.shape[0], l.shape[-3], l.shape[-1]
    nb = _PANEL
    dev = l.device
    if n <= 2 * nb:
        didx = torch.arange(n, device=dev)
        inv_d = core.recip(l[:, didx, didx, :])
        eye = _eye(n, k, dev, l.dtype).expand(BB, n, n, k).contiguous()
        return _unblocked_inverse(l, eye, inv_d)
    npad = (-n) % nb
    if npad:
        l = _pad_identity(l, npad)
    N = n + npad
    nblk = N // nb
    dblk = torch.stack([l[:, i * nb:(i + 1) * nb, i * nb:(i + 1) * nb]
                        for i in range(nblk)], dim=1)
    dflat = dblk.reshape(BB * nblk, nb, nb, k).contiguous()
    didx = torch.arange(nb, device=dev)
    inv_d = core.recip(dflat[:, didx, didx, :])
    eye = _eye(nb, k, dev, l.dtype).expand(BB * nblk, nb, nb, k).contiguous()
    tii = _unblocked_inverse(dflat, eye, inv_d).reshape(BB, nblk, nb, nb, k)
    T = torch.zeros((BB, N, N, k), dtype=l.dtype, device=dev)
    # block row i needs the block rows above it whole
    for i in range(nblk):
        with _panel("inverse"):
            T[:, i * nb:(i + 1) * nb, i * nb:(i + 1) * nb] = tii[:, i]
            if i:
                rowL = l[:, i * nb:(i + 1) * nb, :i * nb]
                prod = matmul(rowL, T[:, :i * nb, :i * nb])
                T[:, i * nb:(i + 1) * nb, :i * nb] = core.neg(
                    matmul(tii[:, i], prod))
    return T[:, :n, :n] if npad else T


@_span
def cholesky_solve(l, b):
    """A^{-1} B given A = L L^T."""
    return solve_lower_t(l, solve_lower(l, b))


@_span
def lower_inverse_congruence(l, a):
    """L^{-1} A L^{-T} for symmetric A."""
    z = solve_lower(l, a)
    return transpose(solve_lower(l, transpose(z)))


@_span
def cholesky_condition_estimate(l):
    """(max diag / min diag)^2 over the trailing matrix (batch kept)."""
    d = core.fst(diag(l))
    return (d.amax(dim=-1) / d.amin(dim=-1)) ** 2
