"""Multiprecision tensors for the plain reference, in plain PyTorch.

A value is a signed integer in balanced base-2^20 limbs times a power of
two chosen per element:

    value = sum_j d[..., j] * 2^(20 * (j + e[...])),   -2^19 <= d < 2^19

``d`` is int64 with L limbs (the top one nonzero unless the value is
zero), ``e`` int64 (the exponent of the lowest limb, in limb units).
Additions align the operands and carry in int64; elementwise products
convolve the limbs; matrix products align each row of the left operand
and each column of the right one to their largest element, then form
every pair of limb planes as one float64 matrix product, which is exact
(|limb| <= 2^19, so a product is below 2^38 and a sum over at most 2^15
terms below 2^53), and carry the sums in int64.  Inverses come from
Newton-Schulz steps started at a float64 inverse.  Results are
truncated to L limbs: the relative error of a step is about 2^(-20(L-1))
of its operands' scale, with no rounding from any library but float64
products of small integers.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import math

import mpmath
import torch

BITS = 20
BASE = 1 << BITS
HALF = BASE >> 1
ZERO_E = -(1 << 40)          # exponent of a zero value
_P_BYTES = 1 << 31           # float64 bytes of one pair-product buffer


class MP:
    """A tensor of multiprecision values (see the module docstring)."""

    __slots__ = ("d", "e")

    def __init__(self, d: torch.Tensor, e: torch.Tensor):
        self.d, self.e = d, e

    @property
    def L(self) -> int:
        return self.d.shape[-1]

    @property
    def shape(self):
        return self.d.shape[:-1]

    def __getitem__(self, idx):
        """Index the leading (value) axes; no Ellipsis."""
        return MP(self.d[idx], self.e[idx])

    def reshape(self, *shape):
        return MP(self.d.reshape(*shape, self.L), self.e.reshape(*shape))

    def movedim(self, a: int, b: int):
        nd = len(self.shape)
        a, b = a % nd, b % nd
        return MP(self.d.movedim(a, b), self.e.movedim(a, b))

    def transpose(self, a: int = -2, b: int = -1):
        nd = len(self.shape)
        a, b = a % nd, b % nd
        return MP(self.d.transpose(a, b), self.e.transpose(a, b))

    def expand(self, *shape):
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        return MP(self.d.expand(*shape, self.L),
                  torch.broadcast_to(self.e, shape))


def cat(xs, dim: int):
    nd = len(xs[0].shape)
    dim = dim % nd
    return MP(torch.cat([x.d for x in xs], dim), torch.cat([x.e for x in xs],
                                                           dim))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def _carry(d: torch.Tensor) -> torch.Tensor:
    """Balanced limbs of the same value, with three more top limbs for
    the carries (inputs below 2^62 in magnitude)."""
    d = torch.nn.functional.pad(d, (0, 3))
    while True:
        q = (d + HALF) >> BITS
        if not bool(q.any()):
            return d
        d = d - (q << BITS)
        d[..., 1:] += q[..., :-1]


def _shift_limbs(d: torch.Tensor, s: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[..., i] = d[..., i + s] (zero outside d), for a per-element
    limb offset ``s``."""
    n = d.shape[-1]
    idx = torch.arange(n_out, device=d.device) + s[..., None]
    ok = (idx >= 0) & (idx < n)
    out = torch.gather(d, -1, idx.clamp(0, n - 1))
    return torch.where(ok, out, 0)


def normalize(d: torch.Tensor, e: torch.Tensor, L: int) -> MP:
    """The value sum_j d_j 2^(20(j + e)) (any int64 limbs) as L balanced
    limbs with a nonzero top limb, low limbs truncated."""
    d = _carry(d)
    n = d.shape[-1]
    nz = d != 0
    pos = torch.arange(n, device=d.device)
    top = torch.where(nz, pos, -1).amax(-1)
    zero = top < 0
    s = top - (L - 1)
    out = _shift_limbs(d, s, L)
    e = torch.where(zero, ZERO_E, e + s)
    return MP(torch.where(zero[..., None], 0, out), e)


def align(x: MP, E: torch.Tensor, n: int) -> torch.Tensor:
    """x's limbs expressed at lowest-limb exponent E, n of them (limbs
    of x below E dropped; E broadcasts against x's shape)."""
    E = torch.broadcast_to(E, x.shape)
    s = torch.where(x.e == ZERO_E, 1 << 41, E - x.e)
    return _shift_limbs(x.d, s.clamp(-(1 << 41), 1 << 41), n)


def _top_e(x: MP) -> torch.Tensor:
    """Exponent just above each element's top limb (very low for 0)."""
    return torch.where(x.e == ZERO_E, ZERO_E, x.e + x.L)


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def zeros(shape, L: int, device) -> MP:
    return MP(torch.zeros(*shape, L, dtype=torch.int64, device=device),
              torch.full(tuple(shape), ZERO_E, dtype=torch.int64,
                         device=device))


def _from_int_chunks(chunks, bitpos, L: int) -> MP:
    """Sum of integer chunks (each below 2^21 in magnitude) placed at
    bit positions ``bitpos`` (..., n) as an MP of L limbs; chunks whose
    position lies below the element's window are dropped."""
    nz = chunks != 0
    big = torch.tensor(1 << 60, device=chunks.device)
    hi = torch.where(nz, bitpos, -big).amax(-1)
    zero = hi < -(1 << 59)
    E = torch.div(hi, BITS, rounding_mode="floor") - (L + 1)
    E = torch.where(zero, 0, E)
    rel = bitpos - (BITS * E)[..., None]
    keep = nz & (rel >= 0)
    rel = torch.where(keep, rel, 0)
    t = torch.div(rel, BITS, rounding_mode="floor")
    s = rel - BITS * t
    n = L + 4
    acc = torch.zeros(chunks.shape[:-1] + (n,), dtype=torch.int64,
                      device=chunks.device)
    acc.scatter_add_(-1, t.clamp(0, n - 1),
                     torch.where(keep, chunks << s, 0))
    out = normalize(acc, E, L)
    return MP(torch.where(zero[..., None], 0, out.d),
              torch.where(zero, ZERO_E, out.e))


def from_f64_words(w: torch.Tensor, L: int) -> MP:
    """Exact sum of float64 words (..., K) as an MP of L limbs (words
    below the L-limb window of the largest one are dropped)."""
    w = w.to(torch.float64)
    m, ex = torch.frexp(w)
    M = torch.ldexp(m, torch.full_like(ex, 53)).to(torch.int64)
    mask = (1 << BITS) - 1
    sign = torch.sign(M)
    A = M.abs()
    parts = [sign * (A & mask), sign * ((A >> BITS) & mask),
             sign * (A >> (2 * BITS))]
    base = (ex.to(torch.int64) - 53)
    chunks = torch.cat(parts, -1)
    bitpos = torch.cat([base, base + BITS, base + 2 * BITS], -1)
    return _from_int_chunks(chunks, bitpos, L)


def from_f64(x: torch.Tensor, L: int) -> MP:
    return from_f64_words(x[..., None], L)


def from_int_limbs(limbs: torch.Tensor, bitpos: torch.Tensor, L: int) -> MP:
    """Sum of small integers ``limbs`` (..., n) at bit positions
    ``bitpos`` (..., n)."""
    return _from_int_chunks(limbs.to(torch.int64), bitpos.to(torch.int64), L)


def to_f64(x: MP) -> torch.Tensor:
    """float64 approximation from the top four limbs."""
    d = x.d.to(torch.float64)
    k = min(4, x.L)
    m = torch.zeros(x.shape, dtype=torch.float64, device=x.d.device)
    for i in range(k):
        m = m + torch.ldexp(d[..., x.L - 1 - i],
                            torch.tensor(-BITS * i, device=x.d.device))
    ex = (BITS * (x.e + x.L - 1)).clamp(-4000, 4000)
    out = m * torch.pow(torch.tensor(2.0, dtype=torch.float64,
                                     device=x.d.device),
                        (ex // 2).to(torch.float64))
    return out * torch.pow(torch.tensor(2.0, dtype=torch.float64,
                                        device=x.d.device),
                           (ex - ex // 2).to(torch.float64))


def to_mpf(x: MP, ctx=None):
    """Exact mpmath value of an MP scalar."""
    ctx = ctx or mpmath.mp
    d = [int(v) for v in x.d.reshape(-1).tolist()]
    e = int(x.e.reshape(()).item())
    if e == ZERO_E:
        return ctx.mpf(0)
    mant = 0
    for v in reversed(d):
        mant = mant * BASE + v
    return ctx.ldexp(ctx.mpf(mant), BITS * e)


def from_mpf(v, L: int, device) -> MP:
    """An MP scalar of ``v`` (an mpmath number of any context, an int or
    a float), exactly, then truncated to L limbs."""
    if not hasattr(v, "man"):
        v = mpmath.mpf(v)               # ints and floats convert exactly
    if not v:
        return zeros((), L, device)
    sign, mant, exp, _ = v._mpf_        # v = (-1)^sign * mant * 2^exp
    mant, exp = (-mant if sign else mant), int(exp)
    E = exp // BITS
    mant <<= exp - BITS * E
    limbs = []
    while mant:
        r = mant & (BASE - 1)
        if r >= HALF:
            r -= BASE
        limbs.append(r)
        mant = (mant - r) >> BITS
    drop = max(0, len(limbs) - (L + 2))
    d = torch.tensor(limbs[drop:], dtype=torch.int64, device=device)
    return normalize(d, torch.tensor(E + drop, device=device), L)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def _bcast(a: MP, b: MP):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return a.expand(*shape), b.expand(*shape)


def add(a: MP, b: MP) -> MP:
    a, b = _bcast(a, b)
    L = max(a.L, b.L)
    E = torch.maximum(_top_e(a), _top_e(b)) - (L + 2)
    s = align(a, E, L + 2) + align(b, E, L + 2)
    return normalize(s, E, L)


def neg(a: MP) -> MP:
    return MP(-a.d, a.e)


def sub(a: MP, b: MP) -> MP:
    return add(a, neg(b))


def mul(a: MP, b: MP) -> MP:
    a, b = _bcast(a, b)
    L = a.L
    c = torch.zeros(a.shape + (2 * L,), dtype=torch.int64, device=a.d.device)
    for i in range(L):
        c[..., i:i + L] += a.d[..., i:i + 1] * b.d
    return normalize(c, a.e + b.e, L)


def mul_pow2(a: MP, k: int) -> MP:
    """a * 2^k."""
    q, r = divmod(k, BITS)
    return normalize(a.d << r, a.e + q, a.L)


def where(mask: torch.Tensor, a: MP, b: MP) -> MP:
    a, b = _bcast(a, b)
    return MP(torch.where(mask[..., None], a.d, b.d),
              torch.where(mask, a.e, b.e))


def sum_(a: MP, dim: int) -> MP:
    """Exact sum along ``dim`` (then truncated to L limbs)."""
    nd = len(a.shape)
    dim = dim % nd
    n = a.shape[dim]
    extra = max(1, math.ceil(math.log2(max(n, 2)) / BITS)) + 1
    top = _top_e(a).amax(dim, keepdim=True)
    E = top - (a.L + extra)
    s = align(a, E, a.L + extra).sum(dim)
    return normalize(s, E.squeeze(dim), a.L)


def dot(a: MP, b: MP, dim: int = -1) -> MP:
    return sum_(mul(a, b), dim)


def matmul(a: MP, b: MP) -> MP:
    """(..., n, k) @ (..., k, m), exact products of the row- and
    column-aligned limbs, truncated to L limbs."""
    L = a.L
    k = a.shape[-1]
    if k > (1 << 14):
        raise ValueError(f"matmul: inner size {k} above 2^14")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*batch, *a.shape[-2:])
    b = b.expand(*batch, *b.shape[-2:])
    n, m = a.shape[-2], b.shape[-1]
    er = _top_e(a).amax(-1, keepdim=True) - L            # (..., n, 1)
    ec = _top_e(b).amax(-2, keepdim=True) - L            # (..., 1, m)
    ad = align(a, er, L).to(torch.float64)                # (..., n, k, L)
    bd = align(b, ec, L).to(torch.float64)                # (..., k, m, L)
    A2 = ad.movedim(-1, -3)                               # (..., L, n, k)
    B2 = bd.reshape(*batch, k, m * L)
    c = torch.zeros(*batch, n, m, 2 * L, dtype=torch.int64,
                    device=a.d.device)
    per_limb = max(1, math.prod(batch) * n * m * L * 8)
    step = max(1, min(L, _P_BYTES // per_limb))
    for i0 in range(0, L, step):
        i1 = min(L, i0 + step)
        P = A2[..., i0:i1, :, :].reshape(*batch, (i1 - i0) * n, k) @ B2
        P = P.reshape(*batch, i1 - i0, n, m, L).to(torch.int64)
        for i in range(i0, i1):
            c[..., i:i + L] += P[..., i - i0, :, :, :]
    return normalize(c, er + ec, L)


def eye(n: int, L: int, device, batch=()) -> MP:
    x = torch.eye(n, dtype=torch.float64, device=device).expand(
        *batch, n, n)
    return from_f64(x, L)


def inverse(a: MP, max_steps: int = 12) -> MP:
    """Inverse of a batch of symmetric positive definite matrices
    (..., n, n): Newton-Schulz steps V <- V + V (I - A V) from the
    float64 inverse (by Cholesky) while the residual I - A V keeps
    shrinking quadratically; it stops at the floor that the truncation
    to L limbs sets (about the condition number times 2^(-20(L-1))),
    which has to lie below 2^(-10 L)."""
    L = a.L
    n = a.shape[-1]
    v = from_f64(torch.cholesky_inverse(torch.linalg.cholesky(to_f64(a))),
                 L)
    ident = eye(n, L, a.d.device, a.shape[:-2])
    prev = math.inf
    for _ in range(max_steps):
        r = sub(ident, matmul(a, v))
        err = to_f64(r).abs().amax().item()
        if not math.isfinite(err) or err >= 1.0:
            raise FloatingPointError(f"inverse: residual {err}")
        if err == 0.0 or err > prev * 2.0 ** -BITS:
            break
        v = add(v, matmul(v, r))
        prev = err
    if err > 2.0 ** (-BITS * L / 2):
        raise FloatingPointError(f"inverse: residual {err} after "
                                 f"{max_steps} Newton-Schulz steps")
    return v


def max_abs_f64(x: MP) -> float:
    return float(to_f64(x).abs().amax().item()) if x.d.numel() else 0.0
