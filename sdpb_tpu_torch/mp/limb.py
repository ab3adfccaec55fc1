"""Base-2^9 integer limbs with a per-element exponent, in PyTorch.

The same format as the JAX package's ``mp/limb.py``: an array of shape
(..., 1+L), float32,

  slot 0   exponent code x0, with  e = |x0| - EOFF  in LIMB units
  slot i   limb l_i, an integer-valued float, balanced: |l_i| <~ 270

  value = (sum_{i=1..L} l_i * BETA^(1-i)) * BETA^e,    BETA = 2^9

Limb products are below 2^16 and at most ~50 of them are summed, so
every intermediate stays below 2^24 and float32 arithmetic is exact
whatever the order of summation.  That lets this module write each
operation as a few whole-tensor steps (one outer product plus one
diagonal sum for ``mul``, a gather for the barrel shift) and still
match the JAX forms bit for bit.  Only the rounded steps -- ``_mant3``,
the rsqrt seed of ``sqrt_rsqrt`` and the quotient estimate of ``div``
-- depend on float rounding, and they use the same float32 operations
in the same order.

``-a``, ``a * sign`` and ``where(m, a, 0)`` stay valid limb idioms, as
in the JAX format: negation flips the limbs and leaves |x0|, and the
all-zero vector is the canonical zero.  NaN/Inf limbs propagate and
every renormalization folds ``0 * sum(limbs)`` into slot 0, so an
``isfinite(x[..., 0])`` check sees them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

B = 9                    # bits per limb
BETA = 1 << B            # limb base, 512
HALF_BETA = BETA // 2
EOFF = 16384             # exponent code offset; e = |x0| - EOFF
_INV_BETA = float(np.float32(1.0 / BETA))
_INV_BETA2 = float(np.float32(_INV_BETA * _INV_BETA))
_ZERO_E = -(10 ** 7)     # effective exponent of a zero operand

# Elements per chunk of mul's (..., L, 2L) outer-product buffer: bounds
# its temporary to ~512 MB whatever the batch.
_MUL_CHUNK_FLOATS = 1 << 27


def n_limbs(a) -> int:
    return a.shape[-1] - 1


def slots_for_precision(precision_bits: int) -> int:
    """Trailing-axis size (1 exponent slot + limbs) holding at least
    ``precision_bits`` significant bits plus one guard limb."""
    return 1 + max(3, -(-int(precision_bits) // B) + 1)


def precision_bits(k_slots: int) -> int:
    """Guaranteed significand bits of a (1+L)-slot array."""
    return B * (k_slots - 2) + 1


def _broadcast_pair(a, b):
    if a.shape == b.shape:
        return a, b
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return (a.expand(batch + a.shape[-1:]), b.expand(batch + b.shape[-1:]))


def _em(m):
    return m[..., None]


def _split(a):
    """(exponent e int32, limbs f32 (..., L))."""
    e = (a[..., 0].abs() - EOFF).to(torch.int32)
    return e, a[..., 1:]


def _is_zero_vec(limbs):
    # NaN limbs are not zero (as the JAX max-|l| reduction gives)
    return (limbs == 0.0).all(dim=-1)


def _build(e, limbs):
    """Canonical array: clamped exponent, zero canonicalized, limb
    NaN/Inf folded into slot 0."""
    s = limbs.sum(dim=-1)
    zero = _is_zero_vec(limbs)
    x0 = (e.clamp(-EOFF, EOFF - 1) + EOFF).to(limbs.dtype) + 0.0 * s
    x0 = torch.where(zero, 0.0 * s, x0)
    return torch.cat([x0[..., None], limbs], dim=-1)


def _barrel_shift(limbs, s, left: bool):
    """Per-element limb shift by s >= 0 positions with zero fill: one
    gather (pure data movement, so exact)."""
    n = limbs.shape[-1]
    s = s.clamp(0, n).to(torch.int64)[..., None]
    j = torch.arange(n, device=limbs.device)
    if left:
        src = j + s
        ok = src < n
    else:
        src = j - s
        ok = src >= 0
    out = torch.gather(limbs, -1, src.clamp(0, n - 1).expand(limbs.shape))
    return torch.where(ok, out, 0.0)


def _carry(limbs, passes: int):
    """Carry-propagate toward the leading limb: l = BETA*q + r with r
    balanced, then l_i <- r_i + q_{i+1} (round half to even)."""
    for _ in range(passes):
        q = torch.round(limbs * _INV_BETA)
        r = limbs - q * BETA
        limbs = r + torch.nn.functional.pad(q[..., 1:], (0, 1))
    return limbs


def _leading_zeros(limbs):
    n = limbs.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=limbs.device)
    z = torch.where(limbs != 0.0, idx, n).amin(dim=-1)
    return z, z < n


def _renorm(e_top, ext, L_out: int, passes: int):
    """Carry-propagate ``ext`` (slot j weighs BETA^(e_top - j)), shift
    out leading zeros, truncate or pad to L_out limbs, rebuild."""
    ext = _carry(ext, passes)
    z, any_nz = _leading_zeros(ext)
    ext = _barrel_shift(ext, z, left=True)
    n = ext.shape[-1]
    if n < L_out:
        ext = torch.nn.functional.pad(ext, (0, L_out - n))
    elif n > L_out:
        ext = ext[..., :L_out]
    e = e_top - z
    under = (e < -EOFF) & any_nz
    over = (e >= EOFF) & any_nz
    ext = torch.where(_em(under), 0.0, ext)
    inf = torch.where(ext[..., :1] > 0, math.inf, -math.inf)
    ext = torch.where(_em(over), inf, ext)
    return _build(e, ext)


def _heads(limbs, n_head: int):
    return torch.nn.functional.pad(limbs, (n_head, 0))


def _mant3(limbs):
    """f32 mantissa approximation from the top three limbs."""
    m = limbs[..., 0]
    if limbs.shape[-1] > 1:
        m = m + limbs[..., 1] * _INV_BETA
    if limbs.shape[-1] > 2:
        m = m + limbs[..., 2] * _INV_BETA2
    return m


def _float_limbs(x):
    """Split an f32 array exactly: x = (sum_t l_t BETA^-t) * BETA^e_x
    with 4 integer limbs.  Non-finite/zero x give zero limbs."""
    m, ex = torch.frexp(x)
    ok = torch.isfinite(x) & (x != 0.0)
    m = torch.where(ok, m, 0.0)
    ex = torch.where(ok, ex, 0)
    e_x = -torch.div(-ex, B, rounding_mode="floor")       # ceil(ex / B)
    r = B * e_x - ex                                      # 0..B-1
    u = torch.ldexp(m, -r.to(m.dtype))
    ls = []
    for _ in range(4):
        u = u * BETA
        li = torch.round(u)
        ls.append(li)
        u = u - li
    return torch.where(ok, e_x, 0).to(torch.int32), torch.stack(ls, dim=-1)


# ---------------------------------------------------------------------------
# Construction / inspection
# ---------------------------------------------------------------------------

def zeros(shape, k_slots: int, device) -> torch.Tensor:
    return torch.zeros((*shape, k_slots), dtype=torch.float32, device=device)


def from_float(x, k_slots: int) -> torch.Tensor:
    """Exact conversion of a float tensor into limb format (float64
    values through an exact three-way f32 split)."""
    if x.dtype == torch.float64:
        m64, e64 = torch.frexp(x)
        hi = m64.to(torch.float32)
        r = m64 - hi.to(torch.float64)
        mid = r.to(torch.float32)
        lo = (r - mid.to(torch.float64)).to(torch.float32)
        out = add(add(from_float(hi, k_slots), from_float(mid, k_slots)),
                  from_float(lo, k_slots))
        out = scale_pow2_bits(out, e64.to(torch.int32))
        bad = ~torch.isfinite(x)
        return torch.where(_em(bad), from_float(x.to(torch.float32), k_slots),
                           out)
    x = x.to(torch.float32)
    e_x, ls = _float_limbs(x)
    out = _renorm(e_x, _heads(ls, 1), k_slots - 1, passes=1)
    slot = torch.arange(k_slots, device=x.device)
    infv = torch.where(slot == 0, float(2 * EOFF - 1),
                       torch.where(slot == 1, x[..., None], 0.0))
    out = torch.where(_em(torch.isinf(x)), infv, out)
    return torch.where(_em(torch.isnan(x)), math.nan, out)


def const_word(x, k_slots: int) -> torch.Tensor:
    return from_float(x, k_slots)


def one(k_slots: int) -> np.ndarray:
    out = np.zeros((k_slots,), np.float32)
    out[0] = EOFF
    out[1] = 1.0
    return out


def from_f64_np(x: float, k_slots: int) -> np.ndarray:
    """Host-side exact conversion of a python float."""
    return from_words_np(np.asarray(np.float64(x))[None], k_slots)


def from_words_np(words, k_slots: int) -> np.ndarray:
    """Host-side exact conversion: f64-word expansion arrays (..., K)
    -> limb arrays (..., k_slots).  This is how decimal-parsed problem
    data enters the limb path."""
    words = np.asarray(words, dtype=np.float64)
    lead_shape = words.shape[:-1]
    K = words.shape[-1]
    L = k_slots - 1
    flat = words.reshape(-1, K)
    n = flat.shape[0]
    m, ex = np.frexp(flat)
    m53 = np.round(m * 2.0 ** 53).astype(np.int64)
    lw = ex - 53
    finite = np.isfinite(flat).all(axis=1)
    nzw = flat != 0.0
    any_nz = nzw.any(axis=1)
    hi_bit = np.where(nzw, ex, _ZERO_E).max(axis=1)
    e_top = -(-(hi_bit + 1) // B)
    n_ext = L + 3
    acc = np.zeros((n, n_ext), dtype=np.int64)
    sgn = np.sign(m53)
    mag = np.abs(m53)
    for w in range(K):
        if not np.any(nzw[:, w]):
            continue
        for j in range(1, n_ext):
            sh = (B * (e_top - j)) - lw[:, w]
            v = np.where(
                (sh > -B) & (sh < 53),
                np.where(sh >= 0,
                         mag[:, w] >> np.clip(sh, 0, 62),
                         mag[:, w] << np.clip(-sh, 0, B - 1)) % BETA,
                0)
            acc[:, j] += sgn[:, w] * v
    for _ in range(3):
        q = (acc + HALF_BETA) >> B
        acc = acc - (q << B)
        acc[:, :-1] += q[:, 1:]
    nz = acc != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), n_ext)
    cols = first[:, None] + np.arange(L)[None, :]
    out_l = np.where(cols < n_ext,
                     np.take_along_axis(acc, np.minimum(cols, n_ext - 1),
                                        axis=1), 0).astype(np.float32)
    e = np.where(any_nz, e_top - first, 0)
    out = np.zeros((n, k_slots), dtype=np.float32)
    out[:, 1:] = out_l
    out[:, 0] = np.where(any_nz, e + EOFF, 0.0)
    bad = ~finite
    if np.any(bad):
        out[bad] = np.nan
        out[bad, 1] = np.where(np.isinf(flat[bad, 0]), flat[bad, 0],
                               np.nan).astype(np.float32)
    return out.reshape(*lead_shape, k_slots)


def to_mpf(a, ctx=None):
    """Exact mpmath value of a limb SCALAR (host)."""
    import mpmath

    a = np.asarray(a, dtype=np.float64)
    assert a.ndim == 1, a.shape
    if ctx is None:
        ctx = mpmath.mp.clone()
        ctx.prec = B * (a.shape[0] + 8)
    if not np.isfinite(a).all():
        if np.isnan(a[1:]).any() or np.isnan(a[0]):
            return ctx.mpf("nan")
        return ctx.mpf("+inf") if a[1] > 0 else ctx.mpf("-inf")
    e = int(abs(a[0])) - EOFF
    L = a.shape[0] - 1
    mant = 0
    for l in a[1:]:
        mant = mant * BETA + int(l)
    if mant == 0:
        return ctx.mpf(0)
    return ctx.mpf(mant) * ctx.mpf(2) ** (B * (e - L + 1))


def fst(a):
    """f32 approximation (saturates to +-inf/0 outside f32 range)."""
    e, limbs = _split(a)
    m = _mant3(limbs)
    eb = B * e
    h1 = torch.div(eb, 2, rounding_mode="floor").clamp(-148, 127)
    h2 = (eb - h1).clamp(-148, 127)
    return m * torch.exp2(h1.to(m.dtype)) * torch.exp2(h2.to(m.dtype))


approx = fst


def lead(a):
    """Monotonic f32 sort key ~ sign * (log2|value| + OFFSET)."""
    e, limbs = _split(a)
    m = _mant3(limbs)
    am = m.abs()
    logv = B * e.to(m.dtype) + torch.log2(am.clamp_min(1e-38))
    off = float(np.float32(2 * EOFF * B + 64))
    key = torch.sign(m) * (logv + off)
    key = torch.where(am == 0.0, 0.0, key)
    key = torch.where(torch.isnan(m), math.nan, key)
    return torch.where(torch.isfinite(a[..., 0]), key, m)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def _kernels():
    """The elementwise CUDA kernels' wrappers (imported lazily: that
    module imports this one)."""
    from ..ops import limb_kernels

    return limb_kernels


def add(a, b):
    """a + b.  CUDA tensors take the elementwise kernel."""
    if a.is_cuda:
        return _kernels().limb_add(a, b)
    return add_plain(a, b)


def add_plain(a, b):
    """Plain PyTorch version of ``add`` (any device)."""
    L = n_limbs(a)
    assert n_limbs(b) == L, (a.shape, b.shape)
    a, b = _broadcast_pair(a, b)
    ea, la = _split(a)
    eb, lb = _split(b)
    ea_ = torch.where(_is_zero_vec(la), _ZERO_E, ea)
    eb_ = torch.where(_is_zero_vec(lb), _ZERO_E, eb)
    e = torch.maximum(ea_, eb_)
    la = _barrel_shift(la, e - ea_, left=False)
    lb = _barrel_shift(lb, e - eb_, left=False)
    out = _renorm(e + 1, _heads(la + lb, 1), L, passes=1)
    nan = ~(torch.isfinite(a[..., 0]) & torch.isfinite(b[..., 0]))
    return torch.where(_em(nan), math.nan, out)


def neg(a):
    return -a


def sub(a, b):
    return add(a, -b)


def _conv(la, lb, n_out: int):
    """acc[..., k] = sum_{i+j=k} la_i lb_j for k < n_out, exact: one
    outer product and one anti-diagonal sum (row i of the outer product
    is shifted right by i through a flat reshape)."""
    L = la.shape[-1]
    outer = la[..., :, None] * lb[..., None, :]              # (..., L, L)
    padded = torch.nn.functional.pad(outer, (0, L))          # (..., L, 2L)
    flat = padded.reshape(*outer.shape[:-2], 2 * L * L)[..., :L * (2 * L - 1)]
    skew = flat.reshape(*outer.shape[:-2], L, 2 * L - 1)
    acc = skew.sum(dim=-2)
    if acc.shape[-1] >= n_out:
        return acc[..., :n_out]
    return torch.nn.functional.pad(acc, (0, n_out - acc.shape[-1]))


def mul(a, b):
    """Truncated product; relative error < ~2^-(B*(L-1)).  CUDA tensors
    take the elementwise kernel."""
    if a.is_cuda:
        return _kernels().limb_mul(a, b)
    return mul_plain(a, b)


def mul_plain(a, b):
    """Plain PyTorch version of ``mul`` (any device)."""
    L = n_limbs(a)
    assert n_limbs(b) == L, (a.shape, b.shape)
    a, b = _broadcast_pair(a, b)
    batch = a.shape[:-1]
    count = math.prod(batch)
    per = 2 * L * L
    if count * per > _MUL_CHUNK_FLOATS and count > 1:
        a2 = a.reshape(count, L + 1)
        b2 = b.reshape(count, L + 1)
        step = max(1, _MUL_CHUNK_FLOATS // per)
        parts = [_mul_flat(a2[i:i + step], b2[i:i + step])
                 for i in range(0, count, step)]
        return torch.cat(parts, dim=0).reshape(*batch, L + 1)
    return _mul_flat(a, b)


def _mul_flat(a, b):
    L = n_limbs(a)
    ea, la = _split(a)
    eb, lb = _split(b)
    acc = _conv(la, lb, L + 2)
    out = _renorm(ea + eb + 2, _heads(acc, 2), L, passes=3)
    nan = ~(torch.isfinite(a[..., 0]) & torch.isfinite(b[..., 0]))
    return torch.where(_em(nan), math.nan, out)


def _scalar_operand(a, x):
    x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
    if x.dim() == a.dim() and x.shape[-1] == 1:
        x = x[..., 0]
    return x.expand(a.shape[:-1])


def mul_float(a, x):
    """MP * float tensor (x treated as exact f32); 4-limb short conv."""
    L = n_limbs(a)
    x = _scalar_operand(a, x)
    ea, la = _split(a)
    e_x, xs = _float_limbs(x)
    n_out = L + 2
    lap = torch.nn.functional.pad(la, (0, 2))
    acc = torch.zeros(la.shape[:-1] + (n_out,), dtype=la.dtype,
                      device=la.device)
    for t in range(min(4, n_out)):
        contrib = xs[..., t:t + 1] * lap[..., :n_out - t]
        acc = acc + torch.nn.functional.pad(contrib, (t, 0))
    out = _renorm(ea + e_x - 1 + 2, _heads(acc, 2), L, passes=3)
    out = torch.where(_em(x == 0.0), 0.0, out)
    nan = ~(torch.isfinite(a[..., 0]) & torch.isfinite(x))
    return torch.where(_em(nan), math.nan, out)


def mul_pow2(a, c):
    """Multiply by (a tensor of) powers of two -- exact."""
    if not torch.is_tensor(c) and np.ndim(c) == 0 and float(c) == 1.0:
        return a
    return mul_float(a, c)


def _carry_keep_head(limbs, passes: int):
    """Carry pass that treats slot 0 as a wide accumulator."""
    for _ in range(passes):
        q = torch.round(limbs * _INV_BETA)
        q = torch.cat([torch.zeros_like(q[..., :1]), q[..., 1:]], dim=-1)
        r = limbs - q * BETA
        limbs = r + torch.nn.functional.pad(q[..., 1:], (0, 1))
    return limbs


def div(a, b):
    """Long division with redundant balanced quotient digits.  CUDA
    tensors take the elementwise kernel."""
    if a.is_cuda:
        return _kernels().limb_div(a, b)
    return div_plain(a, b)


def div_plain(a, b):
    """Plain PyTorch version of ``div`` (any device)."""
    L = n_limbs(a)
    assert n_limbs(b) == L, (a.shape, b.shape)
    a, b = _broadcast_pair(a, b)
    ea, la = _split(a)
    eb, lb = _split(b)
    bhat = _mant3(lb)
    inv_bhat = torch.where(bhat == 0.0, math.inf, 1.0 / bhat)
    nd = L + 2
    r = la
    qs = []
    for _ in range(nd):
        rhat = r[..., 0] + r[..., 1] * _INV_BETA + r[..., 2] * _INV_BETA2
        q = torch.round(rhat * inv_bhat)
        r = r - q[..., None] * lb
        r = _carry_keep_head(r, 1)
        head = r[..., 0] * BETA
        r = torch.cat([(r[..., 1] + head)[..., None], r[..., 2:],
                       torch.zeros_like(r[..., :1])], dim=-1)
        qs.append(q)
    qd = torch.stack(qs, dim=-1)
    out = _renorm(ea - eb + 2, _heads(qd, 2), L, passes=3)
    bzero = _is_zero_vec(lb)
    azero = _is_zero_vec(la)
    slot = torch.arange(L + 1, device=a.device)
    sgn_inf = torch.where(la[..., 0] < 0, -math.inf, math.inf)[..., None]
    infv = torch.where(slot == 1, sgn_inf, math.nan)
    out = torch.where(_em(bzero & ~azero), infv, out)
    out = torch.where(_em(bzero & azero), math.nan, out)
    nan = ~(torch.isfinite(a[..., 0]) & torch.isfinite(b[..., 0]))
    return torch.where(_em(nan), math.nan, out)


def recip(b):
    return div(_ones_like(b), b)


def recip_plain(b):
    """Plain PyTorch version of ``recip`` (any device)."""
    return div_plain(_ones_like(b), b)


def _ones_like(b):
    ones = torch.ones(b.shape[:-1], dtype=torch.float32, device=b.device)
    return from_float(ones, b.shape[-1])


def newton_steps(L: int) -> int:
    """Newton iterations of ``sqrt_rsqrt`` for L limbs."""
    return max(3, int(np.ceil(np.log2(max(2.0, B * L / 11.0)))))


def sqrt_rsqrt(a):
    """(sqrt(a), 1/sqrt(a)) by Newton on 1/sqrt + one Heron correction
    for the sqrt.  Negative -> NaN; zero -> (0, +inf).  The seed is
    1/sqrtf of the f32 mantissa, as in the CUDA kernels."""
    return _sqrt_rsqrt(a, add, mul)


def sqrt_rsqrt_plain(a):
    """Plain PyTorch version of ``sqrt_rsqrt`` (any device)."""
    return _sqrt_rsqrt(a, add_plain, mul_plain)


def _sqrt_rsqrt(a, add_, mul_):
    L = n_limbs(a)
    k_slots = a.shape[-1]
    ea, la = _split(a)
    m = _mant3(la)
    e2 = torch.div(ea, 2, rounding_mode="floor")
    rem = ea - 2 * e2
    mm = m * torch.where(rem == 1, float(BETA), 1.0)
    y0 = 1.0 / torch.sqrt(mm)
    y = scale_limb_exp(from_float(y0, k_slots), -e2)
    one = from_float(torch.ones_like(m), k_slots)
    for _ in range(newton_steps(L)):
        ay2 = mul_(a, mul_(y, y))
        corr = mul_float(mul_(y, add_(-ay2, one)), 0.5)
        y = add_(y, corr)
    s = mul_(a, y)
    s = add_(s, mul_float(mul_(add_(a, -mul_(s, s)), y), 0.5))
    azero = _em(_is_zero_vec(la))
    inf = from_float(torch.full(a.shape[:-1], math.inf, device=a.device),
                     k_slots)
    return torch.where(azero, 0.0, s), torch.where(azero, inf, y)


def sqrt(a):
    return sqrt_rsqrt(a)[0]


def add_float(a, x):
    return add(a, from_float(_scalar_operand(a, x), a.shape[-1]))


def scale_limb_exp(a, d):
    """a * BETA^d for integer (tensor) d -- exact, exponent-only."""
    e, limbs = _split(a)
    nz = ~_is_zero_vec(limbs)
    e = torch.where(nz, e + d, e)
    out = _build(e, limbs)
    return torch.where(_em(~torch.isfinite(a[..., 0])), a, out)


def scale_pow2_bits(a, t):
    """a * 2^t for integer (tensor) bit shift t -- exact."""
    t = torch.as_tensor(t, dtype=torch.int32, device=a.device)
    t = t.expand(a.shape[:-1])
    q = torch.div(t, B, rounding_mode="floor")
    r = t - q * B
    e, limbs = _split(a)
    limbs = limbs * torch.exp2(r.to(limbs.dtype))[..., None]
    out = _renorm(e + q + 1, _heads(limbs, 1), n_limbs(a), passes=1)
    return torch.where(_em(~torch.isfinite(a[..., 0])), math.nan, out)


def exponent_bits(a):
    """int32 upper bound: |value| < 2^exponent_bits."""
    e, limbs = _split(a)
    return torch.where(_is_zero_vec(limbs), _ZERO_E, B * (e + 1))


# ---------------------------------------------------------------------------
# Comparisons / elementwise utilities
# ---------------------------------------------------------------------------

def abs_(a):
    return a * torch.where(a[..., 1:2] < 0, -1.0, 1.0)


def cmp_lt(a, b):
    return sub(a, b)[..., 1] < 0


def cmp_leq(a, b):
    return sub(a, b)[..., 1] <= 0


def max_abs(a, axes=None):
    """max |a| over batch axes via the monotonic lead key."""
    aa = abs_(a)
    key = lead(aa)
    if axes is None:
        flat = aa.reshape(-1, a.shape[-1])
        return flat[torch.argmax(key.reshape(-1))]
    nb = a.dim() - 1
    axes = tuple(ax % nb for ax in axes)
    keep = tuple(ax for ax in range(nb) if ax not in axes)
    m = aa.permute(axes + keep + (nb,))
    red = math.prod(a.shape[ax] for ax in axes)
    m = m.reshape((red,) + m.shape[len(axes):])
    kk = key.permute(axes + keep).reshape(
        (red,) + tuple(a.shape[ax] for ax in keep))
    idx = torch.argmax(kk, dim=0)
    return torch.take_along_dim(m, idx[None, ..., None], dim=0)[0]


# ---------------------------------------------------------------------------
# Digitization for the exact integer CRT pipeline (ops/exact.py)
# ---------------------------------------------------------------------------

def _carry8(acc, passes: int):
    """Balanced base-256 carry normalization of int32 digits."""
    for _ in range(passes):
        d = torch.bitwise_and(acc + 128, 255) - 128
        cy = torch.bitwise_right_shift(acc - d, 8)
        acc = d + torch.nn.functional.pad(cy[..., :-1], (1, 0))
    return acc


def digits_dev(x, shift_bits: int, n_digits: int):
    """Limb array with |value| <= 1 -> balanced int32 base-256 digits
    (..., n_digits), least significant first.  Integer-exact."""
    e, limbs = _split(x)
    L = limbs.shape[-1]
    li = limbs.to(torch.int32)
    sgn = torch.where(li < 0, -1, 1).to(torch.int32)
    mag = li.abs()
    t8 = 8 * torch.arange(n_digits, dtype=torch.int32, device=x.device)
    acc = torch.zeros(x.shape[:-1] + (n_digits,), dtype=torch.int32,
                      device=x.device)
    for j in range(L):
        p = shift_bits + B * (e - j)
        sh = t8 - p[..., None]
        mj = mag[..., j][..., None]
        right = torch.bitwise_right_shift(mj, sh.clamp(0, 30))
        left = torch.bitwise_left_shift(mj, (-sh).clamp(0, 7))
        v = torch.where(sh >= 0, right, left) & 255
        v = torch.where((sh > B + 1) | (sh <= -8), 0, v)
        acc = acc + sgn[..., j][..., None] * v
    return _carry8(acc, 3)


def planes_to_limb(planes, ref_bits: int, k_slots: int):
    """Carry-normalized balanced base-256 digit planes (..., P,
    least-significant-first; |plane| < 2^13) -> limb array of
    value * 2^-ref_bits."""
    P = planes.shape[-1]
    L = k_slots - 1
    top_bit = 8 * P - ref_bits
    e_top = -(-top_bit // B)
    pf = planes.to(torch.int32)
    sgn = torch.where(pf < 0, -1, 1).to(torch.int32)
    mag = pf.abs()
    n_ext = L + 2 + max(0, -(-top_bit // B))
    out_limbs = []
    for j in range(n_ext):
        lo = B * (e_top - 1 - j) + ref_bits
        acc = None
        for t in range(P):
            sh = lo - 8 * t
            if sh >= 14 or sh <= -B:
                continue
            if sh >= 0:
                v = torch.bitwise_right_shift(mag[..., t], sh) & (BETA - 1)
            else:
                v = torch.bitwise_left_shift(mag[..., t], -sh) & (BETA - 1)
            term = sgn[..., t] * v
            acc = term if acc is None else acc + term
        if acc is None:
            acc = torch.zeros(planes.shape[:-1], dtype=torch.int32,
                              device=planes.device)
        out_limbs.append(acc.to(torch.float32))
    ext = _heads(torch.stack(out_limbs, dim=-1), 2)
    e_arr = torch.full(planes.shape[:-1], e_top + 1, dtype=torch.int32,
                       device=planes.device)
    return _renorm(e_arr, ext, L, passes=3)
