"""The MP API the solver calls, for both word formats.

As in the JAX package's ``mp/core.py``, the dtype of an MP array says
its format:

- float32 arrays are the base-2^9 limb format (``mp/limb.py``);
- float64 arrays are word expansions: K float64 words in decreasing
  order of magnitude whose exact sum is the value, kept nonoverlapping
  by error-free transforms (two_sum, Dekker's two_prod) and the CAMPARY
  renormalization (VecSum, then VecSumErrBranch).  The card's float64
  add, mul and div round to nearest as IEEE says, so the transforms
  hold there as on the CPU.

The expansion functions below are the plain PyTorch versions, written
op for op as the JAX package writes them (the same merge network, the
same level order of the partial products, the same two_sum chains), so
that results agree bit for bit.  ``add``, ``mul``, ``div``, ``add_f64``
and ``mul_f64`` launch one CUDA kernel each for tensors on the card
(``ops/expansion_kernels.py``) and run these plain versions for tensors
on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limb as _limb
from ..utils import timers

_span = timers.span("glue")

# The Dekker splitting constant 2^27 + 1 of float64 words.
_SPLITTER = 134217729.0
WORD_BITS = 53


def is_limb(a) -> bool:
    return a.dtype == torch.float32


def _limb_dtype(dtype) -> bool:
    return dtype in (torch.float32, np.float32, "float32") or (
        isinstance(dtype, np.dtype) and dtype == np.float32)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a format given as a torch/numpy dtype or name."""
    return torch.float32 if _limb_dtype(dtype) else torch.float64


def precision_bits_of(k: int, dtype=torch.float32) -> int:
    """Significand bits carried by a k-slot MP array of this dtype."""
    if _limb_dtype(dtype):
        return _limb.precision_bits(k)
    return WORD_BITS * k


def _kernels():
    """The expansion kernels' wrappers (imported lazily: that module
    imports this one)."""
    from ..ops import expansion_kernels

    return expansion_kernels


# ---------------------------------------------------------------------------
# Construction / inspection
# ---------------------------------------------------------------------------

def zeros(shape, k: int, device, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((*shape, k), dtype=torch_dtype(dtype), device=device)


def one_np(k: int, dtype=torch.float32) -> np.ndarray:
    """Host-side constant 1 in the given format."""
    if _limb_dtype(dtype):
        return _limb.one(k)
    out = np.zeros((k,), np.float64)
    out[0] = 1.0
    return out


def from_f64_np(x: float, k: int, dtype=torch.float32) -> np.ndarray:
    """Host-side exact split of a python float into the format."""
    if _limb_dtype(dtype):
        return _limb.from_f64_np(x, k)
    words = np.zeros(k, dtype=np.float64)
    words[0] = np.float64(x)
    return words


def const_word(x, k: int, dtype=torch.float32) -> torch.Tensor:
    """MP constant from a value exactly representable in one word."""
    if _limb_dtype(dtype):
        return _limb.const_word(x, k)
    x = torch.as_tensor(x, dtype=torch.float64)
    return torch.cat([x[..., None], x.new_zeros(x.shape + (k - 1,))], dim=-1)


def approx(a):
    """Float approximation in the word dtype (words summed from the
    least significant)."""
    if is_limb(a):
        return _limb.fst(a)
    out = a[..., -1]
    for i in range(a.shape[-1] - 2, -1, -1):
        out = out + a[..., i]
    return out


def fst(a):
    """Leading word (a word-dtype approximation of the value)."""
    if is_limb(a):
        return _limb.fst(a)
    return a[..., 0]


def lead(a):
    """Monotonic float sort key of the value."""
    if is_limb(a):
        return _limb.lead(a)
    return a[..., 0]


def change_k(a, k: int):
    """Truncate (renormalizing) or zero-extend the word count."""
    k0 = a.shape[-1]
    if k == k0:
        return a
    if k > k0:
        return torch.nn.functional.pad(a, (0, k - k0))
    return renorm_words(a, k)


# ---------------------------------------------------------------------------
# Error-free transforms
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a+b) (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """s + e == a + b exactly when |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a*b) (Dekker, no FMA)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


# ---------------------------------------------------------------------------
# Renormalization
# ---------------------------------------------------------------------------

def _vecsum(m):
    """Bottom-up two_sum chain over the word axis (exact)."""
    n = m.shape[-1]
    s = m[..., n - 1]
    errs = [None] * (n - 1)
    for i in range(n - 2, -1, -1):
        s, errs[i] = two_sum(m[..., i], s)
    return torch.stack([s] + errs, dim=-1)


def _vecsum_err_branch(m, k: int):
    """CAMPARY VecSumErrBranch with predicated writes: walk top-down
    with fast_two_sum and emit a word only where the link's error is
    nonzero; the last residual lands in the next free slot."""
    n = m.shape[-1]
    batch = m.shape[:-1]
    slots = m.new_zeros(batch + (k,))
    j = torch.zeros(batch, dtype=torch.int64, device=m.device)
    kidx = torch.arange(k, device=m.device)
    e = m[..., 0]
    for i in range(1, n):
        r, e2 = fast_two_sum(e, m[..., i])
        emit = (e2 != 0.0) & (j < k - 1)
        slots = torch.where((emit[..., None] & (j[..., None] == kidx)),
                            r[..., None], slots)
        j = j + emit.to(torch.int64)
        e = torch.where(emit, e2, r)
    return torch.where(j[..., None] == kidx, e[..., None], slots)


def _bitonic_merge_desc(m):
    """Sort a |.|-bitonic sequence into descending |.| order with the
    static bitonic merge network (n a power of two): in each stage the
    pair (i, i + d) stays unless |m_i| >= |m_{i+d}| fails."""
    n = m.shape[-1]
    assert n & (n - 1) == 0, n
    batch = m.shape[:-1]
    d = n // 2
    while d >= 1:
        r = m.reshape(*batch, n // (2 * d), 2, d)
        pm = r.flip(-2)
        ordered = r[..., 0:1, :].abs() >= r[..., 1:2, :].abs()
        m = torch.where(ordered, r, pm).reshape(*batch, n)
        d //= 2
    return m


def merge_desc(a, b):
    """Merge two descending-|.| word sequences into one (bitonic input
    [a | zeros | b reversed], padded to a power of two)."""
    na, nb = a.shape[-1], b.shape[-1]
    n = 1 << (na + nb - 1).bit_length()
    pad = a.new_zeros(a.shape[:-1] + (n - na - nb,))
    return _bitonic_merge_desc(torch.cat([a, pad, b.flip(-1)], dim=-1))


def renorm_words(words, k: int, sort: bool = True, passes: int = 1):
    """Renormalize word arrays (a list, or one tensor with the word
    axis last) into a K-word nonoverlapping expansion.  ``sort`` orders
    the words by decreasing magnitude first (a stable sort, as
    ``jnp.argsort``)."""
    if torch.is_tensor(words):
        m = words
    else:
        ws = torch.broadcast_tensors(*[torch.as_tensor(w) for w in words])
        m = torch.stack(ws, dim=-1)
    if m.shape[-1] == 1:
        return torch.nn.functional.pad(m, (0, k - 1))
    if sort:
        order = torch.argsort(-m.abs(), dim=-1, stable=True)
        m = torch.take_along_dim(m, order, dim=-1)
    for _ in range(passes):
        m = _vecsum(m)
    return _vecsum_err_branch(m, k)


# ---------------------------------------------------------------------------
# The five kernel operations: plain versions
# ---------------------------------------------------------------------------

def _pair(a, b):
    return torch.broadcast_tensors(a, b) if a.shape != b.shape else (a, b)


def _scalar_operand(a, x):
    """A float operand as a batch-shaped tensor of a's dtype: scalars
    and batch-broadcastable tensors (a trailing axis of 1 is dropped
    when x has a's rank), as ``limb.mul_float`` takes them."""
    x = torch.as_tensor(x, dtype=a.dtype, device=a.device)
    if x.dim() == a.dim() and x.shape[-1] == 1:
        x = x[..., 0]
    return x.expand(a.shape[:-1])


def add_plain(a, b):
    """Plain PyTorch version of the expansion ``add``."""
    k = a.shape[-1]
    assert b.shape[-1] == k, (a.shape, b.shape)
    a, b = _pair(a, b)
    if k == 1:
        return a + b
    if k == 2:
        # AccurateDWPlusDW (Joldes-Muller-Popescu)
        s, e = two_sum(a[..., 0], b[..., 0])
        t, te = two_sum(a[..., 1], b[..., 1])
        e = e + t
        s, e = fast_two_sum(s, e)
        e = e + te
        s, e = fast_two_sum(s, e)
        return torch.stack([s, e], dim=-1)
    return renorm_words(merge_desc(a, b), k, sort=False)


def add_f64_plain(a, x):
    """Plain PyTorch version of ``add_f64`` (x exact in float64)."""
    k = a.shape[-1]
    x = _scalar_operand(a, x)
    if k == 1:
        return a + x[..., None]
    return renorm_words(torch.cat([a, x[..., None]], dim=-1), k)


@functools.lru_cache(maxsize=None)
def _mul_order(k: int):
    """Indices into the 2 k^2 concatenation [p (k*k), e (k*k)] of the
    partial products with level <= k (p[i,j] has level i+j, e[i,j]
    level i+j+1), stably sorted by level."""
    lvl_p = (np.arange(k)[:, None] + np.arange(k)[None, :]).ravel()
    lvl = np.concatenate([lvl_p, lvl_p + 1])
    keep = np.nonzero(lvl <= k)[0]
    order = keep[np.argsort(lvl[keep], kind="stable")]
    return tuple(order.tolist())


@functools.lru_cache(maxsize=None)
def _mul_order_tensor(k: int, device) -> torch.Tensor:
    return torch.tensor(_mul_order(k), dtype=torch.int64, device=device)


def mul_plain(a, b):
    """Plain PyTorch version of the expansion ``mul`` (truncated:
    partial products below level k are dropped)."""
    k = a.shape[-1]
    assert b.shape[-1] == k, (a.shape, b.shape)
    a, b = _pair(a, b)
    if k == 1:
        return a * b
    if k == 2:
        p, e = two_prod(a[..., 0], b[..., 0])
        e = e + (a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0])
        p, e = fast_two_sum(p, e)
        return torch.stack([p, e], dim=-1)
    p, e = two_prod(a[..., :, None], b[..., None, :])      # (..., k, k)
    words = torch.cat([p.reshape(*p.shape[:-2], k * k),
                       e.reshape(*e.shape[:-2], k * k)], dim=-1)
    words = words.index_select(-1, _mul_order_tensor(k, a.device))
    return renorm_words(words, k, sort=False)


@functools.lru_cache(maxsize=None)
def _mul_f64_order(k: int, device) -> torch.Tensor:
    """[p_0, p_1, e_0, p_2, e_1, ...]: p_i has level i, e_i level i+1."""
    order = np.empty(2 * k - 1, dtype=np.int64)
    order[0] = 0
    order[1::2] = np.arange(1, k)
    order[2::2] = k + np.arange(k - 1)
    return torch.tensor(order, device=device)


def mul_f64_plain(a, x):
    """Plain PyTorch version of ``mul_f64`` (x exact in float64)."""
    k = a.shape[-1]
    x = _scalar_operand(a, x)
    if k == 1:
        return a * x[..., None]
    p, e = two_prod(a, x[..., None])
    words = torch.cat([p, e[..., :-1]], dim=-1)
    words = words.index_select(-1, _mul_f64_order(k, a.device))
    return renorm_words(words, k, sort=False)


def div_plain(a, b):
    """Plain PyTorch version of the expansion ``div``: K + 1 quotient
    words by long division (r <- r - b q_i), then renormalized."""
    k = a.shape[-1]
    a, b = _pair(a, b)
    if k == 1:
        return a / b
    b0 = b[..., 0]
    r = a
    qs = []
    for _ in range(k + 1):
        qi = r[..., 0] / b0
        r = add_plain(r, -mul_f64_plain(b, qi))
        qs.append(qi)
    return renorm_words(torch.stack(qs, dim=-1), k, sort=False)


# ---------------------------------------------------------------------------
# Arithmetic (dispatch: limbs, expansion kernels on the card, plain on CPU)
# ---------------------------------------------------------------------------

@_span
def add(a, b):
    if is_limb(a):
        return _limb.add(a, b)
    if a.is_cuda:
        return _kernels().exp_add(a, b)
    return add_plain(a, b)


@_span
def add_f64(a, x):
    """MP + plain float tensor (x exact in the word dtype)."""
    if is_limb(a):
        return _limb.add_float(a, x)
    if a.is_cuda:
        return _kernels().exp_add_f64(a, x)
    return add_f64_plain(a, x)


@_span
def neg(a):
    return -a


@_span
def sub(a, b):
    return add(a, -b)


@_span
def mul(a, b):
    if is_limb(a):
        return _limb.mul(a, b)
    if a.is_cuda:
        return _kernels().exp_mul(a, b)
    return mul_plain(a, b)


@_span
def mul_f64(a, x):
    """MP * plain float tensor (x exact in the word dtype)."""
    if is_limb(a):
        return _limb.mul_float(a, x)
    if a.is_cuda:
        return _kernels().exp_mul_f64(a, x)
    return mul_f64_plain(a, x)


@_span
def mul_scalar(a, s):
    """Multiply by a float or by an MP scalar (a tensor of K words)."""
    if torch.is_tensor(s) and s.dim() >= 1 and s.shape[-1] == a.shape[-1] \
            and s.dtype == a.dtype:
        return mul(a, s.expand(a.shape))
    return mul_f64(a, s)


@_span
def mul_pow2(a, c):
    """Exact multiply by (a tensor of) powers of two."""
    if is_limb(a):
        return _limb.mul_pow2(a, c)
    return a * _scalar_operand(a, c)[..., None]


@_span
def div(a, b):
    if is_limb(a):
        return _limb.div(a, b)
    if a.is_cuda:
        return _kernels().exp_div(a, b)
    return div_plain(a, b)


@_span
def recip(b):
    if is_limb(b):
        return _limb.recip(b)
    one = const_word(torch.ones(b.shape[:-1], dtype=b.dtype,
                                device=b.device), b.shape[-1], b.dtype)
    return div(one, b)


def _seed(w0, k: int):
    """A first-word seed as a K-word expansion."""
    return torch.cat([w0[..., None], w0.new_zeros(w0.shape + (k - 1,))],
                     dim=-1)


def newton_steps(k: int) -> int:
    """Newton iterations of the expansion ``sqrt_rsqrt`` at k words."""
    return max(1, (k * WORD_BITS // (WORD_BITS - 3)).bit_length())


@_span
def sqrt_rsqrt(a):
    """(sqrt(a), 1/sqrt(a)): Newton on 1/sqrt from the first word's
    rsqrt, then one Heron correction for the sqrt.  Negative -> NaN."""
    if is_limb(a):
        return _limb.sqrt_rsqrt(a)
    k = a.shape[-1]
    if k == 1:
        return torch.sqrt(a), torch.rsqrt(a)
    y = _seed(torch.rsqrt(a[..., 0]), k)
    for _ in range(newton_steps(k)):
        ay2 = mul(a, mul(y, y))
        corr = mul_pow2(mul(y, add_f64(-ay2, 1.0)), 0.5)
        y = add(y, corr)
    s = mul(a, y)
    s = add(s, mul_pow2(mul(sub(a, mul(s, s)), y), 0.5))
    return s, y


@_span
def sqrt(a):
    return sqrt_rsqrt(a)[0]


# ---------------------------------------------------------------------------
# Comparisons / reductions
# ---------------------------------------------------------------------------

@_span
def abs_(a):
    if is_limb(a):
        return _limb.abs_(a)
    return a * torch.where(a[..., :1] < 0, -1.0, 1.0).to(a.dtype)


@_span
def cmp_lt(a, b):
    if is_limb(a):
        return _limb.cmp_lt(a, b)
    return sub(a, b)[..., 0] < 0


@_span
def cmp_leq(a, b):
    if is_limb(a):
        return _limb.cmp_leq(a, b)
    return sub(a, b)[..., 0] <= 0


def where(pred, a, b):
    return torch.where(pred[..., None], a, b)


@_span
def max_(a, b):
    return where(cmp_lt(a, b), b, a)


@_span
def min_(a, b):
    return where(cmp_lt(a, b), a, b)


@_span
def max_abs(a, axes=None):
    """max |a| over the given batch axes (all by default), by the
    leading word (limbs: by the lead key)."""
    if is_limb(a):
        return _limb.max_abs(a, axes)
    aa = abs_(a)
    nb = a.dim() - 1
    if axes is None:
        axes = tuple(range(nb))
    axes = tuple(ax % nb for ax in axes)
    if axes == tuple(range(nb)):
        flat = aa.reshape(-1, a.shape[-1])
        return flat[torch.argmax(flat[:, 0])]
    keep = tuple(ax for ax in range(nb) if ax not in axes)
    m = aa.permute(axes + keep + (nb,))
    red = int(np.prod([a.shape[ax] for ax in axes]))
    m = m.reshape((red,) + m.shape[len(axes):])
    idx = torch.argmax(m[..., 0], dim=0)
    return torch.take_along_dim(m, idx[None, ..., None], dim=0)[0]


@_span
def sum_(a, axis=0):
    """MP sum-reduce along a batch axis via a binary tree of MP adds
    (the same pairing as the JAX tree, so results agree bit for bit)."""
    if axis < 0:
        axis += a.dim() - 1
    if a.shape[axis] == 1:
        return a.select(axis, 0)
    a = a.movedim(axis, 0)
    while a.shape[0] > 1:
        m = a.shape[0]
        half = m // 2
        merged = add(a[:half], a[half:2 * half])
        if m % 2:
            merged = torch.cat([merged, a[2 * half:2 * half + 1]], dim=0)
        a = merged
    return a[0]


@_span
def dot(a, b, axis=0):
    """MP dot product along a batch axis."""
    return sum_(mul(a, b), axis=axis)
