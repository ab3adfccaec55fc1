"""Host-side conversions between MP arrays and decimal strings.

The reference reads and writes every number as a full-precision decimal
string.  Decimals are parsed with mpmath into float64 word expansions
(exact greedy splitting), which ``mp/limb.from_words_np`` then converts
exactly into limbs; limb arrays print through their exact mpmath value.
"""

from __future__ import annotations

import mpmath
import numpy as np

_GUARD_BITS = 40


def _ctx(k: int) -> mpmath.MPContext:
    ctx = mpmath.mp.clone()
    ctx.prec = 53 * k + _GUARD_BITS
    return ctx


def from_mpf(x, k: int) -> np.ndarray:
    """Split an mpmath mpf (or float/int) into k float64 words."""
    ctx = _ctx(k)
    v = ctx.mpf(x)
    words = np.zeros(k, dtype=np.float64)
    for i in range(k):
        w = float(v)
        words[i] = w
        v = v - ctx.mpf(w)
    return words


def from_decimal(s: str, k: int) -> np.ndarray:
    ctx = _ctx(k)
    return from_mpf(ctx.mpf(s.strip()), k)


def array_from_decimal(strings, k: int) -> np.ndarray:
    """from_decimal over a nested list of strings -> (..., k) words."""
    arr = np.asarray(strings, dtype=object)
    out = np.zeros(arr.shape + (k,), dtype=np.float64)
    flat_out = out.reshape(-1, k)
    for i, s in enumerate(arr.reshape(-1)):
        flat_out[i] = from_decimal(str(s), k)
    return out


def to_mpf(words, ctx: mpmath.MPContext | None = None):
    """Exact mpmath value of one MP scalar: float32 arrays are limbs,
    float64 arrays are word expansions."""
    words = np.asarray(words)
    if words.dtype == np.float32:
        from . import limb

        return limb.to_mpf(words, ctx)
    words = words.astype(np.float64)
    if ctx is None:
        ctx = _ctx(words.shape[-1])
    v = ctx.mpf(0)
    for w in words.reshape(-1):
        v += ctx.mpf(float(w))
    return v


def to_decimal(words, digits: int | None = None) -> str:
    """Decimal string with full round-trip precision."""
    words = np.asarray(words)
    if words.dtype == np.float32:
        from . import limb

        k_slots = words.shape[-1]
        ctx = mpmath.mp.clone()
        ctx.prec = 9 * (k_slots + 8)
        if digits is None:
            digits = int(np.ceil(9 * k_slots * 0.30103)) + 2
        return ctx.nstr(limb.to_mpf(words), digits, strip_zeros=True,
                        min_fixed=1, max_fixed=0)
    words = words.astype(np.float64)
    k = words.shape[-1]
    ctx = _ctx(k)
    if digits is None:
        nz = words[words != 0]
        if nz.size:
            _, e_hi = np.frexp(np.max(np.abs(nz)))
            _, e_lo = np.frexp(np.min(np.abs(nz)))
            span = int(e_hi) - int(e_lo) + 53
        else:
            span = 53 * k
        digits = int(np.ceil(span * 0.30103)) + 2
    return ctx.nstr(to_mpf(words, ctx), digits, strip_zeros=True,
                    min_fixed=1, max_fixed=0)
