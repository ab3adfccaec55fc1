"""Host-side conversions between MP arrays and decimal strings.

The reference reads and writes every number as a full-precision decimal
string.  Decimals are parsed into float64 word expansions (exact greedy
splitting): the expansion format takes them as they are, and
``mp/limb.from_words_np`` converts them exactly into limbs.  Parsing and
the printing of expansions go through the native codec
(``io/native_codec.py``) when it is built, else through mpmath, which
gives the same words; limbs print through their exact mpmath value.
"""

from __future__ import annotations

import mpmath
import numpy as np

_GUARD_BITS = 40


def _native():
    """The native codec when it is built; None -> the mpmath path."""
    from ..io import native_codec

    return native_codec if native_codec.available() else None


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
    nat = _native()
    if nat is not None:
        return nat.dec2words(s, k)
    ctx = _ctx(k)
    return from_mpf(ctx.mpf(s.strip()), k)


def array_from_decimal(strings, k: int) -> np.ndarray:
    """from_decimal over a nested list of strings -> (..., k) words."""
    arr = np.asarray(strings, dtype=object)
    nat = _native()
    if nat is not None:
        out = nat.dec2words_batch([str(s) for s in arr.reshape(-1)], k)
        return out.reshape(arr.shape + (k,))
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
    nat = _native()
    if nat is not None:
        out = nat.words2dec(words, digits or 0)
        if out is not None:
            return out
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


def _np_two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def words_to_dtype(words: np.ndarray, k_out: int, dtype) -> np.ndarray:
    """Host-side (numpy, IEEE-exact) conversion of float64 word
    expansions to ``k_out`` words of ``dtype``: each source word is
    split exactly into destination words, then a two_sum chain and a
    top-down emit renormalize them.  Values beyond the destination
    dtype's finite range are clamped to its largest finite value of the
    same sign, so that 'effectively infinite' thresholds (the 1e100
    maxComplementarity default) keep their comparisons without inf."""
    words = np.asarray(words)
    dtype = np.dtype(dtype)
    if dtype != words.dtype:
        fmax = float(np.finfo(dtype).max)
        flat = np.asarray(words, dtype=np.float64).reshape(
            -1, words.shape[-1]).copy()
        over = np.abs(flat[:, 0]) >= fmax
        if np.any(over):
            sign = np.where(flat[over, 0] > 0, fmax, -fmax)
            flat[over] = 0.0
            flat[over, 0] = sign
            words = flat.reshape(words.shape)
    src = []
    for i in range(words.shape[-1]):
        r = words[..., i].astype(np.float64)
        for _ in range(3 if dtype == np.float32 else 1):
            w = r.astype(dtype)
            src.append(w)
            r = r - w.astype(np.float64)
    m = np.stack([w.astype(dtype) for w in src], axis=-1)
    n = m.shape[-1]
    s = m[..., -1]
    errs = []
    for i in range(n - 2, -1, -1):
        s, e = _np_two_sum(m[..., i], s)
        errs.append(e)
    seq = [s] + errs[::-1]
    out = np.zeros(words.shape[:-1] + (k_out,), dtype=dtype)
    acc = seq[0]
    j = np.zeros(words.shape[:-1], dtype=np.int64)
    for w in seq[1:]:
        s2, e2 = _np_two_sum(acc, w)
        emit = (e2 != 0) & (j < k_out - 1)
        if emit.any():
            flat = out.reshape(-1, k_out)
            jf = j.reshape(-1)
            ef = emit.reshape(-1)
            sf = s2.reshape(-1)
            flat[np.nonzero(ef)[0], jf[ef]] = sf[ef]
        j = j + emit
        acc = np.where(emit, e2, s2)
    flat = out.reshape(-1, k_out)
    flat[np.arange(flat.shape[0]), j.reshape(-1)] = acc.reshape(-1)
    return out
