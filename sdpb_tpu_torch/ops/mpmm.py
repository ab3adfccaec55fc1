"""Exact MP-matrix SYRK/GEMM through the integer CRT pipeline.

The PyTorch counterpart of the JAX package's ``ops/mpmm.py``, for both
word formats: MP matrices -> per-column power-of-2 scaling (exact) ->
balanced base-256 digits -> residues -> per-prime integer products ->
CRT restore -> digit planes -> MP words -> unscaling.  Limb arrays
(float32) convert through ``mp/limb.py``; float64 expansions through the
mantissa and exponent bits of each word.  Inputs are truncated at
2^-plan.bits relative to each column's power-of-2 scale; the product is
exact for the truncated inputs.
"""

from __future__ import annotations

import functools

import torch

from ..mp import core as mpcore
from ..mp import limb as mplimb
from . import exact
from .exact import CrtPlan
from ..utils import timers

_span = timers.span("glue")

# float64 words: mantissa bits, exponent mask, bias
_MANT, _EMASK, _BIAS = 52, 0x7FF, 1023


def _split_mantissa(w):
    """float64 word tensor -> (sign +-1 int32, mantissa int64 with the
    implicit bit, unbiased exponent of its lowest bit int32), so that
    value = sign * m * 2^lsb_exp exactly (subnormals included)."""
    b = w.view(torch.int64)
    sign = torch.where(b < 0, -1, 1).to(torch.int32)
    e = ((b >> _MANT) & _EMASK).to(torch.int32)
    m = b & ((1 << _MANT) - 1)
    m = torch.where(e > 0, m | (1 << _MANT), m)
    lsb_exp = torch.clamp(e, min=1) - (_BIAS + _MANT)
    return sign, m, lsb_exp


@_span
def exponents(x):
    """Per-element int32 e with |value| < 2^e (expansions: from the
    leading word, which carries at least half the value)."""
    if mpcore.is_limb(x):
        return mplimb.exponent_bits(x)
    _, _, lsb = _split_mantissa(x[..., 0])
    return lsb + (_MANT + 1)


def pow2(e):
    """Exact float64 2^e from int32 e, clamped to the normal range."""
    e = torch.clamp(e, 1 - _BIAS, _BIAS)
    return ((e.to(torch.int64) + _BIAS) << _MANT).view(torch.float64)


@_span
def scale_pow2(x, e):
    """x * 2^e with integer e broadcastable over the batch shape; exact
    (expansions: two half-steps keep each factor within range)."""
    if mpcore.is_limb(x):
        return mplimb.scale_pow2_bits(x, e)
    e = torch.as_tensor(e, dtype=torch.int32, device=x.device)
    h1 = torch.div(e, 2, rounding_mode="floor")
    h2 = e - h1
    return x * pow2(h1)[..., None] * pow2(h2)[..., None]


def _carry8(acc, passes: int):
    """Balanced base-256 carry normalization of int32 digits."""
    for _ in range(passes):
        d = torch.bitwise_and(acc + 128, 255) - 128
        cy = torch.bitwise_right_shift(acc - d, 8)
        acc = d + torch.nn.functional.pad(cy[..., :-1], (1, 0))
    return acc


@_span
def digits_dev(x, plan: CrtPlan):
    """MP array with |values| <= 1 -> balanced int32 base-256 digits
    (..., n_digits), least significant first.  Integer-exact: each
    word's mantissa bits are shifted into the grid x * 2^shift; bits
    below the grid are truncated."""
    if mpcore.is_limb(x):
        return mplimb.digits_dev(x, plan.shift_bits, plan.n_digits)
    D, shift = plan.n_digits, plan.shift_bits
    t8 = 8 * torch.arange(D, dtype=torch.int32, device=x.device)
    acc = torch.zeros(x.shape[:-1] + (D,), dtype=torch.int32,
                      device=x.device)
    for i in range(x.shape[-1]):
        sign, m, lsb = _split_mantissa(x[..., i])
        sh = (t8 - (lsb + shift)[..., None]).to(torch.int64)
        m_ = m[..., None]
        right = torch.bitwise_right_shift(m_, sh.clamp(0, _MANT + 1))
        left = torch.bitwise_left_shift(m_, (-sh).clamp(0, 7))
        v = torch.where(sh >= 0, right, left) & 255
        v = torch.where((sh > _MANT) | (sh <= -8), 0, v).to(torch.int32)
        acc = acc + sign[..., None] * v
    return _carry8(acc, 3)


def _plane_words_spec(plan: CrtPlan, k_out: int):
    """(group, n_keep, ref_bits, P) of the planes -> float64 words
    grouping: ``group`` balanced planes pack exactly into one word;
    the kept groups reach from the top plane below 2^-(53 k_out + 24)
    relative to the value scale 2^ref_bits."""
    wb, group = 53, 5
    P = plan.out_planes
    n_groups = -(-P // group)
    ref_bits = 2 * plan.shift_bits
    floor_bits = ref_bits - (wb * k_out + 24)
    n_keep = min(n_groups, max(1, -(-(8 * P - floor_bits) // (8 * group))))
    return group, n_keep, ref_bits, P


@_span
def planes_to_mp_dev(planes, plan: CrtPlan, k_out: int, dtype):
    """Carry-normalized balanced digit planes (..., P) -> the MP array
    of value * 2^-(2 shift) in the format of ``dtype``."""
    if mpcore._limb_dtype(dtype):
        return mplimb.planes_to_limb(planes, 2 * plan.shift_bits, k_out)
    group, n_keep, ref_bits, P = _plane_words_spec(plan, k_out)
    words = []
    for g in range(n_keep):
        top = P - 1 - g * group
        lo = max(0, top - group + 1)
        w = torch.zeros(planes.shape[:-1], dtype=torch.float64,
                        device=planes.device)
        for t in range(top, lo - 1, -1):
            w = w + planes[..., t].to(torch.float64) * 2.0 ** int(
                8 * t - ref_bits)
        words.append(w)
    return mpcore.renorm_words(torch.stack(words, dim=-1), k_out,
                               sort=False)


def _col_exponents(x):
    """Per-batch column exponents of (..., n, m, K): (..., m)."""
    return exponents(x).amax(dim=-2)


@_span
def restore_q_mp(q_res, e_col, plan: CrtPlan, k_out: int,
                 word_dtype=torch.float32, prime_axis: int = 0):
    """CRT restore + planes -> MP words + unscaling by 2^(e_i + e_j)."""
    planes = exact.crt_restore_planes(q_res, plan, prime_axis)
    w = planes_to_mp_dev(planes, plan, k_out, word_dtype)
    return scale_pow2(w, e_col[..., :, None] + e_col[..., None, :])


def _residues(x, e_col, plan):
    u = scale_pow2(x, -e_col[..., None, :])
    return exact.residues_split(digits_dev(u, plan), plan)


def _poison(out, *inputs):
    """Per-batch NaN poisoning: the integer pipeline launders NaN/Inf
    into finite digits, so a non-finite input must poison its output."""
    bad = None
    for x in inputs:
        b = ~torch.isfinite(x[..., 0].abs().amax(dim=(-2, -1)))
        bad = b if bad is None else bad | b
    return torch.where(bad[..., None, None, None], torch.nan, out)


@_span
def syrk_mp_batched(x, plan: CrtPlan, k_out: int | None = None):
    """Exact X^T X with leading batch dims: (..., n, m, K) ->
    (..., m, m, k_out); per-batch column scales and NaN poisoning."""
    k_out = k_out if k_out is not None else x.shape[-1]
    e_col = _col_exponents(x)
    q_res = exact.syrk_residues_split(_residues(x, e_col, plan), plan)
    out = restore_q_mp(q_res, e_col, plan, k_out, x.dtype, prime_axis=-3)
    return _poison(out, x)


@_span
def gemm_mp_batched(a, b, plan: CrtPlan, k_out: int | None = None):
    """Exact A^T B with leading batch dims: (..., n, ma, K) x
    (..., n, mb, K) -> (..., ma, mb, k_out)."""
    k_out = k_out if k_out is not None else a.shape[-1]
    e_a, e_b = _col_exponents(a), _col_exponents(b)
    c_res = exact.gemm_residues_split(_residues(a, e_a, plan),
                                      _residues(b, e_b, plan), plan)
    planes = exact.crt_restore_planes(c_res, plan, prime_axis=-3)
    w = planes_to_mp_dev(planes, plan, k_out, a.dtype)
    out = scale_pow2(w, e_a[..., :, None] + e_b[..., None, :])
    return _poison(out, a, b)


@_span
def reduce_residues_mod(q_res_sum, plan: CrtPlan):
    """Re-reduce a sum of per-prime residue arrays (leading prime axis)
    into [0, p)."""
    p = plan.tensors(q_res_sum.device)["p"]
    return torch.remainder(q_res_sum,
                           p.reshape((-1,) + (1,) * (q_res_sum.dim() - 1)))


@functools.lru_cache(maxsize=None)
def _plan_cached(bits: int, n_quant: int) -> CrtPlan:
    return CrtPlan(bits=bits, n_rows_max=n_quant)


def plan_for(precision_bits: int, n_rows_max: int) -> CrtPlan:
    """CrtPlan for inputs of ``precision_bits`` significant bits, the
    row bound rounded up to a power of two (at least 64)."""
    n_quant = max(64, 1 << max(0, int(n_rows_max) - 1).bit_length())
    return _plan_cached(precision_bits + 16, n_quant)


def precision_of(dtype, k: int) -> int:
    """Significand bits of a k-slot MP array of this dtype (the
    plan-sizing companion of ``plan_for``)."""
    return mpcore.precision_bits_of(k, dtype)
