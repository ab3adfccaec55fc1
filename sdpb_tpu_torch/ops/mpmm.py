"""Exact limb-matrix SYRK/GEMM through the integer CRT pipeline.

The PyTorch counterpart of the JAX package's ``ops/mpmm.py``, limb
format only: limb matrices -> per-column power-of-2 scaling (exact) ->
balanced base-256 digits -> residues -> per-prime integer products ->
CRT restore -> digit planes -> limbs -> unscaling.  Inputs are
truncated at 2^-plan.bits relative to each column's power-of-2 scale;
the product is exact for the truncated inputs.
"""

from __future__ import annotations

import functools

import torch

from ..mp import limb as mplimb
from . import exact
from .exact import CrtPlan


def exponents(x):
    """Per-element int32 e with |value| < 2^e."""
    return mplimb.exponent_bits(x)


def scale_pow2(x, e):
    """x * 2^e with integer e broadcastable over the batch shape."""
    return mplimb.scale_pow2_bits(x, e)


def digits_dev(x, plan: CrtPlan):
    """Limb array, |values| <= 1 -> balanced int32 base-256 digits."""
    return mplimb.digits_dev(x, plan.shift_bits, plan.n_digits)


def planes_to_mp_dev(planes, plan: CrtPlan, k_out: int):
    """Balanced digit planes -> limb array of value * 2^-(2 shift)."""
    return mplimb.planes_to_limb(planes, 2 * plan.shift_bits, k_out)


def _col_exponents(x):
    """Per-batch column exponents of (..., n, m, S): (..., m)."""
    return exponents(x).amax(dim=-2)


def restore_q_mp(q_res, e_col, plan: CrtPlan, k_out: int,
                 prime_axis: int = 0):
    """CRT restore + planes -> limbs + unscaling by 2^(e_i + e_j)."""
    planes = exact.crt_restore_planes(q_res, plan, prime_axis)
    w = planes_to_mp_dev(planes, plan, k_out)
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


def syrk_mp_batched(x, plan: CrtPlan, k_out: int | None = None):
    """Exact X^T X with leading batch dims: (..., n, m, S) ->
    (..., m, m, k_out); per-batch column scales and NaN poisoning."""
    k_out = k_out if k_out is not None else x.shape[-1]
    e_col = _col_exponents(x)
    q_res = exact.syrk_residues_split(_residues(x, e_col, plan), plan)
    out = restore_q_mp(q_res, e_col, plan, k_out, prime_axis=-3)
    return _poison(out, x)


def gemm_mp_batched(a, b, plan: CrtPlan, k_out: int | None = None):
    """Exact A^T B with leading batch dims: (..., n, ma, S) x
    (..., n, mb, S) -> (..., ma, mb, k_out)."""
    k_out = k_out if k_out is not None else a.shape[-1]
    e_a, e_b = _col_exponents(a), _col_exponents(b)
    c_res = exact.gemm_residues_split(_residues(a, e_a, plan),
                                      _residues(b, e_b, plan), plan)
    planes = exact.crt_restore_planes(c_res, plan, prime_axis=-3)
    w = planes_to_mp_dev(planes, plan, k_out)
    out = scale_pow2(w, e_a[..., :, None] + e_b[..., None, :])
    return _poison(out, a, b)


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
