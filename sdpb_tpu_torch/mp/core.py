"""The MP API the solver calls, limb format only.

The JAX package's ``mp/core.py`` dispatches on the word dtype between
f64-word expansions (CPU) and the base-2^9 limb format (float32, the
accelerator format).  This slice ports the limb branch: every MP array
here is a float32 limb tensor (``mp/limb.py``).
"""

from __future__ import annotations

import torch

from . import limb as _limb


def is_limb(a) -> bool:
    return a.dtype == torch.float32


def precision_bits_of(k: int) -> int:
    """Significand bits carried by a k-slot limb array."""
    return _limb.precision_bits(k)


lead = _limb.lead
one_np = _limb.one
from_f64_np = _limb.from_f64_np
zeros = _limb.zeros
from_float = _limb.from_float
const_word = _limb.const_word
approx = _limb.fst
fst = _limb.fst
add = _limb.add
add_f64 = _limb.add_float
neg = _limb.neg
sub = _limb.sub
mul = _limb.mul
mul_f64 = _limb.mul_float
mul_pow2 = _limb.mul_pow2
div = _limb.div
recip = _limb.recip
sqrt_rsqrt = _limb.sqrt_rsqrt
abs_ = _limb.abs_
cmp_lt = _limb.cmp_lt
cmp_leq = _limb.cmp_leq
max_abs = _limb.max_abs


def where(pred, a, b):
    return torch.where(pred[..., None], a, b)


def max_(a, b):
    return where(cmp_lt(a, b), b, a)


def min_(a, b):
    return where(cmp_lt(a, b), a, b)


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


def dot(a, b, axis=0):
    """MP dot product along a batch axis."""
    return sum_(mul(a, b), axis=axis)
