"""Exact reading of the program's multiprecision words, from the formats'
definitions alone (the reference imports nothing of the program):

- float32 limbs (..., S): slot 0 holds the exponent code x0, with
  e = |x0| - 16384 in units of 9 bits; slots 1..S-1 hold integer limbs
  l_i, and the value is sum_i l_i * 2^(9 (e + 1 - i));
- float64 expansions (..., K): the value is the exact sum of the words.
"""

from __future__ import annotations

import torch

from . import mpt

LIMB_BITS = 9
EXP_OFFSET = 16384


def read(words: torch.Tensor, L: int) -> mpt.MP:
    """The exact values of the program's words (float32 limbs or float64
    expansions) as MP values of L limbs."""
    if words.dtype == torch.float64:
        return mpt.from_f64_words(words, L)
    if words.dtype != torch.float32:
        raise TypeError(f"no word format of dtype {words.dtype}")
    w = words.to(torch.float64)
    limbs = w[..., 1:]
    if not torch.isfinite(w).all() or (limbs != limbs.round()).any():
        raise ValueError("limb words that are not finite integers")
    e = (w[..., :1].abs() - EXP_OFFSET).to(torch.int64)
    i = torch.arange(1, w.shape[-1], device=w.device)
    bitpos = LIMB_BITS * (e + 1 - i)
    return mpt.from_int_limbs(limbs.to(torch.int64), bitpos, L)
