"""Inputs for the tests of the CRT pipeline's base conversions
(mp/limb.py digits_dev and planes_to_limb, their kernels in
csrc/limb_digits.cu), on the CPU and on the card.  Imports neither JAX
nor the JAX package, so that the card's tests can use it."""

import numpy as np
import torch

from sdpb_tpu_torch.mp import limb
from sdpb_tpu_torch.ops import mpmm


def plan_sizes(S):
    """(n_digits, shift_bits, P) of mpmm.plan_for at S slots: P the
    plan's out_planes, or, where the prime pool cannot hold the plan
    (above ~2800 bits), 2 n_digits + 6 planes, whose top lies 64 bits
    above 2^(2 shift_bits) as the plans' do."""
    plan = mpmm.plan_for(limb.precision_bits(S), 64)
    try:
        P = plan.out_planes
    except ValueError:
        P = 2 * plan.n_digits + 6
    return plan.n_digits, plan.shift_bits, P


def digit_inputs(rng, n, S, n_digits):
    """n >= 7 limb values (|value| <~ 1) whose limbs straddle every
    cut-off of the digit grid: exponents from 0 down to below the grid's
    last digit, random limbs in [-256, 256], some negated (slot 0
    negative too), and zero, +-1, limbs at +-270, a value wholly below
    the grid and one (found by a search) whose third carry pass moves
    two digits below the grid's top, wherever the top is."""
    L = S - 1
    low = -(8 * n_digits // limb.B) - 3
    e = rng.integers(low, 1, size=n)
    x = np.concatenate([(limb.EOFF + e)[:, None].astype(np.float32),
                        rng.integers(-256, 257, (n, L)).astype(np.float32)],
                       axis=1)
    x[rng.random(n) < 0.3] *= -1.0
    x[0] = 0.0
    x[1] = limb.one(S)
    x[2] = -limb.one(S)
    x[3, 0], x[3, 1:] = limb.EOFF - 1, 270.0
    x[4, 0], x[4, 1:] = limb.EOFF - 1, -270.0
    x[5, 0] = limb.EOFF + low - L - 2
    x[6] = 0.0
    x[6, :4] = limb.EOFF - 2, 10.0, -4.0, -10.0
    return torch.from_numpy(x)


def plane_inputs(rng, n, P):
    """n >= 5 rows of P int32 planes in [-2^13, 2^13], with zeros, the
    bound's ends, a lone top plane and a lone bottom plane."""
    p = rng.integers(-(1 << 13), (1 << 13) + 1, (n, P)).astype(np.int32)
    p[0] = 0
    p[1] = (1 << 13) - 1
    p[2] = -(1 << 13)
    p[3, :-1] = 0
    p[4, 1:] = 0
    return torch.from_numpy(p)
