"""The port's float64-expansion arithmetic above K = 20 words against
sdpb_tpu.mp.core on the CPU (JAX under jit, x64).

The expansion kernels now take every K up to the CRT prime pool's limit
(54 words, --precision 2862), so their plain versions are held to the
JAX package there too, in XLA's mode (PyTorch flushing float64
subnormals as XLA's CPU does, one thread; tests/test_torch_expansion.py
names the cause):

- K = 23 (--precision 1200): add, mul, div, add_f64 and mul_f64 bit for
  bit, NaN in the same places, on values whose words and partial
  products stay above 2^-1022 (2^400..2^500; a quotient of 2^900..2^1000
  by 2^-20..2^20).
- K = 54: 54 words span 2862 bits, more than the float64 exponent
  range, so every value's tail reaches the subnormal range, where the
  two flush at different steps.  NaN in the same places and the values
  (the exact sums of their words) to 2^-1000 absolute, on the same
  exponent windows (values up to 2^1000).
"""

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import core as jc
from sdpb_tpu_torch.mp import core as tc

from test_torch_expansion import xla_flush_mode  # noqa: F401
from torch_port_util import one_torch_thread  # noqa: F401

OPS = {"add": ((400, 500), (400, 500)), "mul": ((400, 500), (400, 500)),
       "div": ((900, 1000), (-20, 20)),
       "add_f64": ((400, 500), (400, 500)),
       "mul_f64": ((400, 500), (400, 500))}


def _rand(rng, n, k, emin, emax):
    """n normalized K-word expansions (JAX renorm of random words),
    zeros among them, a NaN and a +inf."""
    e = rng.integers(emin, emax, size=n)
    w = np.stack([rng.standard_normal(n) * 2.0 ** (e - 52 * i)
                  for i in range(k)], axis=-1)
    w = np.array(jc.renorm_words(jnp.asarray(w), k))
    w[rng.random(n) < 0.08] = 0.0
    w[0] = np.nan
    w[1] = 0.0
    w[1, 0] = np.inf
    return w


def _results(k, op, seed):
    rng = np.random.default_rng(seed)
    (a0, a1), (b0, b1) = OPS[op]
    a = _rand(rng, 48, k, a0, a1)
    b = _rand(rng, 48, k, b0, b1)
    b[4] = -a[4]                   # exact cancellation
    b[7] = 0.0                     # a zero divisor and summand
    if op.endswith("f64"):
        b = b[:, 0].copy()
    want = np.asarray(jax.jit(getattr(jc, op))(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = getattr(tc, op)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)), op
    return got, want


@pytest.mark.parametrize("op", sorted(OPS))
def test_k23_matches_jax_bit_for_bit(op, xla_flush_mode):  # noqa: F811
    got, want = _results(23, op, 23)
    nan = np.isnan(got) | np.isnan(want)
    bad = np.argwhere(np.where(nan, 0.0, got) != np.where(nan, 0.0, want))
    assert not bad.size, bad[:4]


@pytest.mark.parametrize("op", sorted(OPS))
def test_k54_matches_jax_to_2e_1000(op, xla_flush_mode):  # noqa: F811
    got, want = _results(54, op, 54)
    ctx = mpmath.mp.clone()
    ctx.prec = 53 * 54 + 1200
    tol = ctx.mpf(2) ** -1000
    for g, w in zip(got, want):
        if not np.isfinite(w).all():
            continue
        diff = ctx.fsum(ctx.mpf(float(x)) for x in g) - ctx.fsum(
            ctx.mpf(float(x)) for x in w)
        assert abs(diff) <= tol, (op, diff)
