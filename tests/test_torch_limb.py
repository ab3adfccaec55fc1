"""The port's limb arithmetic against sdpb_tpu.mp.limb on the CPU.

add, neg, mul, the carry/renorm path and the conversions are exact
integer algorithms in float32, so the port must agree bit for bit.
sqrt_rsqrt, recip and div start from a rounded float32 estimate (the
rsqrt seed, the quotient digit estimate), so they are held to 2 units
of the last significant limb, the one above the guard limb: the guard
limb of the reference's own Newton iterate is off from the mpmath
value by up to ~40 of its units (measured on these inputs).
"""

import math

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import limb as jl
from sdpb_tpu_torch.mp import limb as tl

from torch_port_util import one_torch_thread  # noqa: F401,E402

S = 14            # 1 + 13 limbs, about 100 bits


def _rand_limbs(rng, shape, k_slots=S, emin=-60, emax=60):
    """Random limb arrays: 3 random f64 words spread over exponents,
    plus zeros."""
    n = int(np.prod(shape))
    e = rng.integers(emin, emax, size=n)
    w0 = rng.standard_normal(n) * 2.0 ** e
    w1 = rng.standard_normal(n) * 2.0 ** (e - 53)
    w2 = rng.standard_normal(n) * 2.0 ** (e - 106)
    words = np.stack([w0, w1, w2], axis=-1)
    words[rng.random(n) < 0.1] = 0.0
    return jl.from_words_np(words, k_slots).reshape(*shape, k_slots)


def _same(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    both_nan = np.isnan(a) & np.isnan(b)
    diff = np.where(both_nan, 0, a) != np.where(both_nan, 0, b)
    bad = np.argwhere(diff)
    assert not bad.size, (bad[:4], a[tuple(bad[0])], b[tuple(bad[0])])


def _j(fn, *xs):
    return np.asarray(fn(*[jnp.asarray(x) for x in xs]))


def _t(fn, *xs):
    return fn(*[torch.from_numpy(np.asarray(x)) for x in xs]).numpy()


def _ulps(got, want):
    """max |got - want| in units of want's last significant limb."""
    worst = 0.0
    flat_g = got.reshape(-1, got.shape[-1])
    flat_w = want.reshape(-1, want.shape[-1])
    for g, w in zip(flat_g, flat_w):
        vg, vw = jl.to_mpf(g), jl.to_mpf(w)
        if w[1:].any() == 0 and not g[1:].any():
            continue
        e = int(abs(w[0])) - jl.EOFF
        ulp = mpmath.mpf(2) ** (jl.B * (e - (S - 3)))
        worst = max(worst, float(abs(vg - vw) / ulp))
    return worst


@pytest.mark.parametrize("seed", [0, 1])
def test_add_sub_neg_bitexact(seed):
    rng = np.random.default_rng(seed)
    a = _rand_limbs(rng, (64,))
    b = _rand_limbs(rng, (64,), emin=-80, emax=80)
    _same(_t(tl.add, a, b), _j(jl.add, a, b))
    _same(_t(tl.sub, a, b), _j(jl.sub, a, b))
    _same(_t(tl.add, a, -a), _j(jl.add, a, -a))
    _same(_t(tl.neg, a), _j(jl.neg, a))


@pytest.mark.parametrize("seed", [0, 1])
def test_mul_bitexact(seed):
    rng = np.random.default_rng(seed)
    a = _rand_limbs(rng, (8, 9))
    b = _rand_limbs(rng, (9,))
    _same(_t(tl.mul, a, b), _j(jl.mul, a, b))
    _same(_t(tl.mul, a, a), _j(jl.mul, a, a))


def test_mul_chunked_matches_unchunked(monkeypatch):
    rng = np.random.default_rng(7)
    a = _rand_limbs(rng, (50,))
    b = _rand_limbs(rng, (50,))
    whole = _t(tl.mul, a, b)
    monkeypatch.setattr(tl, "_MUL_CHUNK_FLOATS", 2 * 13 * 13 * 7)
    _same(_t(tl.mul, a, b), whole)


def test_carry_renorm_bitexact():
    rng = np.random.default_rng(3)
    ext = rng.integers(-(1 << 20), 1 << 20, size=(40, S + 2)).astype(
        np.float32)
    ext[:, :2] = 0.0
    ext[::7] = 0.0
    e_top = rng.integers(-50, 50, size=40).astype(np.int32)
    for passes in (1, 3):
        want = np.asarray(jl._renorm(jnp.asarray(e_top), jnp.asarray(ext),
                                     S - 1, passes))
        got = tl._renorm(torch.from_numpy(e_top), torch.from_numpy(ext),
                         S - 1, passes).numpy()
        _same(got, want)
        _same(tl._carry(torch.from_numpy(ext), passes).numpy(),
              np.asarray(jl._carry(jnp.asarray(ext), passes)))


def test_conversions_bitexact():
    rng = np.random.default_rng(4)
    # normal f32 only: XLA on the CPU flushes f32 subnormals to zero,
    # while the port (like the CUDA kernels) converts them exactly
    x32 = (rng.standard_normal(50) * 2.0 ** rng.integers(-100, 100, 50)
           ).astype(np.float32)
    x32[:3] = [0.0, np.inf, -np.inf]
    x32[3] = np.nan
    _same(_t(lambda x: tl.from_float(x, S), x32),
          _j(lambda x: jl.from_float(x, S), x32))
    x64 = rng.standard_normal(30) * 2.0 ** rng.integers(-300, 300, 30)
    _same(_t(lambda x: tl.from_float(x, S), x64),
          _j(lambda x: jl.from_float(x, S), x64))
    a = _rand_limbs(rng, (30,))
    # fst/lead are float32 estimates built with exp2/log2; XLA's exp2 on
    # the CPU is off by up to ~1e-6 relative at large integer arguments
    # (the port's is exact), so these two get a relative tolerance
    np.testing.assert_allclose(_t(tl.fst, a), _j(jl.fst, a), rtol=2e-6)
    np.testing.assert_allclose(_t(tl.lead, a), _j(jl.lead, a), rtol=2e-6)
    _same(_t(tl.exponent_bits, a), _j(jl.exponent_bits, a))
    _same(_t(lambda x: tl.mul_float(x, 0.375), a),
          _j(lambda x: jl.mul_float(x, 0.375), a))
    _same(_t(lambda x: tl.scale_pow2_bits(x, -13), a),
          _j(lambda x: jl.scale_pow2_bits(x, -13), a))
    _same(_t(lambda x: tl.add_float(x, 1.0), a),
          _j(lambda x: jl.add_float(x, 1.0), a))


def test_special_values():
    """Zero, NaN, +-inf, overflow, underflow and mixed exponents."""
    k = S
    one = jl.one(k)
    zero = np.zeros(k, np.float32)
    nan = np.full(k, np.nan, np.float32)
    pinf = np.asarray(jl.from_float(jnp.asarray(np.float32(np.inf)), k))
    big = one.copy()
    big[0] = jl.EOFF + jl.EOFF - 2          # near the top of the range
    tiny = one.copy()
    tiny[0] = jl.EOFF - jl.EOFF + 1         # near the bottom
    cases = [(one, zero), (zero, zero), (nan, one), (one, nan),
             (pinf, one), (big, big), (tiny, tiny), (big, tiny),
             (one, -one)]
    a = np.stack([c[0] for c in cases])
    b = np.stack([c[1] for c in cases])
    for fn_t, fn_j in ((tl.add, jl.add), (tl.mul, jl.mul),
                       (tl.sub, jl.sub)):
        _same(_t(fn_t, a, b), _j(fn_j, a, b))
    got = _t(tl.mul, a, b)
    assert not np.isfinite(got[5]).all()        # overflow
    assert not got[6, 1:].any()                 # underflow to zero
    assert np.isnan(got[2]).all() and np.isnan(got[3]).all()


def test_sqrt_rsqrt_recip_div_within_2_ulps():
    rng = np.random.default_rng(5)
    a = np.abs(_rand_limbs(rng, (40,)))
    a[0] = 0.0
    b = _rand_limbs(rng, (40,))
    b[b[:, 1:].any(axis=1) == 0] = jl.one(S)
    s_t, y_t = tl.sqrt_rsqrt(torch.from_numpy(a))
    s_j, y_j = jl.sqrt_rsqrt(jnp.asarray(a))
    nz = slice(1, None)
    assert _ulps(s_t.numpy()[nz], np.asarray(s_j)[nz]) <= 2
    assert _ulps(y_t.numpy()[nz], np.asarray(y_j)[nz]) <= 2
    assert not s_t.numpy()[0, 1:].any()                 # sqrt(0) = 0
    assert np.isinf(y_t.numpy()[0, 1])                  # rsqrt(0) = inf
    assert _ulps(_t(tl.recip, b), _j(jl.recip, b)) <= 2
    assert _ulps(_t(tl.div, a, b), _j(jl.div, a, b)) <= 2
    neg = -a[1:4]
    assert np.isnan(tl.sqrt_rsqrt(torch.from_numpy(neg))[0].numpy()).any(
        axis=-1).all()


@pytest.mark.parametrize("k_slots", [14, 47])
def test_div_recip_bitexact(k_slots):
    """div and recip against sdpb_tpu bit for bit: the quotient digits
    come from the same rounded float32 estimate on both sides.  Special
    values: zero divisors under a zero and a non-zero dividend of each
    sign, NaN, +-inf, x / x and both ends of the exponent range."""
    rng = np.random.default_rng(k_slots)
    a = _rand_limbs(rng, (60,), k_slots, emin=-200, emax=200)
    b = _rand_limbs(rng, (60,), k_slots, emin=-200, emax=200)
    one = jl.one(k_slots)
    inf = jl.from_words_np(np.array([[np.inf, 0.0, 0.0]]), k_slots)[0]
    a[0], a[1], a[2], b[0:3] = one, -one, 0.0, 0.0
    a[3], a[4], b[5], b[6] = np.nan, inf, np.nan, -inf
    a[7] = b[7] = a[8]
    a[9], b[9] = one, one
    a[9, 0], b[9, 0] = 2 * jl.EOFF - 2, 1          # overflow
    a[10], b[10] = one, one
    a[10, 0], b[10, 0] = 1, 2 * jl.EOFF - 2        # underflow
    _same(_t(tl.div, a, b), _j(jl.div, a, b))
    _same(_t(tl.recip, b), _j(jl.recip, b))
    _same(_t(tl.recip, a), _j(jl.recip, a))


def test_digits_and_planes_bitexact():
    rng = np.random.default_rng(6)
    x = _rand_limbs(rng, (5, 7), emin=-40, emax=-1)
    shift, nd = 8 * 14, 15
    _same(_t(lambda v: tl.digits_dev(v, shift, nd), x),
          _j(lambda v: jl.digits_dev(v, shift, nd), x))
    planes = rng.integers(-3000, 3000, size=(6, 30)).astype(np.int32)
    _same(_t(lambda p: tl.planes_to_limb(p, 200, S), planes),
          _j(lambda p: jl.planes_to_limb(p, 200, S), planes))


def test_max_abs_and_compares():
    rng = np.random.default_rng(8)
    a = _rand_limbs(rng, (6, 5))
    b = _rand_limbs(rng, (6, 5))
    _same(_t(tl.max_abs, a), _j(jl.max_abs, a))
    _same(_t(lambda x: tl.max_abs(x, axes=(0,)), a),
          _j(lambda x: jl.max_abs(x, axes=(0,)), a))
    _same(_t(tl.cmp_lt, a, b), _j(jl.cmp_lt, a, b))
    assert math.isclose(float(jl.to_mpf(tl.from_f64_np(0.1, S))),
                        0.1, rel_tol=1e-15)
