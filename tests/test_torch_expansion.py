"""The port's float64-expansion arithmetic against sdpb_tpu.mp.core on
the CPU, and the CUDA kernel's per-value code against the plain version.

Every kernel operation (add, sub, mul, div, add_f64, mul_f64) is a fixed
sequence of IEEE float64 operations in both packages, so the port agrees
bit for bit, NaN positions included, at K = 2, 3, 4, 8 and 20.  Two
differences have a named cause and a stated tolerance:

- XLA on the CPU flushes float64 subnormals to zero; PyTorch and the
  card keep them.  At K = 20 the last words of a value near 1, and a
  division's remainder at any size, fall below 2^-1022.  So the K = 20
  checks run PyTorch in XLA's mode (``torch.set_flush_denormal``, one
  thread) on values of 2^250..2^350 (quotients of 2^280..2^370), and
  ``test_subnormal_words_differ_only_below_2e_1000`` holds values near 1,
  without flushing, to 2^-1000 absolute.
- sqrt_rsqrt seeds its Newton iteration with a float64 rsqrt of the
  leading word; XLA's CPU rsqrt is not correctly rounded (1 ulp away
  from 1/sqrt in about 3 of 10 inputs) and PyTorch's is, so the
  converged iterates may differ in the last word: held to 4 units of
  2^-53K relative (2^-1000 relative at K = 20, subnormal-limited).

The kernel's per-value routines (``csrc/expansion.cuh``) are compiled
with g++ -ffp-contract=off, as nvcc runs with -fmad=false, and held to
the plain PyTorch versions bit for bit.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import core as jc
from sdpb_tpu.mp import decimal as jdec
from sdpb_tpu_torch.mp import core as tc
from sdpb_tpu_torch.mp import decimal as tdec
from sdpb_tpu_torch.ops import expansion_kernels as ek

from torch_port_util import one_torch_thread  # noqa: F401,E402

KS = (2, 3, 4, 8, 20)


def _rand(rng, n, k, emin, emax, special=True):
    """n normalized K-word expansions (JAX renorm of random words) with
    exponents in [emin, emax), zeros, and (``special``) NaN, +-inf and
    a value whose negation sits in the other operand (row 4)."""
    e = rng.integers(emin, emax, size=n)
    w = np.stack([rng.standard_normal(n) * 2.0 ** (e - 52 * i)
                  for i in range(k)], axis=-1)
    w = np.array(jc.renorm_words(jnp.asarray(w), k))
    w[rng.random(n) < 0.08] = 0.0
    if special:
        w[0] = np.nan
        w[1] = 0.0
        w[1, 0] = np.inf
        w[2] = 0.0
        w[2, 0] = -np.inf
    return w


def _window(k, op):
    """Exponent windows of (a, b): at K = 20 every word and partial
    product of the operation stays above 2^-1022."""
    if k < 20:
        return (-60, 60), (-60, 60)
    if op == "div":
        return (300, 350), (-20, 20)
    return (250, 350), (250, 350)


def _operands(k, op, n=257, seed=0):
    rng = np.random.default_rng(seed + 31 * k)
    (a0, a1), (b0, b1) = _window(k, op)
    a = _rand(rng, n, k, a0, a1)
    b = _rand(rng, n, k, b0, b1)
    b[4] = -a[4]                          # exact cancellation in add
    b[5] = a[5]
    a[6] = 0.0                            # zero dividend / summand
    b[7] = 0.0                            # zero divisor
    return a, b


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    nan = np.isnan(got) | np.isnan(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)), \
        np.argwhere(np.isnan(got) != np.isnan(want))[:4]
    bad = np.argwhere(np.where(nan, 0.0, got) != np.where(nan, 0.0, want))
    assert not bad.size, (bad[:4], got[tuple(bad[0][:-1])],
                          want[tuple(bad[0][:-1])])


@pytest.fixture
def xla_flush_mode():
    """PyTorch flushing float64 subnormals as XLA's CPU does (the MXCSR
    bits are per thread: the module runs one torch thread)."""
    assert torch.get_num_threads() == 1
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _flush(k, request):
    if k == 20:
        request.getfixturevalue("xla_flush_mode")


def _j(fn, *xs):
    """The JAX function under jit, as the JAX package runs its solver
    (one compile per function and shape), but eagerly at K = 2: under
    jit XLA's CPU contracts the K = 2 product's cross term
    a0 b1 + a1 b0 into a fused multiply-add, which neither eager JAX
    nor the port (nor its kernel, built without FMA) does."""
    args = [jnp.asarray(x) for x in xs]
    if np.shape(xs[0])[-1:] == (2,):
        return np.asarray(fn(*args))
    return np.asarray(jax.jit(fn)(*args))


def _t(fn, *xs):
    return fn(*[torch.from_numpy(np.asarray(x)) for x in xs]).numpy()


BINARY = {"add": (jc.add, tc.add), "sub": (jc.sub, tc.sub),
          "mul": (jc.mul, tc.mul), "div": (jc.div, tc.div)}
WITH_FLOAT = {"add_f64": (jc.add_f64, tc.add_f64),
              "mul_f64": (jc.mul_f64, tc.mul_f64)}


@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("k", KS)
def test_binary_ops_match_jax(k, op, request):
    _flush(k, request)
    a, b = _operands(k, op)
    jf, tf = BINARY[op]
    _same(_t(tf, a, b), _j(jf, a, b))


@pytest.mark.parametrize("op", sorted(WITH_FLOAT))
@pytest.mark.parametrize("k", KS)
def test_float_ops_match_jax(k, op, request):
    _flush(k, request)
    a, b = _operands(k, op)
    x = b[:, 0].copy()
    jf, tf = WITH_FLOAT[op]
    _same(_t(tf, a, x), _j(jf, a, x))
    # a python float and one value broadcast over the batch
    _same(tf(torch.from_numpy(a), 0.375).numpy(),
          _j(lambda v: jf(v, 0.375), a))


@pytest.mark.parametrize("k", (2, 4))
def test_broadcast_operands_match_jax(k):
    """Batch broadcasting as the solver uses it: (n, 1, K) x (1, m, K)
    and one value against a batch."""
    a, b = _operands(k, "mul")
    a3, b3 = a[:12, None], b[None, :9]
    full = np.broadcast_shapes(a3.shape, b3.shape)
    for op in ("add", "mul", "div"):
        jf, tf = BINARY[op]
        _same(_t(tf, a3, b3), _j(jf, np.broadcast_to(a3, full),
                                 np.broadcast_to(b3, full)))
        _same(_t(tf, a, b[3:4]), _j(jf, a, np.broadcast_to(b[3:4],
                                                           a.shape)))


def _mp(words, ctx):
    return ctx.fsum([ctx.mpf(float(w)) for w in words])


def test_subnormal_words_differ_only_below_2e_1000():
    """K = 20 values near 1: the port keeps subnormal words that XLA's
    CPU flushes, so the two agree to 2^-1000 absolute."""
    k = 20
    rng = np.random.default_rng(5)
    a = _rand(rng, 40, k, -2, 2, special=False)
    b = _rand(rng, 40, k, -2, 2, special=False)
    ctx = mpmath.mp.clone()
    ctx.prec = 53 * k + 1200
    for op in ("add", "mul", "div"):
        jf, tf = BINARY[op]
        got, want = _t(tf, a, b), _j(jf, a, b)
        for g, w in zip(got, want):
            if not np.isfinite(w).all():        # zero divisors
                assert np.array_equal(np.isnan(g), np.isnan(w))
                continue
            assert abs(_mp(g, ctx) - _mp(w, ctx)) <= ctx.mpf(2) ** -1000


@pytest.mark.parametrize("k", KS)
def test_sqrt_rsqrt_close_to_jax(k):
    """Held to 4 * 2^-53K relative; at K = 20, where y = 1/sqrt(a) and
    sqrt(a) cannot both keep their last words normal, values near 1 to
    2^-1000 absolute (see the module docstring)."""
    rng = np.random.default_rng(11 + k)
    lo, hi = (-60, 60) if k < 20 else (-4, 4)
    a = np.abs(_rand(rng, 40, k, lo, hi, special=False))
    a[3] = 0.0
    ctx = mpmath.mp.clone()
    ctx.prec = 53 * k + 1200
    rel = 4 * ctx.mpf(2) ** (-53 * k) if k < 20 else 0
    tol_abs = 0 if k < 20 else ctx.mpf(2) ** -1000
    want = [np.asarray(v) for v in jax.jit(jc.sqrt_rsqrt)(jnp.asarray(a))]
    got = [v.numpy() for v in tc.sqrt_rsqrt(torch.from_numpy(a))]
    for g_all, w_all in zip(got, want):
        for g, w in zip(g_all, w_all):
            if not np.isfinite(w).all():
                assert np.array_equal(np.isnan(g), np.isnan(w))
                continue
            vg, vw = _mp(g, ctx), _mp(w, ctx)
            assert abs(vg - vw) <= rel * abs(vw) + tol_abs, (k, vg, vw)
    # a negative input gives NaN in both
    neg = -a[:4]
    neg[3, 0] = -1.0
    for g, w in zip(tc.sqrt_rsqrt(torch.from_numpy(neg)),
                    jax.jit(jc.sqrt_rsqrt)(jnp.asarray(neg))):
        assert np.isnan(g.numpy()[..., 0]).all()
        assert np.isnan(np.asarray(w)[..., 0]).all()


@pytest.mark.parametrize("k", (2, 4, 8))
def test_utilities_match_jax(k):
    a, b = _operands(k, "add")
    fa = a[8:]                       # finite rows
    fb = b[8:]
    _same(_t(tc.abs_, a), _j(jc.abs_, a))
    _same(_t(tc.neg, a), _j(jc.neg, a))
    _same(_t(tc.recip, fb), _j(jc.recip, fb))
    _same(_t(tc.cmp_lt, fa, fb), _j(jc.cmp_lt, fa, fb))
    _same(_t(tc.cmp_leq, fa, fb), _j(jc.cmp_leq, fa, fb))
    _same(_t(tc.max_, fa, fb), _j(jc.max_, fa, fb))
    _same(_t(tc.min_, fa, fb), _j(jc.min_, fa, fb))
    _same(_t(tc.lead, a), _j(jc.lead, a))
    _same(_t(tc.fst, a), _j(jc.fst, a))
    _same(_t(tc.approx, a), _j(jc.approx, a))
    _same(tc.mul_pow2(torch.from_numpy(a), 0.25).numpy(),
          _j(lambda v: jc.mul_pow2(v, 0.25), a))
    _same(_t(tc.mul_scalar, fa, fb[0]), _j(jc.mul_scalar, fa, fb[0]))
    m = fa[:48].reshape(6, 8, k)
    _same(_t(tc.max_abs, m), _j(jc.max_abs, m))
    _same(tc.max_abs(torch.from_numpy(m), axes=(1,)).numpy(),
          _j(lambda v: jc.max_abs(v, axes=(1,)), m))
    m = m[:3, :5]
    for axis in (0, -1):
        _same(tc.sum_(torch.from_numpy(m), axis=axis).numpy(),
              _j(lambda v: jc.sum_(v, axis=axis), m))
    _same(tc.dot(torch.from_numpy(m), torch.from_numpy(m[::-1].copy()),
                 axis=1).numpy(),
          _j(lambda u, v: jc.dot(u, v, axis=1), m, m[::-1]))
    for k2 in (k - 1, k + 2):
        _same(tc.change_k(torch.from_numpy(fa), k2).numpy(),
              _j(lambda v: jc.change_k(v, k2), fa))
    words = np.concatenate([a, b[:, :2]], axis=-1)
    for sort in (True, False):
        _same(tc.renorm_words(torch.from_numpy(words), k, sort=sort).numpy(),
              _j(lambda v: jc.renorm_words(v, k, sort=sort), words))
    _same(_t(tc.merge_desc, a, b), _j(jc.merge_desc, a, b))
    x, y = a[:, 0], b[:, 0]
    for tf, jf in ((tc.two_sum, jc.two_sum), (tc.two_prod, jc.two_prod),
                   (tc.fast_two_sum, jc.fast_two_sum)):
        for g, w in zip(tf(torch.from_numpy(x), torch.from_numpy(y)),
                        jax.jit(jf)(jnp.asarray(x), jnp.asarray(y))):
            _same(g.numpy(), np.asarray(w))


def test_constructors_match_jax():
    for k in (2, 5):
        _same(tc.one_np(k, torch.float64), jc.one_np(k, jnp.float64))
        _same(tc.from_f64_np(0.1, k, torch.float64),
              jc.from_f64_np(0.1, k, jnp.float64))
        _same(tc.zeros((3, 2), k, "cpu", torch.float64).numpy(),
              np.asarray(jc.zeros((3, 2), k, jnp.float64)))
        v = np.array([1.5, -2.0 ** -70, 0.0])
        _same(tc.const_word(torch.from_numpy(v), k, torch.float64).numpy(),
              np.asarray(jc.const_word(jnp.asarray(v), k, jnp.float64)))
        assert tc.precision_bits_of(k, torch.float64) == \
            jc.precision_bits_of(jnp.float64, k)
        # the limb format keeps its own constructors as the default
        _same(tc.one_np(k + 3), jc.one_np(k + 3, jnp.float32))


def test_decimal_words_match_jax():
    strings = [["0.1", "-3.25e-40"], ["1e100", "2.718281828459045235360287"
                                      "4713526624977572470937"]]
    for k in (2, 4, 7):
        _same(tdec.array_from_decimal(strings, k),
              jdec.array_from_decimal(strings, k))
    words = tdec.array_from_decimal(strings, 6)
    for k_out, dt in ((4, np.float64), (3, np.float64), (9, np.float32)):
        _same(tdec.words_to_dtype(words, k_out, dt),
              jdec.words_to_dtype(words, k_out, dt))
    ctx = mpmath.mp.clone()
    ctx.prec = 53 * 6 + 64
    for k in (3, 4):
        v = words[1, 1, :k]
        assert ctx.mpf(tdec.to_decimal(v)) == ctx.mpf(jdec.to_decimal(v))


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the kernel wrappers return the plain version's
    bits and count no launch; K above the kernels' limit is refused
    only where a kernel would run."""
    ek.reset_launches()
    a, b = _operands(4, "mul")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x = tb[:, 0].clone()
    for wrapper, plain, y in ((ek.exp_add, tc.add_plain, tb),
                              (ek.exp_mul, tc.mul_plain, tb),
                              (ek.exp_div, tc.div_plain, tb),
                              (ek.exp_add_f64, tc.add_f64_plain, x),
                              (ek.exp_mul_f64, tc.mul_f64_plain, x)):
        _same(wrapper(ta, y).numpy(), plain(ta, y).numpy())
    assert all(v == 0 for v in ek.LAUNCHES.values())
    with pytest.raises(ValueError, match=f"limit of {ek.MAX_WORDS}"):
        ek.check_words("exp_add", ek.MAX_WORDS + 1)
    with pytest.raises(TypeError):
        ek.exp_add(ta.float(), tb.float())


# ---------------------------------------------------------------------------
# The kernel's per-value code, built with the host compiler
# ---------------------------------------------------------------------------

HOST_KS = (1, 2, 3, 4, 8, 20)

HARNESS = r"""
#define EXP_HD inline
#include "expansion.cuh"

// The CUDA kernel's loop (csrc/expansion_elementwise.cu) on the host:
// value i of a at a + i sa, of b at b + i sb, out (n, K).
template <int K>
void run(int op, const double* a, long sa, const double* b, long sb,
         double* out, long n) {
  for (long i = 0; i < n; ++i) {
    const double* ai = a + i * sa;
    const double* bi = b + i * sb;
    double* oi = out + i * K;
    switch (op) {
      case 0: expn::apply<K, 0>(ai, bi, oi); break;
      case 1: expn::apply<K, 1>(ai, bi, oi); break;
      case 2: expn::apply<K, 2>(ai, bi, oi); break;
      case 3: expn::apply<K, 3>(ai, bi, oi); break;
      default: expn::apply<K, 4>(ai, bi, oi);
    }
  }
}

extern "C" int host_expansion(int k, int op, const double* a, long sa,
                              const double* b, long sb, double* out,
                              long n) {
  switch (k) {
    KCASES
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the per-value code")
    d = tmp_path_factory.mktemp("expansion_host")
    cases = " ".join(f"case {k}: run<{k}>(op, a, sa, b, sb, out, n); "
                     f"return 0;" for k in HOST_KS)
    (d / "harness.cpp").write_text(HARNESS.replace("KCASES", cases))
    lib = d / "libexpansion_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-fPIC", "-shared", f"-I{ek.CSRC}", str(d / "harness.cpp"), "-o",
         str(lib)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    vp, cl, ci = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    so.host_expansion.argtypes = [ci, ci, vp, cl, vp, cl, vp, cl]
    so.host_expansion.restype = ci
    return so


def _host_call(so, k, op, a, sa, b, sb, n):
    out = torch.empty((n, k), dtype=torch.float64)
    rc = so.host_expansion(k, op, a.data_ptr(), sa, b.data_ptr(), sb,
                           out.data_ptr(), n)
    assert rc == 0
    return out


PLAIN = (("add", 0, tc.add_plain), ("mul", 1, tc.mul_plain),
         ("div", 2, tc.div_plain), ("add_f64", 3, tc.add_f64_plain),
         ("mul_f64", 4, tc.mul_f64_plain))


@pytest.mark.parametrize("k", HOST_KS)
def test_kernel_code_matches_plain(host, k):
    """Each op's per-value code against its plain version: value by
    value, with b's first value broadcast (batch stride 0), and with
    zeros, cancellation, NaN and +-inf among the operands."""
    for name, op, plain in PLAIN:
        a, b = _operands(max(k, 2), name, n=41, seed=3)
        a = torch.from_numpy(np.ascontiguousarray(a[:, :k]))
        b = torch.from_numpy(np.ascontiguousarray(b[:, :k]))
        n = a.shape[0]
        y = b[:, 0].contiguous() if op >= 3 else b
        w = 1 if op >= 3 else k
        _same(_host_call(host, k, op, a, k, y, w, n).numpy(),
              plain(a, y).numpy())
        y1 = y[:1].contiguous()
        want = plain(a, y1 if op < 3 else y1.expand(n))
        _same(_host_call(host, k, op, a, k, y1, 0, n).numpy(),
              want.numpy())
