"""The port's float64-expansion linear algebra against sdpb_tpu.mp.linalg
on the accelerator's routing rule (batched products on the CRT route),
on the CPU, at K = 4.

n = 20 runs the unblocked loops; n = 70 the panel loops of 32 with the
identity padding and CRT trailing products.  Everything but the
Cholesky pivots is a fixed sequence of IEEE float64 operations in both
packages (the elementwise ops, the CRT products, the long divisions of
the diagonal reciprocals), so the solves, lower_inverse and matmul are
held bit for bit from the same factor.  The pivots' sqrt_rsqrt starts
from a float64 rsqrt of the leading word, which XLA's CPU does not
round correctly and PyTorch does (tests/test_torch_expansion.py), so
the factor itself is held to 2^-200 relative to its largest entry
(K = 4 carries 212 bits).
"""

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import core as jc
from sdpb_tpu.mp import linalg as jla
from sdpb_tpu_torch.mp import linalg as tla

from torch_port_util import one_torch_thread  # noqa: F401,E402

K = 4
TOL = 2.0 ** -200


@pytest.fixture
def jax_accelerator_route(monkeypatch):
    """sdpb_tpu's linalg with the port's (the accelerator's) rule for
    sending products to the CRT route."""
    monkeypatch.setattr(jla, "_int_backend_ok",
                        lambda a, b, syrk: tla._int_backend_ok(
                            a.shape, b.shape[-2]))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _words(x):
    """Float64 values as K-word expansions with a random tail, so that
    every word carries bits."""
    rng = np.random.default_rng(7)
    x = np.asarray(x, np.float64)
    tail = [x * rng.standard_normal(x.shape) * 2.0 ** (-53 * i)
            for i in range(1, K)]
    return np.array(jc.renorm_words([jnp.asarray(x)] + [
        jnp.asarray(t) for t in tail], K))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan = np.isnan(got) | np.isnan(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    bad = np.argwhere(np.where(nan, 0, got) != np.where(nan, 0, want))
    assert not bad.size, (bad.shape[0], bad[:4])


def _close(got, want):
    """max |got - want| <= TOL * max |want|, the difference of the
    expansions summed exactly."""
    ctx = mpmath.mp.clone()
    ctx.prec = 53 * K + 200
    got = np.asarray(got).reshape(-1, K)
    want = np.asarray(want).reshape(-1, K)
    scale = np.abs(want[:, 0]).max()
    worst = 0.0
    for g, w in zip(got, want):
        d = ctx.fsum([ctx.mpf(float(v)) for v in g]) - ctx.fsum(
            [ctx.mpf(float(v)) for v in w])
        worst = max(worst, float(abs(d)))
    assert worst <= TOL * scale, (worst, scale)


def _spd(rng, n):
    g = rng.standard_normal((n, n))
    return g @ g.T + n * np.eye(n)


@pytest.mark.parametrize("n", [20, 70])
def test_cholesky_solves_inverse(n, jax_accelerator_route):
    rng = np.random.default_rng(n)
    a_np = _spd(rng, n)
    a = _words(a_np)
    b = _words(rng.standard_normal((n, 3)))
    lj = np.asarray(jax.jit(jla.cholesky)(jnp.asarray(a)))
    lt = tla.cholesky(torch.from_numpy(a)).numpy()
    _close(lt, lj)
    np.testing.assert_allclose(lt[..., 0], np.linalg.cholesky(a_np),
                               rtol=1e-12, atol=1e-12)
    # the solves and the inverse from the same factor, bit for bit
    l_in = torch.from_numpy(lj)
    for jf, tf in ((jla.solve_lower, tla.solve_lower),
                   (jla.solve_lower_t, tla.solve_lower_t)):
        _same(tf(l_in, torch.from_numpy(b)).numpy(),
              jax.jit(jf)(jnp.asarray(lj), jnp.asarray(b)))
        # a vector right-hand side
        _same(tf(l_in, torch.from_numpy(b[:, 0])).numpy(),
              jax.jit(jf)(jnp.asarray(lj), jnp.asarray(b[:, 0])))
    _same(tla.lower_inverse(l_in[None]).numpy(),
          jax.jit(jla.lower_inverse)(jnp.asarray(lj)[None]))


def test_batched_cholesky_and_non_pd(jax_accelerator_route):
    """Two matrices on a leading axis (vmap in sdpb_tpu), the second not
    positive definite: NaN in both packages, the first as alone."""
    rng = np.random.default_rng(3)
    a = np.stack([_words(_spd(rng, 9)), -_words(_spd(rng, 9))])
    lj = np.asarray(jax.jit(jla.cholesky)(jnp.asarray(a)))
    lt = tla.cholesky(torch.from_numpy(a)).numpy()
    assert np.isnan(lt[1]).any() and np.isnan(lj[1]).any()
    assert np.isfinite(lt[0]).all()
    _close(lt[0], lj[0])


@pytest.mark.parametrize("shape", [((3, 6), (6, 5)), ((70, 40), (40, 33)),
                                   ((2, 40, 70), (2, 70, 3))])
def test_matmul(shape, jax_accelerator_route):
    """The naive chunked product (small) and the CRT route (large, and
    batched on the accelerator's rule), bit for bit."""
    rng = np.random.default_rng(len(shape[0]))
    a = _words(rng.standard_normal(shape[0]))
    b = _words(rng.standard_normal(shape[1]))
    want = jax.jit(jla.matmul)(jnp.asarray(a), jnp.asarray(b))
    _same(tla.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    # SYRK: a^T a through the same object
    ta = torch.from_numpy(a)
    ja = jnp.asarray(a)
    _same(tla.matmul(ta, ta, transpose_a=True).numpy(),
          jax.jit(lambda x: jla.matmul(x, x, transpose_a=True))(ja))
