"""The port's blocked limb linear algebra against sdpb_tpu.mp.linalg
with its Pallas kernels in interpret mode and its matmuls on the
accelerator's CRT route, on the CPU.

n = 70 and 100 cover the panel loop and the identity padding.  The CRT
products are exact and the solve kernel's plain version is bit-exact,
but the Cholesky pivots and the diagonal reciprocals start from float32
estimates (rsqrt seed, quotient digits) that XLA and the port round
differently, so results are held to 2^-80 relative to the largest entry
(S = 14 carries ~100 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import limb as jl
from sdpb_tpu.mp import linalg as jla
from sdpb_tpu.ops import limb_kernels as jk
from sdpb_tpu_torch.mp import limb as tl
from sdpb_tpu_torch.mp import linalg as tla

from torch_port_util import one_torch_thread  # noqa: F401,E402

S = 14
TOL = 2.0 ** -80


@pytest.fixture
def jax_accelerator_route(monkeypatch):
    """Run sdpb_tpu's linalg as on the accelerator: Pallas kernels (in
    interpret mode) and batched products on the CRT route."""
    monkeypatch.setattr(jk, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jla, "_int_backend_ok",
                        lambda a, b, syrk: tla._int_backend_ok(
                            a.shape, b.shape[-2]))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _limbs(x):
    return jl.from_words_np(np.asarray(x, np.float64)[..., None], S)


def _close(got, want):
    """max |got - want| <= TOL * max(1, max |want|), with the difference
    taken as an exact limb subtraction (read through its float32
    estimate, which is ample for a 2^-80 bound)."""
    got = torch.as_tensor(np.asarray(got))
    want = torch.as_tensor(np.asarray(want))
    diff = tl.fst(tl.sub(got, want)).abs().max().item()
    scale = max(1.0, tl.fst(want).abs().max().item())
    assert diff <= TOL * scale, (diff, scale)


@pytest.mark.parametrize("n", [70, 100])
def test_blocked_cholesky_solves_inverse(n, jax_accelerator_route):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((1, n, n))
    a_np = g @ g.transpose(0, 2, 1) + n * np.eye(n)
    b_np = rng.standard_normal((1, n, 3))
    a, b = _limbs(a_np), _limbs(b_np)
    lj = np.asarray(jla._cholesky_limb_batched(jnp.asarray(a)))
    lt = tla.cholesky(torch.from_numpy(a)).numpy()
    _close(lt, lj)
    np.testing.assert_allclose(tl.fst(torch.from_numpy(lt)).numpy(),
                               np.linalg.cholesky(a_np), atol=1e-5 * n)
    # the solves and the inverse start from the same factor
    l_in = torch.from_numpy(lj)
    for transpose in (False, True):
        want = jla._solve_limb_batched(jnp.asarray(lj), jnp.asarray(b),
                                       transpose)
        fn = tla.solve_lower_t if transpose else tla.solve_lower
        _close(fn(l_in, torch.from_numpy(b)).numpy(), want)
    want = jla.lower_inverse(jnp.asarray(lj))
    _close(tla.lower_inverse(l_in).numpy(), want)


def test_small_ops_bitexact():
    """Routing, the plain limb matmul and the helpers at sizes below
    the CRT threshold agree bit for bit."""
    rng = np.random.default_rng(3)
    a = _limbs(rng.standard_normal((6, 5)))
    b = _limbs(rng.standard_normal((5, 4)))
    got = tla.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, np.asarray(jla.matmul(jnp.asarray(a),
                                                     jnp.asarray(b))))
    m = _limbs(rng.standard_normal((4, 4)))
    for fn_t, fn_j in ((tla.symmetrize, jla.symmetrize),
                       (tla.trace, jla.trace), (tla.diag, jla.diag)):
        assert np.array_equal(fn_t(torch.from_numpy(m)).numpy(),
                              np.asarray(fn_j(jnp.asarray(m))))
    s = jl.from_f64_np(0.25, S)
    assert np.array_equal(
        tla.add_diag(torch.from_numpy(m), torch.from_numpy(s)).numpy(),
        np.asarray(jla.add_diag(jnp.asarray(m), jnp.asarray(s))))
    assert np.array_equal(
        tla.frobenius(torch.from_numpy(m), torch.from_numpy(m)).numpy(),
        np.asarray(jla.frobenius(jnp.asarray(m), jnp.asarray(m))))
    assert tla._int_backend_ok((64, 32, S), 16)
    assert not tla._int_backend_ok((8, 32, S), 16)
    assert tla._int_backend_ok((4, 8, 32, S), 16)
