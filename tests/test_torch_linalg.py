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


# ---------------------------------------------------------------------------
# The trailing-block panel loops against the whole-matrix form they
# replaced (kept here as the reference): bit for bit, NaN positions
# included.
# ---------------------------------------------------------------------------

def _whole_matrix_cholesky(a):
    """The blocked Cholesky as it updated the whole matrix per panel."""
    from sdpb_tpu_torch.mp import core
    from sdpb_tpu_torch.ops import limb_kernels as lk

    BB, n, k = a.shape[0], a.shape[-3], a.shape[-1]
    nb = tla._PANEL
    npad = (-n) % nb
    mat = tla._pad_identity(a, npad) if npad else a
    N = n + npad
    rows = torch.arange(N)
    didx = torch.arange(nb)
    for pi in range(N // nb):
        j = pi * nb
        l11 = lk.cholesky_unblocked_batched(
            mat[:, j:j + nb, j:j + nb].contiguous())
        inv_d = core.recip(l11[:, didx, didx, :])
        C = mat[:, :, j:j + nb]
        x = lk.solve_unblocked_batched(
            l11, C.transpose(1, 2).contiguous(), inv_d)
        below = (rows >= j + nb)[:, None, None]
        slab = torch.where(below, x.transpose(1, 2), 0.0)
        slab[:, j:j + nb] = l11
        mat = mat.clone()
        mat[:, :, j:j + nb] = slab
        P = torch.where(below, slab, 0.0)
        mat = core.add(mat, core.neg(tla.matmul(P, P, transpose_b=True)))
    lower = (rows[:, None] >= rows[None, :])[:, :, None]
    out = torch.where(lower, mat, 0.0)
    return out[:, :n, :n] if npad else out


def _whole_matrix_solve(l, b, transpose):
    """The blocked solve as it updated every row of B per panel."""
    from sdpb_tpu_torch.mp import core
    from sdpb_tpu_torch.ops import limb_kernels as lk

    BB, n, k = l.shape[0], l.shape[-3], l.shape[-1]
    m = b.shape[-2]
    nb = tla._PANEL
    didx = torch.arange(n)
    inv_d = core.recip(l[:, didx, didx, :])
    npad = (-n) % nb
    if npad:
        l = tla._pad_identity(l, npad)
        b = torch.cat([b, torch.zeros((BB, npad, m, k))], dim=1)
        onev = torch.as_tensor(core.one_np(k))
        inv_d = torch.cat([inv_d, onev.expand(BB, npad, k)], dim=1)
    N = n + npad
    rows = torch.arange(N)
    npanels = N // nb
    x = b
    for t in range(npanels):
        pi = npanels - 1 - t if transpose else t
        j = pi * nb
        l11 = l[:, j:j + nb, j:j + nb].contiguous()
        xp = lk.solve_unblocked_batched(
            l11, x[:, j:j + nb].contiguous(),
            inv_d[:, j:j + nb].contiguous(), transpose=transpose)
        x = x.clone()
        x[:, j:j + nb] = xp
        if transpose:
            lrow = torch.where((rows < j)[None, :, None],
                               l[:, j:j + nb], 0.0)
            x = core.add(x, core.neg(tla.matmul(lrow, xp, transpose_a=True)))
        else:
            lcol = torch.where((rows >= j + nb)[:, None, None],
                               l[:, :, j:j + nb], 0.0)
            x = core.add(x, core.neg(tla.matmul(lcol, xp)))
    return x[:, :n] if npad else x


def _same_bits(got, want):
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))


@pytest.mark.parametrize("n, bb, m", [(96, 2, 3), (256, 1, 5), (90, 1, 1)])
def test_trailing_block_route_equals_whole_matrix_route(n, bb, m):
    """n = 96 and 256 (three and eight panels), and an identity-padded
    n with BB = m = 1 (the solve's products on the plain route); the
    second matrix of a batch of two is not positive definite, so the
    NaN poisoning is compared too."""
    k = 6
    rng = np.random.default_rng(n + m)
    g = rng.standard_normal((bb, n, n))
    a_np = g @ g.transpose(0, 2, 1) + n * np.eye(n)
    if bb > 1:
        a_np[1, 40:, 40:] *= -1.0
    a = torch.from_numpy(tl.from_words_np(a_np[..., None], k))
    b = torch.from_numpy(tl.from_words_np(
        rng.standard_normal((bb, n, m))[..., None], k))
    lt = tla.cholesky(a)
    assert _same_bits(lt, _whole_matrix_cholesky(a))
    assert bool(torch.isfinite(lt[0]).all())
    if bb > 1:
        assert bool(lt[1].isnan().any())
    # a NaN in the factor poisons the solves as the whole-matrix form's
    # CRT products (or, on the plain route, the plain products) did
    lbad = lt.clone()
    lbad[0, n - 1, 3] = torch.nan
    for transpose in (False, True):
        fn = tla.solve_lower_t if transpose else tla.solve_lower
        for l_in in (lt, lbad):
            want = _whole_matrix_solve(l_in, b, transpose)
            assert _same_bits(fn(l_in, b), want), (transpose, l_in is lbad)


def test_above_512_rows_against_sdpb_tpu():
    """n = 544 (17 panels), where sdpb_tpu leaves its kernel route for
    XLA loops (right-looking column steps inside each panel, a
    row-by-row substitution).  The algorithms differ, so the results
    are held to 2^-40 relative to the largest entry: S = 8 carries 55
    bits, and a Cholesky of a well-conditioned matrix loses a few."""
    n, k, m = 544, 8, 2
    rng = np.random.default_rng(544)
    g = rng.standard_normal((n, n))
    a_np = g @ g.T + n * np.eye(n)
    a = jl.from_words_np(a_np[..., None], k)
    b = jl.from_words_np(rng.standard_normal((n, m))[..., None], k)
    lj = jla.cholesky(jnp.asarray(a))
    lt = tla.cholesky(torch.from_numpy(a))
    tol = 2.0 ** -40

    def close(got, want):
        got = torch.as_tensor(np.asarray(got))
        want = torch.as_tensor(np.asarray(want))
        diff = tl.fst(tl.sub(got, want)).abs().max().item()
        scale = tl.fst(want).abs().max().item()
        assert diff <= tol * scale, (diff, scale)

    close(lt, lj)
    l_in = torch.from_numpy(np.asarray(lj))
    close(tla.solve_lower(l_in, torch.from_numpy(b)),
          jla.solve_lower(lj, jnp.asarray(b)))
