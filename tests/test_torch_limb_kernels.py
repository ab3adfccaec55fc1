"""The port's limb kernels' plain versions against the Pallas kernels of
sdpb_tpu.ops.limb_kernels, run in interpret mode on the CPU.

The solve is mul/add/neg only, exact integer arithmetic in float32, so
it must agree bit for bit.  The Cholesky pivots go through sqrt_rsqrt,
whose float32 rsqrt seed differs between XLA and the port, so the
factor is held to 2^-80 relative to the largest entry (the limb format
at S=14 carries ~100 bits; the seed difference leaves noise in the
guard limb only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpb_tpu.mp import limb as jl
from sdpb_tpu.ops import limb_kernels as jk
from sdpb_tpu_torch.mp import limb as tl
from sdpb_tpu_torch.ops import limb_kernels as tk

from torch_port_util import one_torch_thread  # noqa: F401,E402

S = 14


def _spd(rng, bb, n):
    a = rng.standard_normal((bb, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _limbs(x):
    return jl.from_words_np(np.asarray(x, np.float64)[..., None], S)


def _value(x):
    """float32 estimate of limb arrays, for coarse checks."""
    return tl.fst(torch.as_tensor(np.asarray(x))).numpy()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a) & np.isnan(b)
    assert np.array_equal(np.where(nan, 0, a), np.where(nan, 0, b))


@pytest.mark.parametrize("n,m", [(8, 5), (32, 40), (48, 5)])
@pytest.mark.parametrize("transpose", [False, True])
def test_solve_plain_matches_pallas(n, m, transpose):
    rng = np.random.default_rng(n + m + transpose)
    bb = 2
    l_np = np.linalg.cholesky(_spd(rng, bb, n))
    l = _limbs(l_np)
    b = _limbs(rng.standard_normal((bb, n, m)))
    inv_d = np.asarray(jl.recip(jnp.asarray(l[:, np.arange(n),
                                               np.arange(n)])))
    want = jk.solve_unblocked_batched(
        jnp.asarray(l), jnp.asarray(b), jnp.asarray(inv_d),
        transpose=transpose, interpret=True)
    got = tk.solve_unblocked_batched(
        torch.from_numpy(l), torch.from_numpy(b), torch.from_numpy(inv_d),
        transpose=transpose)
    _same(got.numpy(), want)


@pytest.mark.parametrize("n", [8, 32, 48])
def test_cholesky_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    a_np = _spd(rng, 2, n)
    a = _limbs(a_np)
    want = np.asarray(jk.cholesky_unblocked_batched(jnp.asarray(a),
                                                    interpret=True))
    got = tk.cholesky_unblocked_batched(torch.from_numpy(a)).numpy()
    diff = tl.fst(tl.sub(torch.from_numpy(got), torch.from_numpy(want)))
    scale = np.max(np.abs(_value(want)))
    assert diff.abs().max().item() <= 2.0 ** -80 * scale
    assert np.all(got[:, np.triu_indices(n, 1)[0],
                      np.triu_indices(n, 1)[1]] == 0.0)
    np.testing.assert_allclose(_value(got), np.linalg.cholesky(a_np),
                               rtol=0, atol=1e-5 * scale)


def test_cholesky_non_pd_poisons():
    a = torch.from_numpy(_limbs(-np.eye(4)[None]))
    got = tk.cholesky_unblocked_batched(a).numpy()
    want = np.asarray(jk.cholesky_unblocked_batched(
        jnp.asarray(a.numpy()), interpret=True))
    assert not np.isfinite(got[0, 3, 3]).all()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))


def test_wrappers_check_inputs():
    l = torch.zeros(1, 4, 4, S)
    with pytest.raises(ValueError):
        tk.solve_unblocked_batched(l, torch.zeros(1, 3, 2, S),
                                   torch.zeros(1, 4, S))
    with pytest.raises(TypeError):
        tk.cholesky_unblocked_batched(l.double())
    with pytest.raises(ValueError):
        tk.cholesky_unblocked_batched(torch.zeros(1, 4, 5, S))
    with pytest.raises(ValueError):
        tk._check_slots("x", tk.MAX_SLOTS + 1)


def test_cpu_tensors_take_the_plain_version():
    tk.reset_launches()
    a = torch.from_numpy(_limbs(np.eye(3)[None] * 4.0))
    out = tk.cholesky_unblocked_batched(a)
    assert tk.LAUNCHES["cholesky_unblocked_batched"] == 0
    assert _value(out.numpy())[0, 1, 1] == 2.0


def test_elementwise_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(_limbs(rng.standard_normal((6, 5))))
    b = torch.from_numpy(_limbs(rng.standard_normal((5,))))
    tk.reset_launches()
    for kern, plain in ((tk.limb_add, tl.add_plain),
                        (tk.limb_mul, tl.mul_plain),
                        (tk.limb_div, tl.div_plain)):
        _same(kern(a, b).numpy(), plain(a, b).numpy())
    _same(tl.sqrt_rsqrt(tl.abs_(a))[1].numpy(),
          tl.sqrt_rsqrt_plain(tl.abs_(a))[1].numpy())
    _same(tl.recip(a).numpy(), tl.recip_plain(a).numpy())
    assert sum(tk.LAUNCHES.values()) == 0
