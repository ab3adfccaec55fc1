"""The port's CRT pipeline (ops/exact.py, ops/mpmm.py) against
sdpb_tpu.ops.exact/mpmm on the CPU: integer arithmetic throughout, so
every stage must agree exactly."""

import jax.numpy as jnp
import numpy as np
import torch

from sdpb_tpu.mp import limb as jl
from sdpb_tpu.ops import exact as je
from sdpb_tpu.ops import mpmm as jm
from sdpb_tpu_torch.ops import exact as te
from sdpb_tpu_torch.ops import mpmm as tm

from torch_port_util import one_torch_thread  # noqa: F401,E402

S = 14


def _limbs(rng, shape, scale_exp=0):
    e = rng.integers(-30, 0, size=shape[-1:])      # per-column scales
    words = rng.standard_normal(shape + (2,))
    words[..., 1] *= 2.0 ** -53
    words *= 2.0 ** (e + scale_exp)[:, None]
    return jl.from_words_np(words, S)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    nan = np.isnan(a) & np.isnan(b)
    assert np.array_equal(np.where(nan, 0, a), np.where(nan, 0, b))


def test_plan_tables_match():
    jp, tp = jm.plan_for(jl.precision_bits(S), 100), \
        tm.plan_for(jl.precision_bits(S), 100)
    assert (jp.bits, jp.n_rows_max) == (tp.bits, tp.n_rows_max)
    for name in ("primes", "base_pow_mod", "crt_c", "crt_weights",
                 "m_planes"):
        _eq(getattr(tp, name), getattr(jp, name))


def test_residues_syrk_gemm_restore_exact():
    rng = np.random.default_rng(0)
    plan_j = jm.plan_for(jl.precision_bits(S), 40)
    plan_t = tm.plan_for(jl.precision_bits(S), 40)
    x = _limbs(rng, (40, 6))
    y = _limbs(rng, (40, 5))
    e_x = np.asarray(jnp.max(jm.exponents(jnp.asarray(x)), axis=0))
    e_y = np.asarray(jnp.max(jm.exponents(jnp.asarray(y)), axis=0))
    dj = jm.digits_dev(jm.scale_pow2(jnp.asarray(x), -e_x[None]), plan_j)
    dt = tm.digits_dev(tm.scale_pow2(torch.from_numpy(x),
                                     torch.from_numpy(-e_x[None])), plan_t)
    _eq(dt.numpy(), dj)
    rj = je.residues_split(dj, plan_j)
    rt = te.residues_split(dt, plan_t)
    for a, b in zip(rt, rj):
        _eq(a.numpy(), b)
    qj = je.syrk_residues_split(rj, plan_j)
    qt = te.syrk_residues_split(rt, plan_t)
    _eq(qt.numpy(), qj)
    _eq(te.syrk_diag_residues_split(rt, plan_t).numpy(),
        je.syrk_diag_residues_split(rj, plan_j))
    dyj = jm.digits_dev(jm.scale_pow2(jnp.asarray(y), -e_y[None]), plan_j)
    ryj = je.residues_split(dyj, plan_j)
    ryt = te.residues_split(torch.from_numpy(np.asarray(dyj)), plan_t)
    gj = je.gemm_residues_split(rj, ryj, plan_j)
    gt = te.gemm_residues_split(rt, ryt, plan_t)
    _eq(gt.numpy(), gj)
    _eq(te.crt_restore_planes(qt, plan_t).numpy(),
        je.crt_restore_planes(qj, plan_j))
    _eq(tm.restore_q_mp(qt, torch.from_numpy(e_x), plan_t, S).numpy(),
        jm.restore_q_mp(qj, jnp.asarray(e_x), plan_j, S, jnp.float32))
    two = np.asarray(qj) * 2
    _eq(tm.reduce_residues_mod(torch.from_numpy(two), plan_t).numpy(),
        jm.reduce_residues_mod(jnp.asarray(two), plan_j))


def test_syrk_gemm_mp_batched_exact():
    rng = np.random.default_rng(1)
    plan_j = jm.plan_for(jl.precision_bits(S), 24)
    plan_t = tm.plan_for(jl.precision_bits(S), 24)
    x = np.stack([_limbs(rng, (24, 7)) for _ in range(3)])
    y = np.stack([_limbs(rng, (24, 4)) for _ in range(3)])
    x[2, 3, 1] = np.nan                      # poisons batch 2 only
    want = np.asarray(jm.syrk_mp_batched(jnp.asarray(x), plan_j))
    got = tm.syrk_mp_batched(torch.from_numpy(x), plan_t).numpy()
    _eq(got, want)
    assert np.isnan(got[2]).all() and np.isfinite(got[:2]).all()
    _eq(tm.gemm_mp_batched(torch.from_numpy(x), torch.from_numpy(y),
                           plan_t).numpy(),
        jm.gemm_mp_batched(jnp.asarray(x), jnp.asarray(y), plan_j))
