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


# Launch geometry of the factorization kernels (no card needed): the
# Python side picks warps, tile width and shared memory; the CUDA
# launchers are built for the (registers, warps) pairs listed here.
CHOL_BUILT = {(1, 32), (2, 16), (3, 16), (4, 8), (5, 8)}
SOLVE_BUILT = {(1, 8), (2, 8), (3, 8), (4, 8), (5, 8)}
MAIN_PATH_CHOL = [(48, 32, 47), (16, 48, 47), (1, 32, 47), (1, 8, 26),
                  (4, 32, 26)]
MAIN_PATH_SOLVE = [(272, 32, 32, 47), (48, 32, 96, 47), (1, 32, 384, 47),
                   (48, 32, 32, 47), (16, 48, 48, 47), (1, 8, 1, 26),
                   (1, 5, 5, 26)]


@pytest.mark.parametrize("S", [4, 26, 29, 30, 47, 61, 62, 93, 94, 116, 125,
                               126, 128])
def test_geometry_fits_shared_memory_for_every_n(S):
    R = tk.value_regs(S)
    assert 32 * R >= S + 3 > 32 * (R - 1)
    for n in range(1, 65):
        chol = tk.chol_geometry(n, S)
        assert chol["smem"] <= tk.SMEM_LIMIT == 232_448
        assert (R, chol["warps"]) in CHOL_BUILT
        for BB, m in ((1, 1), (1, n), (3, 40), (272, 32), (1, 384)):
            solve = tk.solve_geometry(BB, n, m, S)
            assert solve["smem"] <= tk.SMEM_LIMIT
            assert (R, solve["warps"]) in SOLVE_BUILT
            assert 1 <= solve["tm"] <= min(m, tk.SOLVE_MAX_TILE)
            assert solve["blocks"] == BB * -(-m // solve["tm"])


@pytest.mark.parametrize("bb,n,S", MAIN_PATH_CHOL)
def test_cholesky_geometry_at_main_path_shapes(bb, n, S):
    geo = tk.chol_geometry(n, S)
    R = tk.value_regs(S)
    # scaled column, the pivot's sqrt and rsqrt, the warps' scratch rows
    want = 4 * (n * S + 2 * S + geo["warps"] * (96 * R + tk.ROW_PAD))
    assert geo["smem"] == want <= tk.SMEM_LIMIT


@pytest.mark.parametrize("bb,n,m,S", MAIN_PATH_SOLVE)
def test_solve_geometry_at_main_path_shapes(bb, n, m, S):
    geo = tk.solve_geometry(bb, n, m, S)
    assert geo["smem"] <= tk.SMEM_LIMIT
    # the grid covers every SM once wherever there are enough columns
    assert geo["blocks"] >= min(tk.SMS, bb * m)


def test_q_panel_solve_covers_the_card():
    """The (1, 32, 32) x 384 panel solve of the blocked Q Cholesky ran on
    48 blocks in the first port; it must fill the card's 132 SMs."""
    geo = tk.solve_geometry(1, 32, 384, 47)
    assert geo["blocks"] >= 132


def test_geometry_refuses_more_than_max_slots():
    S = tk.MAX_SLOTS + 1
    for call in (lambda: tk.value_regs(S), lambda: tk.chol_geometry(8, S),
                 lambda: tk.solve_geometry(1, 8, 4, S)):
        with pytest.raises(ValueError):
            call()
    tk.chol_geometry(64, tk.MAX_SLOTS)
    tk.solve_geometry(1, 64, 32, tk.MAX_SLOTS)


# Slot classes above 128 slots (--precision above 1134 bits): the
# smallest class that holds S, the warps and shared memory of the
# launches at every n a kernel takes, and the refusal above 512 slots.
@pytest.mark.parametrize("S, cls", [(4, (4, 128)), (116, (4, 128)),
                                    (128, (4, 128)), (129, (129, 256)),
                                    (130, (129, 256)), (230, (129, 256)),
                                    (256, (129, 256)), (257, (257, 512)),
                                    (458, (257, 512)), (512, (257, 512))])
def test_slot_class_and_geometry_up_to_512_slots(S, cls):
    assert tk.slot_class(S) == cls
    R = tk.value_regs(S)
    assert 32 * R >= S + 3 > 32 * (R - 1)
    for n in range(1, 65):
        assert tk.chol_geometry(n, S)["smem"] <= tk.SMEM_LIMIT
        for BB, m in ((1, 1), (1, n), (2, 24), (1, 384)):
            assert tk.solve_geometry(BB, n, m, S)["smem"] <= tk.SMEM_LIMIT


def test_slot_classes_cover_4096_bits_and_refuse_more():
    assert tl.slots_for_precision(1152) == 130
    assert tl.slots_for_precision(2048) == 230
    assert tl.slots_for_precision(4096) == 458
    assert tk.max_precision_bits() == 4590
    assert tl.slots_for_precision(tk.max_precision_bits()) == 512
    for S in (513, tl.slots_for_precision(tk.max_precision_bits() + 1)):
        with pytest.raises(ValueError, match="--precision 4590"):
            tk.slot_class(S)
    with pytest.raises(ValueError):
        tk.slot_class(3)


# The elementwise kernel (csrc/limb_elementwise.cu): one value per warp,
# four warps a block, a warp for each value; the scratch rows stay under
# the 48 KB a block gets without opting in, at every S up to 512 slots.
@pytest.mark.parametrize("S", [4, 26, 29, 47, 116, 128, 130, 230, 256, 257,
                               458, 512])
def test_elementwise_geometry_for_every_n(S):
    R = tk.value_regs(S)
    for n in (1, 2, 4, 5, 9, 4096, 49152, 10 ** 7):
        geo = tk.elementwise_geometry(n, S)
        assert tk.ELEMENTWISE_WARPS == 4
        assert geo["blocks"] == -(-n // 4)
        assert geo["smem"] == 4 * 4 * (96 * R + tk.ROW_PAD) <= 48 * 1024
    assert tk.elementwise_geometry(1, S)["blocks"] == 1


def test_elementwise_operand_reads_one_value_in_place():
    """A single value broadcast over the batch goes to the kernel as it
    is, with batch stride 0; any other operand is broadcast and made
    contiguous (stride S), without a copy when it already is."""
    a = torch.from_numpy(_limbs(np.arange(1.0, 13.0).reshape(3, 4)))
    batch = (3, 4)
    for one in (a[1, 2], a[1:2, 2:3], a[1, 2][None, None, None]):
        x, stride = tk.elementwise_operand(one, batch)
        assert stride == 0 and x.shape == (S,) and x.is_contiguous()
        assert torch.equal(x, a[1, 2])
    x, stride = tk.elementwise_operand(a, batch)
    assert stride == S and x.data_ptr() == a.data_ptr()
    x, stride = tk.elementwise_operand(a[:, :1], batch)
    assert stride == S and x.shape == (3, 4, S) and x.is_contiguous()
    assert torch.equal(x, a[:, :1].expand(3, 4, S))
    x, stride = tk.elementwise_operand(a[:, 1], (2, 3))
    assert stride == S and torch.equal(x, a[:, 1].expand(2, 3, S))
