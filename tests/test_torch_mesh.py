"""The port's block-sharded solve (sdpb_tpu_torch/parallel/mesh.py) as
gloo ranks on the CPU, held against sdpb_tpu's mesh solve and against
the port's own one-device solve.  Expansions, K = 3; 6 iterations of
the 1d SDP, 3 of the eight-block one.

sdpb_tpu's mesh runs are those that tests/make_torch_reference_
trajectories.py recorded on the conftest's virtual CPU devices
(sdpb_tpu_torch/data/reference_trajectories.json, which carries the hash
of sdpb_tpu's sources: the test fails when they have changed since); a
live sdpb_tpu mesh compiles for one to three minutes per problem and
device count.  The problems cross as the numpy arrays that sdpb_tpu's
reader makes (torch_port_util.jax_arrays).

- The 1d SDP at D = 2 (its one block on rank 0, a phantom on rank 1):
  y, x and every record bit for bit the port's one-device solve's (far
  inside tests/test_mesh_solver.py's 1e-40), every rank holding the
  same y.  D = 3 is test_torch_mesh_d3.py.
- The eight-block SDP of torch_dist_util.blocks_sdp with the recorded
  seeded costs at D = 2: LPT reorders its five-block bucket, so real
  blocks of a bucket sit on both ranks and Q and every MP sum add up
  contributions of two ranks.  The restored Q of the first iteration
  is bit for bit the one-device Q (exact integer residues), and y and x
  are within 1e-40 of the one-device solve, relative to their largest
  entry (only the order of the MP sums differs): the bound that
  tests/test_mesh_solver.py holds sdpb_tpu's mesh to against its
  one-device solve.
- Against sdpb_tpu's mesh, in both: the same termination and slot
  arrays, every record's duality gap within 1e-30, the step lengths to
  1e-12 relative, mu, the objectives, y and x (relative to their
  largest entry) to 1e-30 on the 1d SDP and 1e-29 on the eight-block
  one.  Not 1e-40: the
  two packages' one-device solves already differ by more (measured on
  the eight-block SDP: y 1.0e-30, x 4.6e-31, mu and the objectives up
  to 3.5e-31 relative; on the 1d SDP 2.6e-32; sdpb_tpu's rsqrt seed on
  XLA's CPU and the LAPACK eigenvectors,
  tests/test_torch_solver_expansion.py), and each mesh carries that
  over: the port's mesh is as far from sdpb_tpu's as its one-device
  solve is, to the 1e-40 above (measured 2e-48 on y, 3e-47 on x).
- The placement's slot arrays equal sdpb_tpu's shard_problem's, and
  shard_state and unshard_state are inverse.
- The limb format and the one-bucket step: test_torch_mesh_limbs.py.
"""

import dataclasses
import json
import pathlib

import jax
import mpmath
import numpy as np
import pytest
from jax.sharding import Mesh

from sdpb_tpu.io.sdp_json import read_sdp as j_read_sdp
from sdpb_tpu.mp import decimal as j_mpdec
from sdpb_tpu.parallel import mesh as j_mesh
from sdpb_tpu.solver import problem_from_raw as j_problem_from_raw
from sdpb_tpu.solver.data import bucketize as j_bucketize
from sdpb_tpu_torch.parallel import mesh
from sdpb_tpu_torch.solver import bucket_iteration as bi
from sdpb_tpu_torch.solver import driver
from sdpb_tpu_torch.solver.data import bucketed_problem_from_arrays
from sdpb_tpu_torch.solver.params import SolverParams

from torch_dist_util import (SDP_1D, blocks_sdp, mesh_round_trip,
                             mesh_solves, run_ranks, run_ranks_beside,
                             synthetic_arrays)
from torch_port_util import jax_arrays, sdpb_tpu_source_sha256
from torch_port_util import one_torch_thread  # noqa: F401

K = 3
ITERATIONS = 6          # of the 1d SDP
BLOCKS_ITERATIONS = 3   # of the eight-block SDP
REFERENCE = pathlib.Path(__file__).resolve().parents[1] / \
    "sdpb_tpu_torch" / "data" / "reference_trajectories.json"


def recorded(name):
    data = json.loads(REFERENCE.read_text())
    assert data["sdpb_tpu_sha256"] == sdpb_tpu_source_sha256(), \
        "sdpb_tpu changed since the reference was recorded: rerun " \
        "tests/make_torch_reference_trajectories.py"
    return data[name]


def _mpf(words):
    ctx = mpmath.mp.clone()
    ctx.prec = 300
    return j_mpdec.to_mpf(np.asarray(words), ctx)


def _worst(a, b, relative=False):
    """The largest difference of the MP arrays ``a`` and ``b``; with
    ``relative``, over the largest magnitude of ``b``."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    k = a.shape[-1]
    fa, fb = a.reshape(-1, k), b.reshape(-1, k)
    worst = scale = mpmath.mpf(0)
    for i in range(len(fa)):
        worst = max(worst, abs(_mpf(fa[i]) - _mpf(fb[i])))
        scale = max(scale, abs(_mpf(fb[i])))
    return worst / max(scale, mpmath.mpf("1e-300")) if relative else worst


def quickstart_arrays():
    return jax_arrays(j_bucketize(j_problem_from_raw(j_read_sdp(SDP_1D,
                                                                k=K))))


def blocks_arrays(tmp_dir):
    return jax_arrays(j_bucketize(j_problem_from_raw(j_read_sdp(
        blocks_sdp(tmp_dir), k=K))))


def one_device(arrays, iterations=ITERATIONS):
    """The port's one-device solve of ``arrays`` and its first L_Q."""
    problem, _ = bucketed_problem_from_arrays(arrays, "cpu")
    first = {}
    factorize = bi.schur_factorize

    def keep_first(prob, res, max_q_bytes=None):
        out = factorize(prob, res, max_q_bytes)
        first.setdefault("L_Q", out[2].numpy().copy())
        return out

    bi.schur_factorize = keep_first
    try:
        result = driver.solve(problem, SolverParams(
            precision=K * 53, word_dtype="float64",
            max_iterations=iterations))
    finally:
        bi.schur_factorize = factorize
    return result, first.get("L_Q")


def run_args(arrays, costs=None, dist_q_min_n=None, iterations=ITERATIONS):
    return (arrays, K * 53, "float64", iterations, dist_q_min_n, costs)


def blocks_run(tmp_dir, rec, dist_q_min_n=None):
    """The eight-block SDP's mesh_solve arguments with the recorded
    costs, and its one-device solve as a callable."""
    arrays = blocks_arrays(tmp_dir)
    return (run_args(arrays, rec["costs"], dist_q_min_n, BLOCKS_ITERATIONS),
            lambda: one_device(arrays, BLOCKS_ITERATIONS))


def against_sdpb_tpu(ours, rec, rel="1e-29"):
    """The port's mesh run ``ours`` against sdpb_tpu's recorded one:
    y, x, mu and the objectives to ``rel``."""
    assert ours["reason"] == rec["reason"]
    assert len(ours["records"]) == len(rec["iterations"])
    assert [list(s) for s in ours["slots"]] == rec["slots"]
    assert _worst(ours["y"], rec["y"], True) < mpmath.mpf(rel)
    for xo, xr in zip(ours["x"], rec["x"], strict=True):
        assert _worst(xo, xr, True) < mpmath.mpf(rel)
    ctx = mpmath.mp.clone()
    ctx.prec = 400
    for ra, rb in zip(ours["records"], rec["iterations"]):
        assert abs(ctx.mpf(ra["duality_gap"])
                   - ctx.mpf(rb["duality_gap"])) < ctx.mpf("1e-30")
        for f in ("mu", "primal_objective", "dual_objective"):
            a, b = ctx.mpf(ra[f]), ctx.mpf(rb[f])
            assert abs(a - b) <= ctx.mpf(rel) * abs(b), (f, a, b)
        for f in ("primal_step", "dual_step"):
            assert ra[f] == pytest.approx(rb[f], rel=1e-12)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 1d and the eight-block SDPs through the mesh on 2 ranks (one
    group), and each through the port's one-device solve (beside)."""
    tmp = tmp_path_factory.mktemp("mesh2")
    quick = quickstart_arrays()
    blocks_args, blocks_one = blocks_run(
        tmp / "blocks", recorded("mesh_blocks_d2"))
    outs, ones = run_ranks_beside(
        lambda: (one_device(quick), blocks_one()), mesh_solves, 2, tmp,
        [run_args(quick), blocks_args], timeout=240)
    return {name: (outs[0][i], outs[1][i], ones[i])
            for i, name in enumerate(("quickstart", "blocks"))}


def test_mesh_matches_sdpb_tpu_mesh_on_2_devices(two_ranks):
    ours, other, (one, _) = two_ranks["quickstart"]
    assert np.array_equal(other["y"], ours["y"])
    assert np.array_equal(ours["y"], one.state.y.numpy())
    for i, x in enumerate(one.state.x):
        assert np.array_equal(ours["x"][i], x.numpy())
    assert ours["records"] == [
        dict(r.__dict__, iter_time=o["iter_time"])
        for r, o in zip(one.iterations, ours["records"])]
    against_sdpb_tpu(ours, recorded("mesh_quickstart_d2"), "1e-30")


def test_blocks_over_two_ranks_match_one_device_and_sdpb_tpu(two_ranks):
    ours, other, (one, one_lq) = two_ranks["blocks"]
    assert np.array_equal(other["y"], ours["y"])
    # real blocks of a bucket on both ranks, reordered by LPT
    assert any(s[:len(s) // 2].max() >= 0 and s[len(s) // 2:].max() >= 0
               and list(s[s >= 0]) != sorted(s[s >= 0])
               for s in ours["slots"])
    assert not ours["distribute_q"]
    assert np.array_equal(ours["L_Q"], one_lq)
    assert ours["reason"] == one.reason.name
    assert _worst(ours["y"], one.state.y.numpy(), True) < mpmath.mpf("1e-40")
    for i, x in enumerate(one.state.x):
        assert _worst(ours["x"][i], x.numpy(), True) < mpmath.mpf("1e-40")
    against_sdpb_tpu(ours, recorded("mesh_blocks_d2"))


def test_slots_equal_sdpb_tpu_shard_problem():
    """bucket_slots places a bucket as sdpb_tpu's shard_problem does:
    LPT by cost above the device count, else in order and padded."""
    raw = j_read_sdp(SDP_1D, k=K)
    jp = j_bucketize(j_problem_from_raw(raw))
    devs = jax.devices("cpu")
    rng = np.random.default_rng(7)
    for n_dev in (2, 3, 4):
        jm = Mesh(np.array(devs[:n_dev]), (j_mesh.AXIS,))
        for nb in (1, 5, 8):
            bk = jp.buckets[0]
            rep = dataclasses.replace(
                bk, c=np.repeat(np.asarray(bk.c), nb, 0),
                B=np.repeat(np.asarray(bk.B), nb, 0),
                q=tuple(np.repeat(np.asarray(q), nb, 0) for q in bk.q),
                u=tuple(np.repeat(np.asarray(u), nb, 0) for u in bk.u),
                block_indices=tuple(range(nb)))
            big = dataclasses.replace(jp, buckets=[rep])
            for costs in (None, [list(rng.uniform(1, 9, nb))]):
                want = j_mesh.shard_problem(big, jm, costs=costs).perms[0]
                got = mesh.bucket_slots(nb, n_dev,
                                        None if costs is None else costs[0])
                assert list(got) == list(np.asarray(want)), (n_dev, nb)


def test_shard_and_unshard_state_round_trip(tmp_path):
    arrays = synthetic_arrays(212, "float32", ((5, 2, 4), (3, 1, 6)), 8, 5)
    outs = run_ranks(mesh_round_trip, 3, tmp_path, arrays)
    for ok in outs:
        assert ok
