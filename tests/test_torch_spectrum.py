"""The port's spectrum (and the LPT half of solver/placement.py that
spreads its blocks over worker processes) against sdpb_tpu's, on the
CPU.

Inputs: the committed quickstart SDP (its pmp_info.json) and the
solution sdpb_tpu's recorded expansion run left
(data/reference_trajectories.json, "quickstart_1d_expansion": y and
x at K = 4 words).  Each package writes x_0.txt and
c_minus_By/c_minus_By.json from those words with its own writers
(io/output.py), then runs its own spectrum CLI; the files must be equal
byte for byte.  For the worker pool, a seeded two-block input: the
quickstart block twice, the second with a seeded positive shift of
c - B y.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpb_tpu.apps import spectrum as jax_spectrum
from sdpb_tpu.io import output as jax_output
from sdpb_tpu.io.sdp_json import read_sdp as jax_read_sdp
from sdpb_tpu.solver import placement as jax_placement
from sdpb_tpu.solver.data import bucketize as jax_bucketize
from sdpb_tpu.solver.data import problem_from_raw as jax_problem_from_raw
from sdpb_tpu_torch.apps import spectrum
from sdpb_tpu_torch.io import output
from sdpb_tpu_torch.io.sdp_json import read_sdp
from sdpb_tpu_torch.pmp.core import make_ctx
from sdpb_tpu_torch.solver import placement
from sdpb_tpu_torch.solver.data import bucketed_problem_from_raw

from torch_port_util import one_torch_thread  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SDP_1D = ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
REFERENCE = ROOT / "sdpb_tpu_torch" / "data" / "reference_trajectories.json"


@pytest.fixture(scope="module")
def solution():
    return json.loads(REFERENCE.read_text())["quickstart_1d_expansion"]


def _write_solution(tmp_path, solution):
    """x_0.txt and c_minus_By.json from the recorded words, by each
    package's writers; returns the two solution directories."""
    k = solution["words"]
    y = np.asarray(solution["solution"]["y"], dtype=np.float64)
    x = np.asarray(solution["solution"]["blocks"][0]["x"],
                   dtype=np.float64)
    jax_problem = jax_bucketize(jax_problem_from_raw(
        jax_read_sdp(SDP_1D, k=k), dtype=jnp.float64, k=k))
    problem = bucketed_problem_from_raw(read_sdp(SDP_1D, k=k), k, "cpu",
                                        torch.float64)
    dirs = {}
    for tag, io_mod, prob, y_in in (
            ("jax", jax_output, jax_problem, jnp.asarray(y)),
            ("torch", output, problem, torch.as_tensor(y))):
        out = tmp_path / tag / "out"
        io_mod.save_c_minus_By(out / "c_minus_By" / "c_minus_By.json", prob,
                               y_in)
        io_mod.write_vector(out / "x_0.txt", x)
        dirs[tag] = out
    return dirs


def _argv(sol, out, precision=768, jobs=1):
    return ["--precision", str(precision), "-i",
            str(SDP_1D / "pmp_info.json"), "--solution", str(sol),
            "--threshold", "1e-10", "-o", str(out), "-j", str(jobs),
            "-v", "0"]


def test_spectrum_of_the_recorded_solution_byte_for_byte(tmp_path,
                                                         solution):
    dirs = _write_solution(tmp_path, solution)
    for name in ("x_0.txt", "c_minus_By/c_minus_By.json"):
        assert (dirs["torch"] / name).read_bytes() == \
            (dirs["jax"] / name).read_bytes(), name
    assert jax_spectrum.main(_argv(dirs["jax"], tmp_path / "j.json")) == 0
    assert spectrum.main(_argv(dirs["torch"], tmp_path / "t.json")) == 0
    got = (tmp_path / "t.json").read_bytes()
    assert got == (tmp_path / "j.json").read_bytes()
    doc = json.loads(got)
    assert [len(b["zeros"]) for b in doc] == [1]
    assert "lambda" in doc[0]["zeros"][0] and "error" in doc[0]


def _two_blocks(tmp_path, dirs):
    """pmp_info.json with the quickstart block twice (indices 0 and 1),
    c - B y of the second shifted by a seeded positive amount, x twice."""
    rng = np.random.default_rng(5)
    info = json.loads((SDP_1D / "pmp_info.json").read_text())
    second = dict(info[0], index=1, path="second")
    (tmp_path / "pmp_info.json").write_text(json.dumps(info + [second]))
    sol = tmp_path / "two"
    (sol / "c_minus_By").mkdir(parents=True)
    cmb = json.loads((dirs["torch"] / "c_minus_By" /
                      "c_minus_By.json").read_text())["c_minus_By"][0]
    shifted = [f"{float(v) + s:.30e}" for v, s in
               zip(cmb, rng.uniform(0.01, 0.1, len(cmb)))]
    (sol / "c_minus_By" / "c_minus_By.json").write_text(
        json.dumps({"c_minus_By": [cmb, shifted]}))
    x = (dirs["torch"] / "x_0.txt").read_text()
    (sol / "x_0.txt").write_text(x)
    (sol / "x_1.txt").write_text(x)
    return tmp_path / "pmp_info.json", sol


def test_worker_pool_output_equals_serial(tmp_path, solution):
    """Two spawn workers, blocks dealt by LPT: the same spectrum.json,
    byte for byte, as the serial path and as sdpb_tpu's."""
    info, sol = _two_blocks(tmp_path, _write_solution(tmp_path, solution))
    outs = {}
    for tag, main, jobs in (("serial", spectrum.main, 1),
                            ("pool", spectrum.main, 2),
                            ("jax", jax_spectrum.main, 1)):
        argv = _argv(sol, tmp_path / f"{tag}.json", 256, jobs)
        argv[argv.index("-i") + 1] = str(info)
        assert main(argv) == 0
        outs[tag] = (tmp_path / f"{tag}.json").read_bytes()
    assert outs["pool"] == outs["serial"] == outs["jax"]
    assert len(json.loads(outs["pool"])) == 2


@pytest.mark.parametrize("n_bins,capacity", [(1, None), (3, None), (4, 3),
                                              (7, None), (5, 2)])
def test_lpt_equal_to_sdpb_tpu(n_bins, capacity):
    costs = np.random.default_rng(n_bins).integers(1, 100, 10).astype(float)
    costs[3] = costs[6]          # a tie, broken by the stable sort
    got = placement.lpt_assign(costs, n_bins, capacity)
    want = jax_placement.lpt_assign(costs, n_bins, capacity)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert placement.imbalance(got[1]) == jax_placement.imbalance(want[1])
    assert placement.imbalance(np.zeros(3)) == 0.0
    if n_bins > 1:
        for a, b in zip(placement.bucket_device_permutation(costs, n_bins),
                        jax_placement.bucket_device_permutation(costs,
                                                                n_bins)):
            assert np.array_equal(a, b)


def test_bucket_loads_equal_to_sdpb_tpu():
    from sdpb_tpu_torch.solver.data import block_shape_of
    from sdpb_tpu_torch.solver.memory import ProblemShape, ShapeBucket

    shape = ProblemShape(buckets=[ShapeBucket(5, block_shape_of(2, 9)),
                                  ShapeBucket(2, block_shape_of(1, 4)),
                                  ShapeBucket(0, block_shape_of(3, 3))],
                         dual_dim=6, k=4)
    for n in (1, 2, 3, 8):
        assert np.array_equal(placement.bucket_loads(shape, None, n),
                              jax_placement.bucket_loads(shape, None, n))


def test_host_only(tmp_path, solution, monkeypatch):
    """spectrum touches no device: it runs with no CUDA device and
    without a device argument."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = _write_solution(tmp_path, solution)
    argv = _argv(dirs["torch"], tmp_path / "t.json", 128)
    assert spectrum.main(argv + ["--lambda", "false"]) == 0
    assert "lambda" not in json.loads(
        (tmp_path / "t.json").read_text())[0]["zeros"][0]
    ctx = make_ctx(128)
    assert spectrum.read_pmp_info(SDP_1D / "pmp_info.json", ctx)[0].dim == 1


def test_zero_moves_less_than_y(tmp_path, solution):
    """chip_smoke.py phase 6 holds the zero of the card's solution (the
    limb format at --precision 212, duality gap below 1e-30) to the zero
    of this recorded one within 1e-30: two such solutions' y (the
    objective is -y) differ by about 1e-30 relative, and a relative
    change d of y moves the zero by ~0.61 d (measured here: 6.14e-31 for
    d = 1e-30; the port's limb solve of the 1d SDP on the CPU lands
    5.9e-36 from the recorded zero)."""
    import mpmath as mpm

    k = solution["words"]
    y = np.asarray(solution["solution"]["y"], dtype=np.float64)
    x = np.asarray(solution["solution"]["blocks"][0]["x"], dtype=np.float64)
    problem = bucketed_problem_from_raw(read_sdp(SDP_1D, k=k), k, "cpu",
                                        torch.float64)
    zeros = []
    for tag, shift in (("a", 0.0), ("b", 1e-30)):
        yp = y.copy()
        yp[:, 1] += yp[:, 0] * shift
        out = tmp_path / tag
        output.save_c_minus_By(out / "c_minus_By" / "c_minus_By.json",
                               problem, torch.as_tensor(yp))
        output.write_vector(out / "x_0.txt", x)
        assert spectrum.main(_argv(out, out / "s.json")) == 0
        zeros.append(json.loads((out / "s.json").read_text())[0]["zeros"])
    ctx = mpm.mp.clone()
    ctx.prec = 2600
    assert len(zeros[0]) == len(zeros[1]) == 1
    moved = abs(ctx.mpf(zeros[0][0]["zero"]) - ctx.mpf(zeros[1][0]["zero"]))
    assert ctx.mpf("0.5e-30") < moved < ctx.mpf("0.7e-30")
