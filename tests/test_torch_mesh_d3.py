"""The port's block-sharded solve on 3 gloo ranks, with the bounds of
test_torch_mesh.py, against its one-device solve and sdpb_tpu's mesh on
the first 3 virtual CPU devices as recorded:

- the 1d SDP (6 iterations): its one block on rank 0, phantoms on
  ranks 1 and 2; bit for bit the one-device solve;
- the eight-block SDP (3 iterations) with the recorded costs: LPT
  places the five-block bucket over all three ranks, the two-block
  bucket leaves a phantom on one rank and the one-block bucket on two;
  Q bit for bit the one-device Q, y and x within 1e-40 relative of the
  one-device solve.
"""

import mpmath
import numpy as np
import pytest

from test_torch_mesh import (against_sdpb_tpu, blocks_run, one_device,
                             quickstart_arrays, recorded, run_args, _worst)
from torch_dist_util import mesh_solves, run_ranks_beside
from torch_port_util import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh3")
    quick = quickstart_arrays()
    blocks_args, blocks_one = blocks_run(
        tmp / "blocks", recorded("mesh_blocks_d3"))
    outs, ones = run_ranks_beside(
        lambda: (one_device(quick), blocks_one()), mesh_solves, 3, tmp,
        [run_args(quick), blocks_args], timeout=240)
    return {name: ([o[i] for o in outs], ones[i])
            for i, name in enumerate(("quickstart", "blocks"))}


def test_mesh_matches_sdpb_tpu_mesh_on_3_devices(three_ranks):
    ranks, (one, _) = three_ranks["quickstart"]
    ours = ranks[0]
    for o in ranks[1:]:
        assert np.array_equal(o["y"], ours["y"])
    assert np.array_equal(ours["y"], one.state.y.numpy())
    for i, x in enumerate(one.state.x):
        assert np.array_equal(ours["x"][i], x.numpy())
    against_sdpb_tpu(ours, recorded("mesh_quickstart_d3"), "1e-30")


def test_blocks_over_three_ranks_match_one_device_and_sdpb_tpu(three_ranks):
    ranks, (one, one_lq) = three_ranks["blocks"]
    ours = ranks[0]
    for o in ranks[1:]:
        assert np.array_equal(o["y"], ours["y"])
    assert [int((s < 0).sum()) for s in ours["slots"]] == [1, 1, 2]
    assert np.array_equal(ours["L_Q"], one_lq)
    assert _worst(ours["y"], one.state.y.numpy(), True) < mpmath.mpf("1e-40")
    for i, x in enumerate(one.state.x):
        assert _worst(ours["x"][i], x.numpy(), True) < mpmath.mpf("1e-40")
    against_sdpb_tpu(ours, recorded("mesh_blocks_d3"))
