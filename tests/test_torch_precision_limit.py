"""The CRT prime pool's precision limit at startup, on the CPU.

The exact products (``ops/exact.py``, the same pool of primes in
4099..8191 as sdpb_tpu's) hold inputs of about 2800 bits.  Above what
the pool holds for an SDP's sizes, ``sdpb`` and ``approx_objective``
exit 2 at startup with a message naming the largest precision they
take, in either word format, where they used to die with "prime pool
exhausted" from the memory estimate.
"""

import pathlib

import pytest

from sdpb_tpu_torch.apps import approx_objective
from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.io.sdp_json import read_sdp
from sdpb_tpu_torch.ops import mpmm
from sdpb_tpu_torch.solver import memory
from sdpb_tpu_torch.solver.params import SolverParams

from torch_port_util import one_torch_thread  # noqa: F401

SDP_1D = pathlib.Path(__file__).resolve().parents[1] / "sdpb_tpu_torch" \
    / "data" / "quickstart_1d_sdp"


def _limit(word_dtype, n_rows):
    dtype = SolverParams(word_dtype=word_dtype).dtype
    return memory.max_crt_precision(
        lambda p: SolverParams(precision=p, word_dtype=word_dtype).n_words,
        dtype, n_rows)


@pytest.mark.parametrize("word_dtype", ("float32", "float64"))
def test_limit_is_the_last_precision_the_pool_holds(word_dtype):
    """At the limit the plan finds its primes; at the next precision
    with more words it runs out; the limit does not rise with the
    rows."""
    dtype = SolverParams(word_dtype=word_dtype).dtype
    words = lambda p: SolverParams(precision=p,
                                   word_dtype=word_dtype).n_words
    last = None
    for n_rows in (1, 384, 1 << 20):
        limit = _limit(word_dtype, n_rows)
        assert 2600 < limit < 3000
        assert last is None or limit <= last
        last = limit
        bits = lambda p: memory.core.precision_bits_of(words(p), dtype)
        assert mpmm.plan_for(bits(limit), n_rows).n_primes > 0
        nxt = next(p for p in range(limit + 1, limit + 200)
                   if words(p) > words(limit))
        with pytest.raises(ValueError, match="prime pool exhausted"):
            mpmm.plan_for(bits(nxt), n_rows).primes
    raw = read_sdp(SDP_1D, k=2)
    assert memory.crt_rows(memory.shape_of_raw(raw, 2)) >= raw.dual_dim


def test_sdpb_solves_at_2800_bits(tmp_path):
    """--precision 2800 (limbs, on the CPU) runs an iteration."""
    rc = app.main(["-s", str(SDP_1D), "-o", str(tmp_path / "out"), "-c",
                   str(tmp_path / "ck"), "--precision", "2800",
                   "--maxIterations", "1", "--noFinalCheckpoint",
                   "--verbosity", "0"], device="cpu")
    assert rc == 0
    assert (tmp_path / "out" / "out.txt").exists()


@pytest.mark.parametrize("device_arg", ("limbs", "expansions"))
def test_sdpb_refuses_3000_bits_naming_the_limit(tmp_path, capsys,
                                                 device_arg):
    """--precision 3000 exits 2 at startup, naming the limit, in both
    formats (limbs on a device given by the caller, expansions by
    --device cpu), and writes nothing."""
    argv = ["-s", str(SDP_1D), "-o", str(tmp_path / "out"), "-c",
            str(tmp_path / "ck"), "--precision", "3000", "--verbosity", "0"]
    if device_arg == "limbs":
        rc = app.main(argv, device="cpu")
        word_dtype = "float32"
    else:
        rc = app.main(argv + ["--device", "cpu"])
        word_dtype = "float64"
    assert rc == 2
    err = capsys.readouterr().err
    raw = read_sdp(SDP_1D, k=2)
    limit = _limit(word_dtype,
                   memory.crt_rows(memory.shape_of_raw(raw, 2)))
    assert "prime pool" in err and f"takes is {limit}" in err, err
    assert not (tmp_path / "out").exists()


def test_approx_objective_refuses_3000_bits(tmp_path, capsys):
    rc = approx_objective.main(
        ["--sdp", str(SDP_1D), "--precision", "3000", "--newSdp",
         str(SDP_1D), "--solutionDir", str(tmp_path / "missing"), "-v",
         "0"], device="cpu")
    assert rc == 2
    err = capsys.readouterr().err
    assert "prime pool" in err and "largest precision" in err, err
