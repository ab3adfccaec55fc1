"""The sdpb CLI over several ranks (gloo on the CPU, the limb format at
--precision 212 unless noted), as a user on several GPUs runs it:

- 2 ranks write the out.txt objectives and y.txt of 1 rank within 1e-30
  relative (in fact the same text: the one block lies on rank 0, and a
  phantom adds exact zeros), and only rank 0 writes and reads the block
  costs: every output writer and the cost reader raise on rank 1;
- a SIGTERM that reaches one rank drains both (the flag is all-reduced
  at the iteration boundary): both exit 143 after the same iteration,
  with a checkpoint and no block_timings;
- a checkpoint written by 1 rank restarts on 2, and one written by 2
  restarts on 1, each continuing the uninterrupted 1-rank run's
  trajectory (objectives within 1e-30 relative); on 2 ranks only rank 0
  reads the checkpoint and the costs, and broadcasts them;
- started plainly with several visible GPUs, sdpb starts one rank per
  GPU (multihost.launch_local); launch_local's ranks (here --device cpu,
  float64 expansions) join through torchrun's variables, and a SIGTERM
  to the launcher is forwarded: every rank drains, and it exits 143.
"""

import json
import os
import signal
import subprocess
import sys
import time

import mpmath
import torch

from sdpb_tpu_torch.apps import sdpb as app
from sdpb_tpu_torch.parallel import multihost

from torch_dist_util import SDP_1D, run_cli_ranks
from torch_port_util import ROOT
from torch_port_util import one_torch_thread  # noqa: F401

BASE = ["-s", str(SDP_1D), "--precision", "212", "--verbosity", "0"]


def _fields(out_dir):
    fields = {}
    for line in (out_dir / "out.txt").read_text().splitlines():
        key, _, val = line.partition("=")
        fields[key.strip()] = val.strip().rstrip(";")
    return fields


def _same(a, b, rel="1e-30"):
    ctx = mpmath.mp.clone()
    ctx.prec = 300
    a, b = ctx.mpf(a), ctx.mpf(b)
    return abs(a - b) <= ctx.mpf(rel) * max(abs(a), abs(b), 1)


def _assert_same_solution(out, want):
    fa, fb = _fields(out), _fields(want)
    assert fa["terminateReason"] == fb["terminateReason"]
    for f in ("primalObjective", "dualObjective", "dualityGap",
              "primalError", "dualError"):
        assert _same(fa[f], fb[f]), (f, fa[f], fb[f])
    ya = (out / "y.txt").read_text().split()
    yb = (want / "y.txt").read_text().split()
    assert len(ya) == len(yb)
    for a, b in zip(ya[1:], yb[1:]):
        assert _same(a, b), (a, b)


def _records(out):
    return json.loads((out / "iterations.json").read_text())


def test_two_ranks_write_what_one_rank_writes(tmp_path):
    args = ["--maxIterations", "5"]
    argv = BASE + args + ["-o", str(tmp_path / "two"), "-c",
                          str(tmp_path / "ck_two")]
    codes, one = run_cli_ranks(
        argv, 2, tmp_path, root_only_io=True,
        beside=lambda: app.main(BASE + args + [
            "-o", str(tmp_path / "one"), "-c", str(tmp_path / "ck_one")],
            device="cpu"))
    assert (codes, one) == ([0, 0], 0)
    _assert_same_solution(tmp_path / "two", tmp_path / "one")
    assert (tmp_path / "two" / "out.txt").read_text().split("\n")[:5] == \
        (tmp_path / "one" / "out.txt").read_text().split("\n")[:5]
    assert len(_records(tmp_path / "two")) == 5
    assert (tmp_path / "ck_two" / "block_timings").read_text() == \
        (tmp_path / "ck_one" / "block_timings").read_text()


def test_sigterm_on_one_rank_drains_both(tmp_path):
    ck = tmp_path / "ck"
    argv = BASE + ["-o", str(tmp_path / "out"), "-c", str(ck),
                   "--maxIterations", "8"]
    codes = run_cli_ranks(argv, 2, tmp_path, sigterm_rank=1, sigterm_at=3)
    assert codes == [143, 143]
    assert (ck / "checkpoint.json").exists()
    assert not (ck / "block_timings").exists()
    assert len(_records(tmp_path / "out")) == 3


def test_restarts_across_world_sizes(tmp_path):
    def one_rank(*argv):
        return app.main(list(argv), device="cpu")

    whole = BASE + ["-o", str(tmp_path / "whole"), "-c",
                    str(tmp_path / "ck_whole"), "--maxIterations", "4"]
    a = BASE + ["-o", str(tmp_path / "a"), "-c", str(tmp_path / "ck_a"),
                "--maxIterations", "2"]
    b = BASE + ["-o", str(tmp_path / "b"), "-c", str(tmp_path / "ck_b"),
                "--maxIterations", "2"]
    # b's first half on 2 ranks beside a's on 1 rank; then a's second
    # half on 2 ranks beside b's on 1 and the uninterrupted run
    assert run_cli_ranks(b, 2, tmp_path,
                         beside=lambda: one_rank(*a)) == ([0, 0], 0)
    assert run_cli_ranks(a, 2, tmp_path, root_only_io=True,
                         beside=lambda: (one_rank(*b), one_rank(*whole))) \
        == ([0, 0], (0, 0))
    for out in ("a", "b"):
        _assert_same_solution(tmp_path / out, tmp_path / "whole")
        assert len(_records(tmp_path / out)) == 2


def test_several_visible_gpus_start_a_rank_each(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(multihost, "launch_local",
                        lambda module, argv, n: calls.append(
                            (module, argv, n)) or 17)
    for key in ("RANK", "WORLD_SIZE", "SDPB_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)
    argv = BASE + ["-o", str(tmp_path / "out")]
    assert app.main(argv) == 17
    assert calls == [("sdpb_tpu_torch.apps.sdpb", argv, 4)]
    assert not (tmp_path / "out").exists()


def test_launch_local_forwards_sigterm_to_every_rank(tmp_path):
    out, ck = tmp_path / "out", tmp_path / "ck"
    argv = ["-s", str(SDP_1D), "--precision", "159", "--device", "cpu",
            "-o", str(out), "-c", str(ck), "--maxIterations", "500",
            "--verbosity", "0"]
    code = ("import sys\nfrom sdpb_tpu_torch.parallel import multihost\n"
            f"sys.exit(multihost.launch_local('sdpb_tpu_torch.apps.sdpb', "
            f"{argv!r}, 2))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for key in ("RANK", "WORLD_SIZE", "SDPB_COORDINATOR"):
        env.pop(key, None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            cwd=str(tmp_path))
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            path = out / "iterations.json"
            if path.exists() and '"iteration": 2,' in path.read_text():
                break
            time.sleep(0.2)
        assert proc.poll() is None, "the ranks ended before the signal"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert (ck / "checkpoint.json").exists()
    assert not (ck / "block_timings").exists()


def test_start_up_reads_torchrun_then_the_sdpb_variables(monkeypatch):
    from sdpb_tpu_torch.parallel import comm as comm_mod

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "SDPB_COORDINATOR", "SDPB_NUM_PROCESSES", "SDPB_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.env_config() is None
    assert multihost.maybe_init_distributed("cpu") is None
    monkeypatch.setenv("SDPB_COORDINATOR", "node0:1234")
    monkeypatch.setenv("SDPB_NUM_PROCESSES", "8")
    monkeypatch.setenv("SDPB_PROCESS_ID", "5")
    assert multihost.env_config() == {
        "rank": 5, "world": 8, "local_rank": 5, "ranks_per_host": None,
        "init_method": "tcp://node0:1234"}
    monkeypatch.setenv("SDPB_COORDINATOR", "file:///tmp/x/store")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    cfg = multihost.env_config()
    assert cfg["init_method"] == "file:///tmp/x/store"
    assert (cfg["local_rank"], cfg["ranks_per_host"]) == (1, 4)
    # torchrun's variables come first
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost.env_config() == {
        "rank": 2, "world": 4, "local_rank": 1, "ranks_per_host": 4,
        "init_method": "env://"}
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert comm_mod.choose_backend(cuda, 4, 4) == "nccl"
    assert comm_mod.choose_backend(cuda, 2, 1) == "gloo"
    assert comm_mod.choose_backend(cpu, 1, 8) == "gloo"
