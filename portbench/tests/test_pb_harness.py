"""The harness on the CPU at a tiny size: cells, configurations, traffic
mixes and per-layer metrics found as new files; the result line; the
runs that must print no result; the import check."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

from . import pbutil

CELL = "p400-limbs.tiny"
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with a new configuration, a new traffic mix, a new
    metric and a new cell, each added as files and entries only."""
    r = pbutil.bench_root(tmp_path_factory.mktemp("pb"))
    (r / "portbench/metrics/test.iterations.py").write_text(
        "def read(run):\n    return float(run.iterations)\n")
    pbutil.add_cell(
        r, CELL, "tiny-p400-limbs", "tiny",
        traffic_body={"about": "one solve, no restart", "restart": False},
        config_body=pbutil.tiny_config("tiny-p400-limbs"),
        metrics=[{"name": "test.iterations", "unit": "iter",
                  "better": "higher", "source": "program_counter",
                  "layer": "driver", "moves": "iter_s",
                  "workloads": [CELL]}])
    return r


def _last(lines):
    return json.loads(lines[-1])


def test_traced_run_finds_new_files(root):
    rc, lines, err = pbutil.run_cell(root, [
        "--workload", CELL, "--seed", str(SEED), "--seconds", "0.1",
        "--trace", "1"])
    assert rc == 0, err
    res = _last(lines)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True, res["check"]
    assert res["metrics"]["test.iterations"]["value"] == 1.0
    assert res["metrics"]["driver.residues_s"]["value"] > 0
    # no device trace on the CPU: its metrics are left out, not 0
    assert "device.idle_share" not in res["metrics"]
    for name, v in res["check"].items():
        assert set(v) == {"value", "limit"}
        assert f"check {name} " in err


def test_plain_run_reports_end_to_end(root):
    rc, lines, err = pbutil.run_cell(root, [
        "--workload", CELL, "--seed", str(SEED + 1), "--seconds", "0.1",
        "--trace", "0"])
    assert rc == 0, err
    res = _last(lines)
    assert set(res["metrics"]) == {"iter_s", "peak_mem_gib", "setup_s"}
    assert res["attempted"] == 1 and res["failed"] == 0
    assert res["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check errors ")


def test_no_card_no_result(root):
    from portbench import run

    if run.forbidden_modules():
        pytest.skip("JAX is loaded in this process")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ runs nothing."""
    r = pbutil.bench_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "p400-limbs.nmax6", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=r, capture_output=True, text=True,
        timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_names_are_whole(monkeypatch):
    from portbench import run

    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sdpb_tpu_torch_fake",
                        types.ModuleType("sdpb_tpu_torch_fake"))
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "sdpb_tpu.fake",
                        types.ModuleType("sdpb_tpu.fake"))
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert set(run.forbidden_modules()) - base == {"sdpb_tpu.fake",
                                                   "jaxlib.fake"}


def test_run_and_reference_load_no_jax(root):
    """A whole run in a fresh process loads neither JAX nor the JAX
    package, and the reference alone loads nothing of the program."""
    code = f"""
import sys
sys.path.insert(0, {str(pbutil.REPO)!r})
from portbench.reference import mpt, sdp, words
from portbench import check
assert not [m for m in sys.modules if m.split('.')[0] in
            ('sdpb_tpu_torch', 'sdpb_tpu', 'jax', 'jaxlib', 'flax')]
from pathlib import Path
from portbench import run, control
rc = run.run(['--workload', {CELL!r}, '--seed', '7', '--seconds', '0.1',
              '--trace', '1'], device='cpu', root=Path({str(root)!r}))
assert rc == 0, rc
print('LEAKED', run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout


def test_trace_covers_the_iterations_after_the_first(root, monkeypatch):
    """A traced window runs TRACE_AFTER iterations plain (they give the
    driver's metrics), profiles the next TRACED_ITERATIONS with the
    program's functions wrapped, and puts the functions back."""
    import torch

    from portbench import problem as pb
    from portbench import run
    from sdpb_tpu_torch.solver import bucket_iteration as bit

    monkeypatch.setattr(run, "TRACE_AFTER", 1)
    monkeypatch.setattr(run, "TRACED_ITERATIONS", 1)
    config = run.load_cell(root, CELL)["config"]
    params = run.solver_params(config)
    data = pb.generate(SEED, [tuple(b) for b in config["blocks"]],
                       int(config["n_dual"]))
    problem, _ = pb.to_program(data, params, "cpu")
    original = bit.compute_step
    win = run.window(problem, params, 0.0, torch.device("cpu"), True,
                     max_iterations=3, restart=False)
    assert bit.compute_step is original
    assert win.iterations == 3 and win.traced_iterations == 1
    assert len(win.untraced_phase_s) == 1
    assert [s[0] for s in win.spans.spans].count("step") == 1
    metrics = pbutil.REPO / "portbench" / "metrics"
    info = types.SimpleNamespace(phase_s=win.untraced_phase_s)
    assert run._read_metric(metrics / "driver.step_s.py", info) == \
        win.untraced_phase_s[0][1]
    info.phase_s = []
    assert run._read_metric(metrics / "driver.step_s.py", info) is None


def test_trace_arithmetic():
    """Busy time, idle gaps named by the span open, kernel classes and
    launches, from a device trace made by hand."""
    from torch.autograd import DeviceType

    from portbench import trace

    class Ev:
        def __init__(self, name, t0, dur, dev=DeviceType.CUDA):
            self._n, self._t, self._d, self._dev = name, t0, dur, dev

        def name(self):
            return self._n

        def start_ns(self):
            return self._t

        def duration_ns(self):
            return self._d

        def device_type(self):
            return self._dev

    evs = [Ev("void at::native::spin_kernel()", 1000, 10),
           Ev("void f<int>(int)", 2000, 100),
           Ev("void g<int>(int)", 2050, 100),          # overlaps f
           Ev("Memcpy DtoH", 2500, 50),
           Ev("volta_dgemm_64x64", 3000, 500),
           Ev("void (anonymous namespace)::chol_warp_kernel<47>()", 4000,
              200),
           Ev("host op", 0, 5, DeviceType.CPU)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    dt = trace.DeviceTrace(prof, host_mark_ns=400)
    assert dt.offset == 600
    assert dt.busy_ns() == 150 + 50 + 500 + 200
    assert dt.gaps(2000, 4300) == [(2150, 2500), (2550, 3000),
                                   (3500, 4000), (4200, 4300)]
    assert dt.kernel_launches() == 4
    cls = dt.by_class()
    assert cls["integer_glue"] == pytest.approx(200e-9)
    assert cls["matmul"] == pytest.approx(500e-9)
    assert cls["port_kernels"] == pytest.approx(200e-9)
    assert dt.by_name(r"chol_warp_kernel<")[1] == 1
    spans = trace.Spans()
    spans.spans = [("step.schur_factorize", 1500, 1800), ("step", 1400, 3000),
                   ("residues", 3100, 3600)]
    assert spans.labels_at([1450, 1600, 2900, 3050, 3200, 3700]) == [
        "step", "step.schur_factorize", "step", "driver", "residues",
        "driver"]
