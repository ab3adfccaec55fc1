"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program, ``sdpb_tpu_torch``, on a machine with an NVIDIA GPU.

The cell names a configuration (``BENCHMARK.json``'s ``file``: the
precision, the solver's parameters and the SDP's block structure) and a
traffic mix (``portbench/traffic/<traffic>.json``); its limits are in
``portbench/limits/<workload>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Set-up builds the seed's problem and
warms the program up with one iteration; the window then drives
``sdpb_tpu_torch.solver.driver.solve`` from the stock cold start,
iterations back to back (a solve that ends is followed by the next, from
the cold start, where the traffic says ``restart``), until ``--seconds``
have passed and the iteration in flight has ended.  Once the window has
closed and the peak memory is read, the plain reference
(``portbench/reference/``) judges every iteration the window ran
(``portbench/check.py``).  The last line of standard output is the
result as one JSON object.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sdpb_tpu")
WORD_FORMATS = {"limbs": "float32", "expansions": "float64"}
# A traced window runs TRACE_AFTER iterations as a plain one does (the
# driver's spans of these give driver.*_s: iterations after a profiler
# has run on the card are ~20% slower), then TRACED_ITERATIONS under the
# profiler and the benchmark's spans and kernel records (~51,000 launches
# an iteration of the nmax6 SDP: a whole window's trace would take
# minutes to read), then the rest plain again.
TRACE_AFTER = 16
TRACED_ITERATIONS = 8


class WindowClosed(Exception):
    """Raised from the iteration hook once the window's time is up."""


class Failure(Exception):
    """A run that prints no result: the message goes to standard error."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries and files, found by their names."""
    bench_path = root / "BENCHMARK.json"
    if not bench_path.is_file():
        raise Failure(f"no BENCHMARK.json in {root}")
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Failure(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "portbench"
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads(
        (here / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    mine = lambda m: workload in m.get("workloads", [workload])
    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)],
            "metrics_dir": here / "metrics"}


def solver_params(config: dict, **overrides):
    """The program's parameters of the configuration."""
    from sdpb_tpu_torch.solver.params import SolverParams

    s = config["solver"]
    kw = dict(
        precision=int(config["precision"]),
        word_dtype=WORD_FORMATS[config["word_format"]],
        initial_matrix_scale_primal=s["initial_matrix_scale"],
        initial_matrix_scale_dual=s["initial_matrix_scale"],
        feasible_centering_parameter=s["feasible_centering"],
        infeasible_centering_parameter=s["infeasible_centering"],
        step_length_reduction=float(s["step_length_reduction"]),
        primal_error_threshold=s["primal_error"],
        dual_error_threshold=s["dual_error"],
        duality_gap_threshold=s["duality_gap"])
    kw.update(overrides)
    return SolverParams(**kw)


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path in the checkout (the
    program's own nvcc builds already go to sdpb_tpu_torch/csrc/build)."""
    base = root / ".portbench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def _phase_seconds(timers, it: int) -> tuple:
    """(residues, step) seconds of the driver's synchronised spans of
    iteration ``it`` of a solve."""
    out = {}
    for name, start, stop in reversed(timers.named):
        for part in ("residues", "step"):
            if name == f"run.iter_{it}.{part}" and stop is not None \
                    and part not in out:
                out[part] = stop - start
        if len(out) == 2:
            break
    return out.get("residues", math.nan), out.get("step", math.nan)


def _host_state(state):
    from sdpb_tpu_torch.solver.data import BucketedState

    return BucketedState(
        x=[t.cpu() for t in state.x], y=state.y.cpu(),
        X=[tuple(p.cpu() for p in b) for b in state.X],
        Y=[tuple(p.cpu() for p in b) for b in state.Y])


def _read_metric(path: Path, run) -> float | None:
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def window(problem, params, seconds: float, device, traced: bool,
           max_iterations: int | None = None, restart: bool = True):
    """Drive solves from the cold start for ``seconds`` and the iteration
    in flight (or for ``max_iterations``, for the readings of
    ``control.py``), a solve that ends followed by the next where
    ``restart``; returns what it produced and measured.  ``traced``
    profiles the device, and records spans and kernel calls, over the
    TRACED_ITERATIONS iterations after the first TRACE_AFTER.  The
    benchmark's own work after each iteration (the copy of the iterate
    for the check, the profiler's start and stop) is left out of
    ``window_s``."""
    import torch

    from sdpb_tpu_torch.solver import driver
    from sdpb_tpu_torch.utils.timers import Timers

    from . import problem as pb
    from . import trace as tr

    records, states, ends, phase_s = [], [], [], []
    timers = None
    own_s = 0.0
    nonfinite = None
    cuda = device.type == "cuda"
    spans, calls, prof = tr.Spans(), tr.KernelCalls(), None
    start_ns = mark_ns = traced_ns = None
    wrappers = contextlib.ExitStack()

    def start_trace():
        nonlocal prof, start_ns, mark_ns
        from torch.profiler import ProfilerActivity, profile

        wrappers.enter_context(spans.around_program())
        wrappers.enter_context(calls.recording())
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                       else [ProfilerActivity.CPU])
        prof.start()
        if cuda:
            torch.cuda.synchronize()
            mark_ns = time.perf_counter_ns()
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
        start_ns = time.perf_counter_ns()

    def stop_trace():
        nonlocal traced_ns
        if cuda:
            torch.cuda.synchronize()
        traced_ns = (start_ns, time.perf_counter_ns())
        prof.stop()
        # the program's own functions back for the rest of the window
        wrappers.close()

    def hook(rec, st):
        nonlocal own_s
        ends.append(time.perf_counter())
        records.append(dict(dataclasses.asdict(rec),
                            first_of_solve=rec.iteration == 1))
        phase_s.append(_phase_seconds(timers, rec.iteration))
        states.append(_host_state(st))
        closing = (len(records) >= max_iterations if max_iterations
                   else ends[-1] - t_start >= seconds)
        if prof is not None and traced_ns is None and \
                len(records) == TRACE_AFTER + TRACED_ITERATIONS:
            stop_trace()
        elif traced and prof is None and len(records) == TRACE_AFTER \
                and not closing:
            start_trace()
        if closing:
            raise WindowClosed
        own_s += time.perf_counter() - ends[-1]

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with wrappers:
        if traced and TRACE_AFTER == 0:
            start_trace()
        t_start = time.perf_counter()
        try:
            while True:
                timers = Timers()
                n = len(records)
                driver.solve(problem, params,
                             state=pb.cold_state(problem, params),
                             iteration_hook=hook, timers=timers)
                if not restart or len(records) == n:
                    break
        except WindowClosed:
            pass
        except driver.NonFiniteIterateError as exc:
            nonfinite = str(exc)
        if prof is not None and traced_ns is None:
            stop_trace()
    out = types.SimpleNamespace(
        records=records, states=states, nonfinite=nonfinite,
        iterations=len(records),
        traced_iterations=min(max(0, len(records) - TRACE_AFTER),
                               TRACED_ITERATIONS) if prof else 0,
        untraced_phase_s=phase_s[:TRACE_AFTER] if traced else phase_s,
        window_s=(ends[-1] - t_start - own_s) if ends else math.nan,
        peak=torch.cuda.max_memory_allocated() if cuda else 0,
        spans=spans, calls=calls, trace=None)
    if prof is not None and cuda:
        t0 = time.perf_counter()
        dt = tr.DeviceTrace(prof, mark_ns)
        off = dt.offset if dt.offset is not None else (
            (dt.ops[0][1] - start_ns) if dt.ops else 0)
        out.trace = dt
        out.traced_ns = (traced_ns[0] + off, traced_ns[1] + off)
        out.offset = off
        print(f"trace: {len(dt.ops)} device operations read in "
              f"{time.perf_counter() - t0:.1f} s; clocks tied by "
              f"{'the marker' if dt.offset is not None else 'the first op'}",
              file=sys.stderr, flush=True)
    return out


def _breakdown(win) -> dict:
    dt = win.trace
    t0, t1 = win.traced_ns
    idle = {}
    gaps = dt.gaps(t0, t1)
    labels = win.spans.labels_at([(g0 + g1) // 2 - win.offset
                                  for g0, g1 in gaps])
    for (g0, g1), label in zip(gaps, labels):
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in dt.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in top_idle]}


def run(argv=None, device=None, root: Path = ROOT) -> int:
    """One run.  ``device`` None looks for the cards the cell asks for
    (and fails without them); tests pass "cpu" to skip that look, and a
    ``root`` of their own to add cells as files."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(root, args.workload)
        _cache_dirs(root)
        if str(root) not in sys.path:
            sys.path.insert(0, str(root))
        try:
            import torch
        except ImportError as exc:
            raise Failure(f"no torch: {exc}")
        chips = int(cell["cell"]["chips"])
        if device is None:
            if not torch.cuda.is_available():
                raise Failure("torch.cuda.is_available() is false")
            if torch.cuda.device_count() < chips:
                raise Failure(f"{torch.cuda.device_count()} CUDA devices, "
                              f"the cell asks for {chips}")
            device = torch.device("cuda", 0)
        else:
            device = torch.device(device)
        try:
            import sdpb_tpu_torch  # noqa: F401
        except ImportError as exc:
            raise Failure(f"the program sdpb_tpu_torch is not in the "
                          f"checkout: {exc}")
        return _run_cell(args, cell, device)
    except Failure as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2


def _run_cell(args, cell, device) -> int:
    import torch

    from sdpb_tpu_torch.solver import driver

    from . import check
    from . import problem as pb

    config, traffic = cell["config"], cell["traffic"]
    params = solver_params(config)
    marks = [("imports", time.perf_counter())]
    data = pb.generate(args.seed, [tuple(b) for b in config["blocks"]],
                       int(config["n_dual"]))
    marks.append(("generate", time.perf_counter()))
    problem, state = pb.to_program(data, params, device)
    marks.append(("to_program", time.perf_counter()))
    # warm-up: one iteration, which builds and loads every kernel
    driver.solve(problem, solver_params(config, max_iterations=1),
                 state=state)
    del state
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm_up", time.perf_counter()))
    setup_s = time.perf_counter() - T0
    steps = [(name, t - t0) for (name, t), (_, t0)
             in zip(marks, [("start", T0)] + marks)]
    print("setup seconds: " + ", ".join(f"{name} {dt:.3f}"
                                        for name, dt in steps),
          file=sys.stderr, flush=True)
    win = window(problem, params, args.seconds, device, bool(args.trace),
                 restart=bool(traffic.get("restart", False)))
    print(f"solves begun: {sum(r['first_of_solve'] for r in win.records)}",
          file=sys.stderr, flush=True)
    print("iteration seconds: " + ", ".join(
        f"{r['iter_time']:.3f}" for r in win.records), file=sys.stderr,
        flush=True)
    if win.nonfinite:
        print(f"portbench: the program stopped: {win.nonfinite}",
              file=sys.stderr, flush=True)
    failed = 0 if win.iterations and not win.nonfinite else 1
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(win.peak)}
    metrics, breakdown = {}, None
    if args.trace:
        dt = win.trace
        if dt is not None:
            t0, t1 = win.traced_ns
            dev["busy_s"] = dt.busy_ns() / 1e9
            dev["window_s"] = (t1 - t0) / 1e9
            breakdown = _breakdown(win)
        runinfo = types.SimpleNamespace(
            iterations=win.iterations,
            traced_iterations=win.traced_iterations,
            phase_s=win.untraced_phase_s, trace=dt, calls=win.calls,
            busy_s=dev.get("busy_s"), traced_s=dev.get("window_s"))
        for m in cell["per_layer"]:
            v = _read_metric(cell["metrics_dir"] / f"{m['name']}.py", runinfo)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"iter_s": win.window_s / max(1, win.iterations),
                  "peak_mem_gib": win.peak / 2 ** 30, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    power = _power_limit() if device.type == "cuda" else ""
    if power:
        dev["power_limit"] = power
    records, states = win.records, win.states
    del win, problem
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = check.judge(data, config, states, records, device) \
        if records else dict.fromkeys(check.NAMES, check.WORST)
    limits = cell["limits"]
    correct = not failed and check.verdict(readings, limits)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(leaked)}", file=sys.stderr, flush=True)
        return 3
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: {"value": readings[n], "limit": limits[n]}
                       for n in check.NAMES}
    for n in check.NAMES:
        print(f"check {n} {readings[n]!r} limit {limits[n]!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        sys.path.insert(0, str(ROOT))
        __package__ = "portbench"
        import portbench  # noqa: F401
    sys.exit(run())
