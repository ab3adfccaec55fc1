"""Smoke test of the PyTorch/CUDA port (sdpb_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its name and elapsed seconds:
  1. environment: card name and power limit, torch/CUDA versions, mpmath
  2. build: the limb kernels of every slot class (128, 256 and 512
     slots) with nvcc, one process per object, all started together
     (registers, stack frame and spills per kernel instantiation; a
     spill fails the phase)
  3. kernels against their plain PyTorch versions, bit for bit: the
     factorization kernels at the full-width shapes (S = 47, 400 bits)
     and at S = 26 (--precision 212), S = 116 (--precision 1024),
     n = 64 and n = 7, and at S = 130, 230 and 458 (--precision 1152,
     2048 and 4096); the elementwise kernels at the same S, one value
     at a time, and with one operand broadcast over the batch;
     CUDA-event times of back-to-back calls, and for the elementwise
     kernels, whose calls are bound by the host, also the device time
     of a CUDA graph of the calls
  4. the 1d quickstart SDP end to end through the sdpb CLI entry point
     at the stock contract (--precision 212): PrimalDualOptimal and the
     known objective
  5. the full-width synthetic problem (bench.py's build_problem: 48+16
     blocks, Schur 96/240, N = 384, 400 bits) for 1 solver iteration,
     its peak memory beside the memory estimate, and one more iteration
     under torch.profiler
  6. the front end and the CLI as a user runs them, each a process of
     its own: the quickstart PMP written with the port's pmp_writer and
     compiled by the port's pmp2sdp (byte for byte the committed SDP),
     then solved by the port's sdpb with checkpoints on: SIGTERM after
     20 iterations (exit 143 and a checkpoint), the same command again
     (restart, PrimalDualOptimal, block_timings, a final checkpoint);
     then 5 iterations at --precision 2048 (S = 230)
  7. above 512 rows: the synthetic problem with N = 1024 for 1
     iteration (the Q Cholesky on 32 panels), its time, the Q
     Cholesky's time, peak memory against the memory estimate (no more
     than 10% below the peak, here and in phase 5)

The line before the last is one JSON object with a record per kernel
(``ms``: CUDA events around back-to-back calls; ``device_ms``: the CUDA
graph's time, elementwise kernels only, else null);
the last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0 = time.time()
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_PER_S = 67e12         # H100 SXM float32, outside tensor cores
REPO = Path(__file__).resolve().parent


def phase(name: str, t_start: float) -> None:
    print(f"[phase] {name}: {time.time() - t_start:.1f} s "
          f"(total {time.time() - T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    the graph replayed and timed with CUDA events.  For short kernels
    whose back-to-back calls are bound by the host (the wrapper takes
    tens of microseconds), where cuda_ms times the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


def spd_limbs(rng, bb, n, S, dev, scale=1.0):
    import torch

    from sdpb_tpu_torch.mp import limb

    g = rng.standard_normal((bb, n, n))
    a = (g @ g.transpose(0, 2, 1) + n * np.eye(n)) * scale
    return torch.from_numpy(limb.from_words_np(a[..., None], S)).to(dev)


def abs_rel_err(got, want):
    """(max |got - want|, that over max |want|), from a limb subtraction
    (exact up to the last limb) read back through its float32 estimate;
    entries NaN in both are skipped."""
    from sdpb_tpu_torch.mp import limb

    both = ~(got.isnan().any(-1) & want.isnan().any(-1))
    diff = limb.fst(limb.sub(got, want)).abs()
    scale = limb.fst(want).abs().amax().item()
    err = diff[both].amax().item() if both.any() else 0.0
    return err, err / scale


def phase_env() -> str:
    t = time.time()
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    import mpmath

    print(f"mpmath {mpmath.__version__} imports", flush=True)
    phase("1 environment", t)
    return card


def phase_build():
    """Every slot class's library, all units of all classes compiled at
    once; registers, stack and spills per factorization kernel, and a
    failure if one of them spills."""
    t = time.time()
    from sdpb_tpu_torch.ops import limb_kernels as lk

    infos = lk.build(force=True)
    spills = []
    for cap, info in infos.items():
        print(f"class {cap}: nvcc build {info['seconds']:.1f} s -> "
              f"{Path(info['library']).name}", flush=True)
        for name, res in _ptxas_resources(info["ptxas"]).items():
            print(f"  {name}: {json.dumps(res)}", flush=True)
            if res.get("spill_stores", 0) or res.get("spill_loads", 0):
                spills.append((cap, name, res))
        lk._lib(cap)
    if spills:
        raise AssertionError(f"kernels spill: {spills}")
    phase("2 build", t)


def _ptxas_resources(lines):
    """Registers, stack frame and spill bytes per kernel instantiation
    (template arguments R, W and, for the elementwise kernel, the op),
    read from the -Xptxas -v lines."""
    out, cur = {}, None
    for line in lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"(chol_warp|solve_warp|elementwise_warp)_kernel"
                          r"I((?:Li\d+E)+)E", m.group(1))
            cur = (f"{k.group(1)}_kernel<"
                   + ",".join(re.findall(r"Li(\d+)E", k.group(2))) + ">"
                   if k else None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def _mul_flops(L):
    """Float operations of one truncated limb product: the
    L(L+1)/2 + 2L - 3 multiply-adds of its convolution up to L + 2
    output slots (csrc/limb.cuh mul), two operations each.  Carry passes
    are not counted, so every bound below is a little low."""
    return 2 * (L * (L + 1) // 2 + 2 * L - 3)


def _chol_ops(bb, n, L, steps):
    """Float operations a right-looking limb Cholesky needs: per column
    j, with r = n - j - 1 rows below the pivot, the pivot's sqrt/rsqrt
    (3 products per Newton step + 3 for the sqrt), r column products,
    and the lower triangle of the trailing update, r(r+1)/2 products
    and as many limb additions (L float additions each)."""
    ops = 0
    for j in range(n):
        r = n - j - 1
        tri = r * (r + 1) // 2
        ops += (3 * steps + 3 + r + tri) * _mul_flops(L) + tri * L
    return bb * ops


def _solve_ops(bb, n, m, L):
    """Float operations of X = L^-1 B by substitution: n m products by
    the diagonal reciprocals, n(n-1)/2 m update products and additions."""
    upd = n * (n - 1) // 2 * m
    return bb * ((n * m + upd) * _mul_flops(L) + upd * L)


def same_bits(got, want):
    """Equal limbs, with NaN in the same places."""
    import torch

    return bool(torch.equal(got.nan_to_num(0.0, 1.0, -1.0),
                            want.nan_to_num(0.0, 1.0, -1.0))
                and torch.equal(got.isnan(), want.isnan()))


# Phase 3 shapes: (batch, n, S) for the Cholesky and (batch, n, m, S)
# for the solve.  The first three of each are the full-width problem's
# (S = 47); the rest cover S = 26 (--precision 212), S = 116
# (--precision 1024), n = 64 (the largest unblocked n), an odd n, and
# the higher slot classes: S = 130, 230 and 458 (--precision 1152, 2048
# and 4096).
HIGH_SLOTS = (130, 230, 458)
CHOL_SHAPES = ((48, 32, 47), (16, 48, 47), (1, 32, 47), (4, 32, 26),
               (2, 32, 116), (2, 64, 47), (1, 64, 116), (8, 7, 47)) + tuple(
    shape for S in HIGH_SLOTS for shape in ((2, 32, S), (1, 64, S)))
SOLVE_SHAPES = ((272, 32, 32, 47), (48, 32, 96, 47), (1, 32, 384, 47),
                (4, 32, 16, 26), (2, 32, 24, 116), (2, 64, 40, 47),
                (1, 64, 8, 116), (5, 7, 9, 47)) + tuple(
    (2, 32, 24, S) for S in HIGH_SLOTS)
FULL_WIDTH = 3
# Elementwise (values, S): one full-width trailing update (48 x 32 x 32
# values at S = 47, the first shape, the one on the main path), then
# 4096 values at the other S.
ELEMENTWISE_SHAPES = ((48 * 32 * 32, 47), (4096, 26), (4096, 116)) + tuple(
    (4096, S) for S in HIGH_SLOTS)


def bound_ms(nbytes, ops):
    """(least time in ms, what bounds it): the bytes moved over the
    memory rate or the float operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_once(fn):
    """(result, ms) of one call, timed with CUDA events: for the plain
    versions, whose single call is long and whose result is the
    reference."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def phase_kernels(dev):
    """Each kernel against its plain version, bit for bit."""
    t = time.time()
    import torch

    from sdpb_tpu_torch.mp import limb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    rng = np.random.default_rng(0)
    rows = {}
    for idx, (bb, n, S) in enumerate(CHOL_SHAPES):
        L = S - 1
        a = spd_limbs(rng, bb, n, S, dev, scale=1e20)
        got = lk.cholesky_unblocked_batched(a)
        want, plain_ms = timed_once(lambda: lk.cholesky_unblocked_plain(a))
        if not same_bits(got, want):
            raise AssertionError(f"cholesky ({bb},{n},{n},{S}) differs from "
                                 f"its plain version (abs, rel err "
                                 f"{abs_rel_err(got, want)})")
        ms = cuda_ms(lambda: lk.cholesky_unblocked_batched(a), 5)
        nbytes, ops = 2 * a.numel() * 4, _chol_ops(bb, n, L,
                                                   limb.newton_steps(L))
        print(f"cholesky ({bb},{n},{n},{S}): bit-exact  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  bound %.5f ms (%s)"
              % bound_ms(nbytes, ops), flush=True)
        rows.setdefault("cholesky_unblocked_batched", []).append(
            dict(shape=[bb, n, n, S], err=0.0, ms=ms, plain_ms=plain_ms,
                 bytes=nbytes, main=idx < FULL_WIDTH, ops=ops))
    for S in (47, 116, 458):
        bad = spd_limbs(rng, 2, 32, S, dev)
        bad[1] = -bad[1]
        poisoned = lk.cholesky_unblocked_batched(bad)
        torch.cuda.synchronize()
        if not (poisoned[1].isnan().any() and
                torch.isfinite(poisoned[0]).all() and
                same_bits(poisoned, lk.cholesky_unblocked_plain(bad))):
            raise AssertionError(f"non-PD Cholesky (S={S}) did not poison "
                                 f"to NaN as its plain version does")
    print("cholesky non-PD input poisons to NaN as the plain version does",
          flush=True)

    for idx, (bb, n, m, S) in enumerate(SOLVE_SHAPES):
        L = S - 1
        lfac = lk.cholesky_unblocked_batched(spd_limbs(rng, bb, n, S, dev))
        diag = torch.arange(n, device=dev)
        inv_d = limb.recip(lfac[:, diag, diag, :]).contiguous()
        g = rng.standard_normal((bb, n, m))
        b = torch.from_numpy(limb.from_words_np(g[..., None], S)).to(dev)
        geo = lk.solve_geometry(bb, n, m, S)
        for transpose in (False, True):
            got = lk.solve_unblocked_batched(lfac, b, inv_d, transpose)
            want, plain_ms = timed_once(lambda: lk.solve_unblocked_plain(
                lfac, b, inv_d, transpose))
            if not same_bits(got, want):
                raise AssertionError(
                    f"solve ({bb},{n},{m},{S}) transpose={transpose} "
                    f"differs from its plain version (abs, rel err "
                    f"{abs_rel_err(got, want)})")
            ms = cuda_ms(lambda: lk.solve_unblocked_batched(
                lfac, b, inv_d, transpose), 5)
            nbytes = (lfac.numel() + 2 * b.numel() + inv_d.numel()) * 4
            ops = _solve_ops(bb, n, m, L)
            print(f"solve ({bb},{n},{n})x{m} S={S} T={int(transpose)}: "
                  f"bit-exact  tile {geo['tm']} blocks {geo['blocks']}  "
                  f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
                  f"%.5f ms (%s)" % bound_ms(nbytes, ops), flush=True)
            rows.setdefault("solve_unblocked_batched", []).append(
                dict(shape=[bb, n, m, S, int(transpose)], err=0.0, ms=ms,
                     plain_ms=plain_ms, main=idx < FULL_WIDTH,
                     bytes=nbytes, ops=ops))
    for n, S in ELEMENTWISE_SHAPES:
        for name, recs in _elementwise_checks(dev, rng, S, n).items():
            rows.setdefault(name, []).extend(recs)
    phase("3 kernels vs plain", t)
    return rows


def _random_limbs(rng, n, S, dev):
    """n random limb values over exponents 2^-200..2^200 with zeros,
    NaN, +-inf, and a few near the exponent range's ends."""
    import torch

    from sdpb_tpu_torch.mp import limb

    e = rng.integers(-200, 200, size=n)
    words = np.stack([rng.standard_normal(n) * 2.0 ** e,
                      rng.standard_normal(n) * 2.0 ** (e - 53),
                      rng.standard_normal(n) * 2.0 ** (e - 106)], axis=-1)
    words[rng.random(n) < 0.05] = 0.0
    x = limb.from_words_np(words, S)
    x[1] = np.nan
    x[2] = limb.from_words_np(np.array([[np.inf, 0, 0]]), S)[0]
    x[3] = limb.one(S)
    x[3, 0] = 2 * limb.EOFF - 2
    x[4] = limb.one(S)
    x[4, 0] = 1
    return torch.from_numpy(x).to(dev)


def _check_same(name, got, want):
    if not same_bits(got, want):
        bad = (got.nan_to_num(0.0) != want.nan_to_num(0.0)).any(-1) | (
            got.isnan() != want.isnan()).any(-1)
        i = int(bad.reshape(-1).nonzero()[0, 0])
        got, want = got.reshape(-1, got.shape[-1]), want.reshape(
            -1, want.shape[-1])
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{i}: {got[i].tolist()} vs {want[i].tolist()}")


def _elementwise_checks(dev, rng, S, n):
    """limb_add/mul/div against their plain versions, bit for bit, on n
    random values with special ones among them: b value by value, b's
    first value broadcast over the batch (read in place, batch stride
    0), and the first 9 values one launch each (n = 1)."""
    from sdpb_tpu_torch.mp import limb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    L = S - 1
    a = _random_limbs(rng, n, S, dev)
    b = _random_limbs(rng, n, S, dev)
    b1 = b[:1]
    # float additions / the convolution's multiply-adds / the L + 2
    # quotient digits' multiply-subtracts; carry passes not counted
    per_op = {"limb_add": L, "limb_mul": _mul_flops(L),
              "limb_div": (L + 2) * 2 * L}
    rows = {}
    for name, kern, plain in (("limb_add", lk.limb_add, limb.add_plain),
                              ("limb_mul", lk.limb_mul, limb.mul_plain),
                              ("limb_div", lk.limb_div, limb.div_plain)):
        for i in range(9):
            _check_same(f"{name} (1,{S}) value {i}",
                        kern(a[i:i + 1], b[i:i + 1]),
                        plain(a[i:i + 1], b[i:i + 1]))
        for label, y, nb in (("", b, n), (" b broadcast", b1, 1)):
            got = kern(a, y)
            want, plain_ms = timed_once(lambda: plain(a, y))
            _check_same(f"{name} ({n},{S}){label}", got, want)
            ms = cuda_ms(lambda: kern(a, y), 5)
            dev_ms = device_ms(lambda: kern(a, y), 5)
            nbytes, ops = (2 * n + nb) * S * 4, n * per_op[name]
            print(f"{name} ({n},{S}){label}: bit-exact  kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms)  plain {plain_ms:.3f} "
                  f"ms  bound %.5f ms (%s)" % bound_ms(nbytes, ops),
                  flush=True)
            rows.setdefault(name, []).append(dict(
                shape=[n, S], err=0.0, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops,
                main=(n, S) == ELEMENTWISE_SHAPES[0] and nb == n))
        call1 = cuda_ms(lambda: kern(a[:1], b1), 20)
        dev1 = device_ms(lambda: kern(a[:1], b1), 5)
        print(f"{name} (1,{S}): bit-exact on values 0..8  kernel {call1:.4f} "
              f"ms (device {dev1:.4f} ms)  bound %.6f ms (%s)"
              % bound_ms(3 * S * 4, per_op[name]), flush=True)
    return rows


def phase_1d(dev, out_root: Path):
    t = time.time()
    from sdpb_tpu_torch.apps import sdpb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    sdp = REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
    out = out_root / "quickstart_out"
    ck = out_root / "quickstart_ck"
    shutil.rmtree(ck, ignore_errors=True)
    lk.reset_launches()
    rc = sdpb.main(["-s", str(sdp), "-o", str(out), "-c", str(ck),
                    "--precision", "212", "--noFinalCheckpoint",
                    "--verbosity", "0"])
    launches = dict(lk.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"sdpb exited {rc}")
    fields, dev_obj = _check_1d_out(out)
    print(f"1d: {fields['terminateReason']} primalObjective "
          f"{fields['primalObjective'][:40]} |diff| {dev_obj:.3e} "
          f"launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"1d did not launch every kernel: {launches}")
    _check_1d_trajectory(out / "iterations.json")
    phase("4 1d end to end", t)
    return launches


def _check_1d_out(out: Path):
    """out.txt's fields and |primalObjective - 1.8402657631320492|;
    fails unless PrimalDualOptimal within 1e-15."""
    import mpmath

    fields = {}
    for line in (out / "out.txt").read_text().splitlines():
        key, _, val = line.partition("=")
        fields[key.strip()] = val.strip().rstrip(";")
    mpmath.mp.prec = 256
    obj = mpmath.mpf(fields["primalObjective"])
    dev_obj = abs(obj - mpmath.mpf("1.8402657631320492"))
    if fields["terminateReason"] != '"found primal-dual optimal solution"':
        raise AssertionError(f"1d ended {fields['terminateReason']}")
    if not dev_obj <= mpmath.mpf("1e-15"):
        raise AssertionError(f"1d primalObjective off by {dev_obj}")
    return fields, float(dev_obj)


def _check_1d_trajectory(path: Path):
    """The card's 1d trajectory against sdpb_tpu's, recorded on the CPU
    by tests/make_torch_reference_trajectories.py: the same number of
    iterations; mu and the gap to 1e-5 relative, the objectives to 1e-8
    (the port's and sdpb_tpu's CPU runs differ by up to 5.4e-7 and
    3.7e-10 over the 160 iterations: float64 vs float32 eigh in the
    step length); step lengths to 1e-5."""
    import mpmath

    ref = json.loads((REPO / "sdpb_tpu_torch" / "data" /
                      "reference_trajectories.json").read_text())
    want = ref["quickstart_1d"]["iterations"]
    got = json.loads(path.read_text())
    if len(got) != len(want):
        raise AssertionError(f"1d took {len(got)} iterations, "
                             f"sdpb_tpu {len(want)}")
    worst = {}
    for g, w in zip(got, want):
        for key, field, tol in (("mu", "mu", 1e-5), ("gap", "duality_gap",
                                                     1e-5),
                                ("P-obj", "primal_objective", 1e-8),
                                ("D-obj", "dual_objective", 1e-8)):
            a, b = mpmath.mpf(g[key]), mpmath.mpf(w[field])
            rel = float(abs(a - b) / max(abs(a), abs(b), mpmath.mpf(1e-300)))
            worst[key] = max(worst.get(key, 0.0), rel)
            if rel > tol:
                raise AssertionError(f"1d iteration {g['iteration']} {key} "
                                     f"{g[key]} vs {w[field]}")
        for key, field in (("P-step", "primal_step"), ("D-step",
                                                       "dual_step")):
            d = abs(float(g[key]) - float(w[field]))
            worst[key] = max(worst.get(key, 0.0), d)
            if d > 1e-5:
                raise AssertionError(f"1d iteration {g['iteration']} {key}")
    print(f"1d trajectory vs sdpb_tpu ({len(got)} iterations), worst "
          f"differences: " + json.dumps(worst), flush=True)


def phase_full(dev, iterations=1):
    t = time.time()
    import torch

    from sdpb_tpu_torch.ops import limb_kernels as lk
    from sdpb_tpu_torch.solver import driver, memory, synthetic
    from sdpb_tpu_torch.solver.params import SolverParams
    from sdpb_tpu_torch.utils.timers import Timers

    params = SolverParams(precision=400, max_iterations=iterations)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    problem, state = synthetic.build_problem(params, device=dev)
    estimate = memory.estimate_solver_memory(problem).total
    timers = Timers()
    lk.reset_launches()
    t_solve = time.time()
    result = driver.solve(problem, params, state=state, timers=timers)
    torch.cuda.synchronize()
    seconds = time.time() - t_solve
    launches = dict(lk.LAUNCHES)
    for rec in result.iterations:
        for val in (rec.primal_error_P, rec.dual_error, rec.mu):
            if not math.isfinite(float(val)):
                raise AssertionError(f"non-finite residue {val}")
    n_it = len(result.iterations)
    print(f"full width: {n_it} iterations in {seconds:.2f} s "
          f"({seconds / max(1, n_it):.2f} s/iteration) reason "
          f"{result.reason.name}", flush=True)
    split = {}
    for name, start, stop in timers.named:
        leaf = name.rsplit(".", 1)[-1]
        if stop is not None and name.count(".") >= 2:
            split[leaf] = split.get(leaf, 0.0) + (stop - start)
    print("full width phase split (s): " + json.dumps(
        {k: round(v, 3) for k, v in split.items()}), flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"full width max_memory_allocated {peak / 2**30:.3f} GiB "
          f"estimate {estimate / 2**30:.3f} GiB launches {launches}",
          flush=True)
    if n_it < iterations:
        raise AssertionError(f"full width ran {n_it} iterations")
    if min(launches.values()) <= 0:
        raise AssertionError(f"full width missed a kernel: {launches}")
    _profile_iteration(problem, state, seconds / n_it)
    phase("5 full width", t)
    return launches, {"N": problem.dual_dim, "peak": peak,
                      "estimate": estimate}


# Device kernels by what launched them: the port's own CUDA kernels, the
# integer elementwise glue (CRT digits and residues, limb exponents),
# library matrix products, and the rest (float glue, copies).
LIMB_KERNELS = (
    ("cholesky_unblocked_batched", r"\(anonymous namespace\)::chol_warp_kernel<"),
    ("solve_unblocked_batched", r"\(anonymous namespace\)::solve_warp_kernel<"),
    ("limb_elementwise",
     r"\(anonymous namespace\)::elementwise_warp_kernel<"),
)
PROFILE_CLASSES = (
    ("limb_kernels", "|".join(pat for _, pat in LIMB_KERNELS)),
    ("matmul", r"gemm|xmma|cutlass"),
    ("integer_glue", r"<(int|long)\b|\b(int|long)>|\((int|long)\)#"),
)


def _profile_iteration(problem, state, s_per_it):
    """One more full-width iteration under torch.profiler: device time
    per CUDA kernel name, summed, and that total over the unprofiled
    seconds per iteration (the device's busy share; kernels run on one
    stream, so they do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdpb_tpu_torch.solver import driver
    from sdpb_tpu_torch.solver.params import SolverParams

    params = SolverParams(precision=400, max_iterations=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver.solve(problem, params, state=state)
        torch.cuda.synchronize()
    device_ms, calls = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total if hasattr(
            ev, "self_device_time_total") else ev.self_cuda_time_total
        device_ms[ev.key] = us / 1e3
        calls[ev.key] = ev.count
    total = sum(device_ms.values())
    classes = {}
    for key, ms in device_ms.items():
        cls = next((c for c, pat in PROFILE_CLASSES if re.search(pat, key)),
                   "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    kernels = {}
    for name, pat in LIMB_KERNELS:
        keys = [k for k in device_ms if re.search(pat, k)]
        kernels[name] = {"device_ms": sum(device_ms[k] for k in keys),
                         "launches": sum(calls[k] for k in keys)}
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    print("full width profiled iteration: " + json.dumps({
        "device_ms_total": total,
        "busy_share": total / 1e3 / s_per_it if total else "not measured",
        "device_ms_by_class": classes,
        "limb_kernels": kernels,
        "top_device_ms": {k[:120]: v for k, v in top}}), flush=True)


def _port_env():
    """The environment of the port's CLI processes: the checkout on the
    module path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(cmd, cwd, timeout=600):
    proc = subprocess.run(cmd, cwd=cwd, env=_port_env(), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc


def _records(path: Path) -> list:
    return json.loads(path.read_text()) if path.exists() else []


def phase_frontend(dev, out_root: Path):
    """The user's workflow in the port, each tool a process of its own:
    pmp_writer -> pmp2sdp -> sdpb with checkpoints, a SIGTERM drain and
    a restart; then 5 iterations at --precision 2048 in process (their
    kernel launches counted)."""
    t = time.time()
    import torch

    from sdpb_tpu_torch.apps import sdpb
    from sdpb_tpu_torch.io import pmp_writer
    from sdpb_tpu_torch.mp import limb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    work = out_root / "frontend"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # examples/quickstart.py:33-44
    pmp_writer.write_pmp_json(
        work / "pmp.json", objective=[0, -1], normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "1/12"]]]])])
    py = sys.executable
    _run([py, "-m", "sdpb_tpu_torch.apps.pmp2sdp", "-p", "768", "-i",
          "pmp.json", "-o", "quickstart_1d_sdp"], work)
    want = REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
    got = work / "quickstart_1d_sdp"
    names = sorted(p.name for p in want.iterdir())
    if sorted(p.name for p in got.iterdir()) != names or any(
            (got / n).read_bytes() != (want / n).read_bytes() for n in names):
        raise AssertionError("pmp2sdp's SDP differs from the committed "
                             "quickstart_1d_sdp")
    print(f"pmp2sdp: {len(names)} files equal byte for byte to the "
          f"committed quickstart_1d_sdp", flush=True)

    cmd = [py, "-m", "sdpb_tpu_torch.apps.sdpb", "-s", "quickstart_1d_sdp",
           "-o", "out", "-c", "ck", "--precision", "212",
           "--checkpointInterval", "1"]
    iters = work / "out" / "iterations.json"
    proc = subprocess.Popen(cmd, cwd=work, env=_port_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.time() + 600
        while (not iters.exists()
               or len(iters.read_text().splitlines()) < 20):
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError("sdpb ended or stalled before 20 lines "
                                     f"of iterations.json: {proc.poll()}")
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 143:
        raise AssertionError(f"SIGTERM: sdpb exited {proc.returncode}, not "
                             f"143\n{stdout[-2000:]}\n{stderr[-2000:]}")
    meta = json.loads((work / "ck" / "checkpoint.json").read_text())
    drained = _records(iters)
    print(f"SIGTERM after {len(drained)} iterations: exit 143, checkpoint "
          f"generation {meta['current']} in ck/", flush=True)
    _run(cmd, work)
    fields, dev_obj = _check_1d_out(work / "out")
    restarted = _records(iters)
    meta2 = json.loads((work / "ck" / "checkpoint.json").read_text())
    if not (work / "ck" / "block_timings").exists():
        raise AssertionError("the restarted solve wrote no ck/block_timings")
    if meta2["current"] <= meta["current"]:
        raise AssertionError("the restarted solve wrote no final checkpoint")
    print(f"restart: {len(restarted)} more iterations "
          f"({len(drained) + len(restarted)} in all), "
          f"{fields['terminateReason']}, primalObjective "
          f"{fields['primalObjective'][:40]} |diff| {dev_obj:.3e}; "
          f"block_timings and final checkpoint generation "
          f"{meta2['current']} written", flush=True)

    prec = 2048
    S = limb.slots_for_precision(prec)
    lk.reset_launches()
    rc = sdpb.main(["-s", str(got), "-o", str(work / "out_2048"), "-c",
                    str(work / "ck_2048"), "--precision", str(prec),
                    "--maxIterations", "5", "--verbosity", "0"])
    torch.cuda.synchronize()
    launches = dict(lk.LAUNCHES)
    recs = _records(work / "out_2048" / "iterations.json")
    if rc != 0 or len(recs) != 5:
        raise AssertionError(f"--precision {prec}: exit {rc}, "
                             f"{len(recs)} iterations")
    import mpmath

    for rec in recs:
        for key in ("mu", "P-err", "p-err", "D-err", "gap"):
            if not mpmath.isfinite(mpmath.mpf(rec[key])):
                raise AssertionError(f"--precision {prec} iteration "
                                     f"{rec['iteration']}: {key} {rec[key]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"--precision {prec} (S = {S}) missed a "
                             f"kernel: {launches}")
    print(f"--precision {prec} (S = {S}, class "
          f"{lk.slot_class(S)[1]}): 5 iterations, finite residues, mu "
          f"{recs[-1]['mu'][:12]}, launches {launches}", flush=True)
    phase("6 front end and CLI", t)
    return launches


def phase_large(dev, n_dual=1024):
    """One iteration with N = 1024: the Q Cholesky above 512 rows, on 32
    panels of the kernels; its time, and peak memory against the
    estimate."""
    t = time.time()
    import torch

    from sdpb_tpu_torch.mp import linalg as la
    from sdpb_tpu_torch.ops import limb_kernels as lk
    from sdpb_tpu_torch.solver import driver, memory, synthetic
    from sdpb_tpu_torch.solver.params import SolverParams

    params = SolverParams(precision=400, max_iterations=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    problem, state = synthetic.build_problem(params, device=dev,
                                             n_dual=n_dual)
    estimate = memory.estimate_solver_memory(problem)
    q_chol = {}
    cholesky = la.cholesky

    def timed_cholesky(a):
        """The Q Cholesky timed and its launches counted (the other
        Cholesky calls pass through)."""
        if a.shape[-3] != n_dual:
            return cholesky(a)
        torch.cuda.synchronize()
        before = dict(lk.LAUNCHES)
        t0 = time.time()
        out = cholesky(a)
        torch.cuda.synchronize()
        q_chol["seconds"] = time.time() - t0
        q_chol["launches"] = {k: lk.LAUNCHES[k] - before[k]
                              for k in before}
        return out

    lk.reset_launches()
    la.cholesky = timed_cholesky
    try:
        t0 = time.time()
        result = driver.solve(problem, params, state=state)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        la.cholesky = cholesky
    launches = dict(lk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for rec in result.iterations:
        for val in (rec.primal_error_P, rec.dual_error, rec.mu):
            if not math.isfinite(float(val)):
                raise AssertionError(f"N = {n_dual}: non-finite residue "
                                     f"{val}")
    if len(result.iterations) != 1:
        raise AssertionError(f"N = {n_dual} ran {len(result.iterations)} "
                             "iterations")
    panels = -(-n_dual // 32)
    ql = q_chol.get("launches", {})
    if (ql.get("cholesky_unblocked_batched") != panels
            or ql.get("solve_unblocked_batched") != panels - 1):
        raise AssertionError(f"the Q Cholesky did not run the kernels on "
                             f"{panels} panels: {ql}")
    print(f"N = {n_dual}: 1 iteration in {seconds:.2f} s/iteration; Q "
          f"Cholesky {q_chol['seconds']:.3f} s ({panels} panels, launches "
          f"{ql}); max_memory_allocated {peak / 2**30:.3f} GiB, estimate "
          f"{estimate.total / 2**30:.3f} GiB", flush=True)
    print(estimate.message(), flush=True)
    phase("7 above 512 rows", t)
    return launches, {"N": n_dual, "peak": peak, "estimate": estimate.total}


def check_memory_estimates(cells):
    """A fail-fast check that predicts too little guards nothing."""
    for cell in cells:
        ratio = cell["estimate"] / cell["peak"]
        print(f"memory N = {cell['N']}: estimate / measured peak = "
              f"{ratio:.3f}", flush=True)
        if ratio < 0.9:
            raise AssertionError(f"N = {cell['N']}: the memory estimate "
                                 f"is {1 - ratio:.1%} below the peak")


def kernel_json(rows, paths):
    """One record per kernel: its largest full-width shape's times and
    bound, ``launches`` from the full-width iteration (phase 5), and
    each path's launches beside them."""
    launches = paths["full_width"]
    meta = {
        "cholesky_unblocked_batched": "sdpb_tpu/ops/limb_kernels.py:251",
        "solve_unblocked_batched": "sdpb_tpu/ops/limb_kernels.py:180",
        "limb_add": "sdpb_tpu/mp/limb.py:499",
        "limb_mul": "sdpb_tpu/mp/limb.py:532",
        "limb_div": "sdpb_tpu/mp/limb.py:670",
    }
    sources = {"cholesky_unblocked_batched": "sdpb_tpu_torch/csrc/limb_chol.cu",
               "solve_unblocked_batched": "sdpb_tpu_torch/csrc/limb_solve.cu",
               "limb_add": "sdpb_tpu_torch/csrc/limb_elementwise.cu",
               "limb_mul": "sdpb_tpu_torch/csrc/limb_elementwise.cu",
               "limb_div": "sdpb_tpu_torch/csrc/limb_elementwise.cu"}
    out = []
    for name, recs in rows.items():
        rec = max((r for r in recs if r["main"]), key=lambda r: r["ops"])
        bound, bound_by = bound_ms(rec["bytes"], rec["ops"])
        out.append({
            "name": name, "route": "cuda",
            "source": sources[name],
            "replaces": meta[name], "launches": launches.get(name, 0),
            "max_abs_err": max(r["err"] for r in recs),
            "ms": rec["ms"], "device_ms": rec.get("device_ms"),
            "plain_ms": rec["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "shape": rec["shape"],
            "launches_by_path": {p: n.get(name, 0)
                                 for p, n in paths.items()}})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the 1d solve's output "
                         "(default: smoke_out/ in the repository)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out_root = Path(args.out) if args.out else REPO / "smoke_out"
    out_root.mkdir(parents=True, exist_ok=True)
    card = phase_env()
    phase_build()
    rows = phase_kernels(dev)
    paths = {"1d": phase_1d(dev, out_root)}
    paths["full_width"], full_mem = phase_full(dev)
    paths["cli_2048"] = phase_frontend(dev, out_root)
    paths["n_1024"], large_mem = phase_large(dev)
    check_memory_estimates([full_mem, large_mem])
    print(card, flush=True)
    print(json.dumps(kernel_json(rows, paths)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
