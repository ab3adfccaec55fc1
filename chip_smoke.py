"""Smoke test of the PyTorch/CUDA port (sdpb_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its name and elapsed seconds:
  1. environment: card name and power limit, torch/CUDA versions, mpmath
  2. build: the port's decimal codec (csrc/codec.cpp, the host C++
     compiler; it must load, its seconds printed), the limb kernels of
     every slot class (128, 256 and 512 slots), the float64-expansion
     library of K = 1..20 (the elementwise kernel in both designs, the
     Cholesky column loop and the substitution, each a value a thread
     where it can) and the
     expansion libraries of K = 23, 53 and 54 (every operation a value a
     warp, the column loops over thread-block clusters; one library a K,
     as a first call at that K builds it) with nvcc, one process per
     object, all started
     together (registers, stack frame and spills per kernel
     instantiation and per out-of-line function, and each build's
     seconds; a spill fails the phase at K <= 20, above it the spill
     bytes are printed)
  3. kernels against their plain PyTorch versions, bit for bit: the
     factorization kernels at the full-width shapes (S = 47, 400 bits)
     and at S = 26 (--precision 212), S = 116 (--precision 1024),
     n = 64 and n = 7, and at S = 130, 230 and 458 (--precision 1152,
     2048 and 4096); the elementwise kernels at the same S, one value
     at a time, and with one operand broadcast over the batch;
     CUDA-event times of back-to-back calls, and for the elementwise
     kernels, whose calls are bound by the host, also the device time
     of a CUDA graph of the calls; the five expansion kernels (add,
     mul, div, add_f64, mul_f64) likewise, in each design (a value a
     thread at K <= 20, a value a warp at K >= 3), at (49152, 8),
     (49152, 20) and at 4096 values for K = 2, 4, 8, 20, 23 and 54, over
     zeros, cancellation, NaN, +-inf and exponents 2^-500..2^500, with
     their bound and ratio; both designs' device times over 256..49152
     values at K = 4, 8 and 20 (the design sweep that sets
     WARP_MAX_VALUES); the expansion Cholesky panel and substitution
     kernels against their plain loops at the full-width iteration's
     shapes (K = 8), at K = 2, 4 and 20 (at K = 20 also the full-width
     panels and solves) and, every operation on a warp, at K = 23 and
     54 (the 1d SDP's shapes, (2, 32, 32) panels and (2, 32, 32) x 16
     solves; at K = 23 also the full-width (48, 32, 32) and (1, 384, 32)
     panels and (48, 32, 32) x 384 solves), with a non-PD input and NaN
     and +-inf words, every word's bits; the solve above K = 20 at 1-17
     warps a column over 32 to 18,432 columns (the spread's switch)
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
     spectrum on that solution (as examples/quickstart.py runs it),
     its zeros against the spectrum of sdpb_tpu's recorded 1d solution
     within 1e-30; then 5 iterations at --precision 2048 (S = 230)
  7. above 512 rows: the synthetic problem with N = 1024 for 1
     iteration (the Q Cholesky on 32 panels), its time, the Q
     Cholesky's time, peak memory against the memory estimate (no more
     than 10% below the peak, here and in phase 5)
  8. the float64-expansion format on the card (sdpb_tpu's --device cpu
     format): (a) the 1d SDP through the library at --precision 212
     (K = 4) to PrimalDualOptimal, against sdpb_tpu's recorded
     expansion run (objective and trajectory); (b) the full-width
     synthetic problem at 400 bits (K = 8) for 1 iteration, its time,
     phase split, peak memory against the estimate, the expansion
     kernels' launches by caller (fewer than 5,000 elementwise ones)
     and the elementwise launches by values a launch and design,
     its first iteration (objectives, mu, beta and the search
     direction to 1e-30) against phase 5's limb one, and one more
     iteration under torch.profiler; (c) approx_objective's CLI on
     the card on the 1d SDP, (a)'s solution and a perturbed SDP
     compiled by pmp2sdp, against the same CLI on the CPU, at
     --precision 212, and at 1200 and 2800 (K = 23 and 53, every
     operation on a warp; the CPU runs in processes of their own from
     phase 3 on), and --precision 3000 exiting 2 on the card naming the
     prime pool's limit; (d) the full-width problem at --precision 1024
     (K = 20) for 1 iteration under torch.profiler, its time, peak
     memory, launches, elementwise launches by values a launch and
     design, and the column-loop kernels' device time; (e) the same at
     --precision 1200 (K = 23, the column loops above K = 20 at full
     width), held to (d)'s iteration (K23_EXACT to 1e-250 relative, the
     step lengths to 1e-12), with the two column-loop kernels' device
     time, launches and share of the device time
  9. outer_limits on the card, each step a process: the quickstart PMP
     and a seeded full-width PMP (three blocks, 1x1 and 2x2 with poles,
     two decision variables) through pmp2functions -p 128 (byte for
     byte the in-process call's); outer_limits at --precision 128 (K =
     3) within 1e-10 of the known objective and 1e-19 of sdpb_tpu's
     recorded run (optimal and y); at 1024 and 1200 (K = 20, 23) and
     the full-width PMP at 1024, the loop cut at a duality gap
     threshold of 1e-2 (1.1 for the full width), against the same CLI
     on the CPU (processes of their own from phase 3 on) to 1e-30 (the
     full width 1e-24); --precision 3000 exiting 2
     naming the prime pool's limit.  Each run's seconds, generations,
     solves and expansion launches by caller
 10. several ranks on the one card (parallel/): (a) the 1d SDP through
     the sdpb CLI as two ranks sharing the card over gloo, started by
     parallel/multihost.py's launch_local as sdpb does with several
     GPUs, 20 iterations, each within 1e-30 of phase 4's mu, objectives
     and gap; (b) a full-width iteration through parallel/mesh.py as a
     world of one over NCCL, within 1e-30 of phase 5's first, its
     seconds beside phase 5's; (c) on two ranks sharing the card, the
     row-panel Cholesky of a full-width Q (N = 384) and its solve
     (dist_q), the intra-block Cholesky of a 240-row block and the exact
     SYRK over its rows (intra), against the dense routes (1e-100
     relative, the SYRK bit for bit).  The backend, the rank count, the times, and each
     rank's limb-kernel launches (both kernels on every rank)

The line before the last is one JSON object with a record per kernel
and design (``exp_mul`` a value a thread, ``exp_mul_warp`` a value a
warp, ``exp_cholesky_panel_warp`` and ``exp_solve_unblocked_warp`` the
column loops above K = 20; ``ms``: CUDA events around back-to-back
calls; ``device_ms``: the CUDA graph's time, elementwise kernels only,
else null);
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
# H100 SXM float64 outside the tensor cores, in operations: the data
# sheet's 34 TFLOP/s counts an FMA as two, and the expansion kernels,
# built without FMA, issue one add, mul, div or compare an instruction
# at that rate (132 SMs x 64 float64 lanes x 1.98 GHz).
PEAK_F64_PER_S = 17e12
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


# The word counts above THREAD_MAX_WORDS whose libraries phase 2 builds
# (one each, as a user's first call at that K would): those of phase 8c's
# --precision 1200 and 2800 (23, 53; 1200 also phases 8e and 9) and the
# CRT prime pool's limit (54, where a warp holds two words a lane and the
# merge network twice the pairs).  Other K above 20 build at first use
# (tests/test_torch_expansion_panels_wide.py holds the column loops' code
# at K = 33 too).
WIDE_KS = (23, 53, 54)


def phase_build():
    """Every slot class's limb library, the expansion library of K =
    1..20 and the expansion libraries of WIDE_KS, all units compiled at
    once (each build in a thread of its own, each starting all its nvcc
    processes); registers, stack and spills per kernel instantiation and
    build seconds; a failure if a limb kernel or an expansion kernel at
    K <= 20 spills (above, a warp's operations at K = 54 keep more than
    a thread's 255 registers hold: the spill bytes are printed)."""
    t = time.time()
    from concurrent.futures import ThreadPoolExecutor

    from sdpb_tpu_torch.io import native_codec
    from sdpb_tpu_torch.ops import expansion_kernels as ek
    from sdpb_tpu_torch.ops import limb_kernels as lk

    with ThreadPoolExecutor(3 + len(WIDE_KS)) as pool:
        codec_job = pool.submit(native_codec.build, force=True)
        limb_job = pool.submit(lk.build, force=True)
        exp_job = pool.submit(ek.build, force=True)
        wide_jobs = {k: pool.submit(ek.build, force=True, k=k)
                     for k in WIDE_KS}
        infos, exp_info = limb_job.result(), exp_job.result()
        wide = {k: job.result() for k, job in wide_jobs.items()}
        codec = codec_job.result()
    # the decimal codec: every decimal the port reads or writes goes
    # through it, so a failed build must not hide behind mpmath
    if not native_codec.available():
        raise AssertionError("the native decimal codec did not load")
    print(f"decimal codec: c++ build {codec['seconds']:.1f} s -> "
          f"{Path(codec['library']).name}", flush=True)
    spills = []
    builds = [(f"class {cap}", info, True) for cap, info in infos.items()]
    builds.append((f"expansion K=1..{ek.THREAD_MAX_WORDS}", exp_info, True))
    builds += [(f"expansion K={k}", info, False) for k, info in wide.items()]
    for label, info, strict in builds:
        print(f"{label}: nvcc build {info['seconds']:.1f} s -> "
              f"{Path(info['library']).name}", flush=True)
        for name, res in _ptxas_resources(info["ptxas"]).items():
            print(f"  {name}: {json.dumps(res)}", flush=True)
            spilled = res.get("spill_stores", 0) or res.get("spill_loads", 0)
            if spilled and strict:
                spills.append((label, name, res))
            elif spilled:
                print(f"  {name} spills at {label}: "
                      f"{res['spill_stores']} bytes stored, "
                      f"{res['spill_loads']} loaded", flush=True)
    for cap in infos:
        lk._lib(cap)
    ek._lib(1)
    for k in WIDE_KS:
        ek._lib(k)
    if spills:
        raise AssertionError(f"kernels spill: {spills}")
    phase("2 build", t)


def _ptxas_resources(lines):
    """Registers, stack frame and spill bytes per kernel instantiation
    (template arguments R, W and, for the elementwise kernel, the op;
    K and the op for the expansion kernel; K for the expansion
    Cholesky and solve kernels and the out-of-line expansion operations
    they call, ``expn::op_mul<K>`` ...), read from the -Xptxas -v
    lines."""
    out, cur = {}, None
    for line in lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"(chol_warp|solve_warp|elementwise_warp|"
                          r"exp_thread|exp_warp|exp_chol_warps|"
                          r"exp_solve_warps|exp_chol|exp_solve)_kernelI"
                          r"((?:Li\d+E)+)E", m.group(1))
            f = re.search(r"4expn(4warp)?\d+(\w+?)ILi(\d+)E", m.group(1))
            cur = (f"{k.group(1)}_kernel<"
                   + ",".join(re.findall(r"Li(\d+)E", k.group(2))) + ">"
                   if k else f"expn::{'warp::' if f.group(1) else ''}"
                   f"{f.group(2)}<{f.group(3)}>" if f else None)
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


def bound_ms(nbytes, ops, peak_ops=PEAK_F32_PER_S):
    """(least time in ms, what bounds it): the bytes moved over the
    memory rate or the float operations over their type's rate
    (float32 by default)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
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
    for n, k in EXPANSION_SHAPES:
        for name, recs in _expansion_checks(dev, rng, k, n).items():
            rows.setdefault(name, []).extend(recs)
    _design_sweep(dev, rng)
    for name, recs in _panel_checks(dev, rng).items():
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


# Expansion kernels (values, K): one full-width operation at K = 8 (400
# bits; the Schur complement's 48 x 32 x 32 values, as for the limbs) and
# at K = 20; 4096 values at K = 2, 4, 8 and 20 (--precision 1060, the
# largest K of the value-a-thread design) and at K = 23 and 54 (--precision
# 1200 and the CRT prime pool's 2862: a value a warp only).  Each in
# every design it has (a value a thread at K <= 20, a value a warp at
# K >= 3).
EXPANSION_SHAPES = ((48 * 32 * 32, 8), (4096, 2), (4096, 4), (4096, 8),
                    (4096, 20), (48 * 32 * 32, 20), (4096, 23), (4096, 54))
# The shapes whose records are the kernels line's: the value-a-thread
# design at the full-width operation (phase 8b), the value-a-warp design
# at K = 23 (phase 8c's --precision 1200).
EXPANSION_MAIN = {"thread": ((48 * 32 * 32, 8),),
                  "warp": ((4096, 23),)}
# The design sweep: device ms of both designs over the batches the
# solver launches (phase 8's histograms), from which
# ops/expansion_kernels.py WARP_MAX_VALUES is chosen.
SWEEP_KS = (4, 8, 20)
SWEEP_NS = (256, 1024, 4096, 8192, 16384, 32768, 49152)


def _random_expansions(rng, n, k, dev):
    """n normalized K-word expansions over exponents 2^-500..2^500 (at
    K = 20 the tails reach the subnormal range), with zeros, NaN, +-inf
    and values near both ends of the float64 range."""
    import torch

    from sdpb_tpu_torch.mp import core

    e = rng.integers(-500, 500, size=(n, 1))
    w = rng.standard_normal((n, k)) * 2.0 ** (e - 53 * np.arange(k))
    w[rng.random(n) < 0.05] = 0.0
    x = core.renorm_words(torch.from_numpy(w), k)
    x[1] = math.nan
    x[2:4] = 0.0
    x[2, 0], x[3, 0] = math.inf, -math.inf
    x[4] = 0.0
    x[4, 0] = 2.0 ** 1000
    x[5] = 0.0
    x[5, 0] = 2.0 ** -1000
    return x.to(dev)


def _mul_terms(k):
    return sum((i + j <= k) + (i + j + 1 <= k)
               for i in range(k) for j in range(k))


def _exp_ops(name, k):
    """Float64 operations of one value of an expansion kernel
    (csrc/expansion.cuh), an add, mul, div or compare one each: a
    two_sum 6, a fast_two_sum 3, a two_prod 17 (two splits of 4, the
    product and its error 9), a compare-exchange 1 (its exchange moves
    words); a renormalization of n words 10 (n - 1) (the two_sum chain,
    the emit's fast_two_sum and its test).  A sign change is an operand
    modifier, not an operation.  mul forms the two_prod of each pair
    with i + j < K once (its error is the next level's term) and only
    the rounded product of each pair with i + j = K."""
    def renorm(n):
        return 10 * (n - 1)

    if k == 1:
        return 1
    if name == "exp_add":
        if k == 2:
            return 20
        n = 1 << (2 * k - 1).bit_length()
        return (n // 2) * (n.bit_length() - 1) + renorm(n)
    if name == "exp_mul":
        if k == 2:
            return 24
        return (17 * (k * (k + 1) // 2) + (k - 1)
                + renorm(_mul_terms(k)))
    if name == "exp_mul_f64":
        return 17 * k + renorm(2 * k - 1)
    if name == "exp_add_f64":
        # a is ordered: K - 1 comparisons confirm it, x's insertion K
        return (2 * k - 1) + renorm(k + 1)
    # exp_div: K + 1 digits, each a div, a mul_f64 and an add
    return (k + 1) * (1 + _exp_ops("exp_mul_f64", k)
                      + _exp_ops("exp_add", k)) + renorm(k + 1)


def _designs(k):
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    return [d for d, ok in (("thread", k <= ek.THREAD_MAX_WORDS),
                            ("warp", k >= 3)) if ok]


def _expansion_checks(dev, rng, k, n):
    """The five expansion kernels against their plain versions in each
    design, bit for bit with NaN in the same places, on n random
    expansions with special values among them: b value by value (and the
    first 9 values one launch each), and b's first value broadcast over
    the batch (read in place, batch stride 0)."""
    from sdpb_tpu_torch.mp import core
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    a = _random_expansions(rng, n, k, dev)
    b = _random_expansions(rng, n, k, dev)
    b[6] = -a[6]                       # exact cancellation
    b[7] = 0.0                         # zero divisor and summand
    x = b[:, 0].contiguous()
    rows = {}
    for name, kern, plain, y in (
            ("exp_add", ek.exp_add, core.add_plain, b),
            ("exp_mul", ek.exp_mul, core.mul_plain, b),
            ("exp_div", ek.exp_div, core.div_plain, b),
            ("exp_add_f64", ek.exp_add_f64, core.add_f64_plain, x),
            ("exp_mul_f64", ek.exp_mul_f64, core.mul_f64_plain, x)):
        width = k if y.dim() == 2 else 1
        for label, yy, nb in (("", y, n), (" b broadcast", y[:1], 1)):
            want, plain_ms = timed_once(lambda: plain(a, yy))
            for design in _designs(k):
                key = name + ("_warp" if design == "warp" else "")
                run = lambda: kern(a, yy, design=design)
                _check_bits(f"{key} ({n},{k}){label}", run(), want)
                if nb == n:
                    for i in range(9):
                        _check_bits(f"{key} (1,{k}) value {i}",
                                    kern(a[i:i + 1], yy[i:i + 1],
                                         design=design), want[i:i + 1])
                ms = cuda_ms(run, 5)
                dev_ms = device_ms(run, 5)
                nbytes = (2 * n * k + nb * width) * 8
                ops = n * _exp_ops(name, k)
                bound, by = bound_ms(nbytes, ops, PEAK_F64_PER_S)
                print(f"{key} ({n},{k}){label}: bit-exact  kernel {ms:.4f} "
                      f"ms (device {dev_ms:.4f} ms)  plain {plain_ms:.3f} ms"
                      f"  bound {bound:.5f} ms ({by})  ratio "
                      f"{dev_ms / bound:.1f}", flush=True)
                rows.setdefault(key, []).append(dict(
                    shape=[n, k], err=0.0, ms=ms, device_ms=dev_ms,
                    plain_ms=plain_ms, bytes=nbytes, ops=ops,
                    peak=PEAK_F64_PER_S, design=design,
                    main=(n, k) in EXPANSION_MAIN[design] and nb == n))
    return rows


def _design_sweep(dev, rng):
    """Device ms (a CUDA graph of 5 calls) of both elementwise designs
    over SWEEP_NS values at SWEEP_KS, each operation on random
    expansions: where the value-a-warp design stops being faster."""
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    table = {}
    for k in SWEEP_KS:
        a = _random_expansions(rng, max(SWEEP_NS), k, dev)
        b = _random_expansions(rng, max(SWEEP_NS), k, dev)
        for name, kern, wide in (("exp_add", ek.exp_add, True),
                                 ("exp_mul", ek.exp_mul, True),
                                 ("exp_div", ek.exp_div, True),
                                 ("exp_add_f64", ek.exp_add_f64, False),
                                 ("exp_mul_f64", ek.exp_mul_f64, False)):
            for n in SWEEP_NS:
                aa = a[:n]
                bb = b[:n] if wide else b[:n, 0].contiguous()
                times = {d: device_ms(lambda: kern(aa, bb, design=d), 5)
                         for d in _designs(k)}
                table[f"{name} K={k} n={n}"] = times
    print("design sweep (device ms, thread / warp): " + json.dumps(
        {key: "%.4f / %.4f" % (t["thread"], t["warp"])
         for key, t in table.items()}), flush=True)
    for k in SWEEP_KS:
        for name in ("exp_add", "exp_mul", "exp_div", "exp_add_f64",
                     "exp_mul_f64"):
            warp_wins = [n for n in SWEEP_NS if table[
                f"{name} K={k} n={n}"]["warp"] < table[
                f"{name} K={k} n={n}"]["thread"]]
            print(f"design sweep {name} K={k}: the warp design is faster "
                  f"at n = {warp_wins} (WARP_MAX_VALUES "
                  f"{ek.WARP_MAX_VALUES})", flush=True)


# The expansion column-loop kernels: Cholesky panels (batch, R, W, K),
# R == W the unblocked form, and solves (batch, n, m, K).  The first
# rows are the full-width iteration's at K = 8: the X and Y blocks of
# the two buckets (32 and 48 rows), the panels of the Schur complements
# (96 rows, and 240 padded to 256) and of Q (384) at their first and a
# middle panel, the solves of the X/Y blocks against N = 384 columns,
# of the 48-row blocks against 48 and 96, and of one column; then
# K = 2, 4 and 20 (--precision 1060) at a small batch, and the first
# two panels and solves of the list at K = 20.
EXP_CHOL_SHAPES = ((48, 32, 32, 8), (16, 48, 48, 8), (48, 96, 32, 8),
                   (48, 64, 32, 8), (16, 256, 32, 8), (16, 128, 32, 8),
                   (1, 384, 32, 8), (1, 192, 32, 8)) + tuple(
    (2, R, 32, k) for k in (2, 4, 20) for R in (32, 96)) + (
    (48, 32, 32, 20), (1, 384, 32, 20))
EXP_SOLVE_SHAPES = ((48, 32, 384, 8), (16, 48, 48, 8), (16, 48, 96, 8),
                    (1, 32, 1, 8)) + tuple(
    (2, 32, 16, k) for k in (2, 4, 20)) + ((2, 64, 8, 20),
                                           (48, 32, 384, 20),
                                           (16, 48, 96, 20))
EXP_FULL_WIDTH = {"exp_cholesky_panel": 8, "exp_solve_unblocked": 4}
# Above K = 20 (every operation on a warp, a step's operations over the
# warps of a thread-block cluster): the 1d SDP's shapes in
# approx_objective (Cholesky (1, 5, 5), solves (1, 3, 5) and (1, 5, 1))
# and (2, 32, 32) panels and (2, 32, 32) x 16 solves, at K = 23 and 54;
# and at K = 23 (phase 8e's --precision 1200) the full-width iteration's
# widest: the X/Y blocks' (48, 32, 32) factor and (48, 32, 32) x 384
# solves and Q's tallest panel (1, 384, 32).  The records of the
# (2, 32, 32) shapes at K = 23 (phase 8c's --precision 1200) are the
# kernels line's.
EXP_WIDE_CHOL_SHAPES = tuple((bb, R, W, k) for k in (23, 54)
                             for bb, R, W in ((1, 5, 5), (2, 32, 32))) + (
    (48, 32, 32, 23), (1, 384, 32, 23))
EXP_WIDE_SOLVE_SHAPES = tuple((bb, n, m, k) for k in (23, 54)
                              for bb, n, m in ((1, 3, 5), (1, 5, 1),
                                               (2, 32, 16))) + (
    (48, 32, 384, 23),)
# The solve's spread above K = 20 (ops/expansion_kernels.py
# solve_column_warps): wc warps a column for each wc in SPREAD_WCS (up to
# SPREAD_MAX_WARPS warps in all) at n = 32 over bb * m columns from 32 to
# the full width's 18,432 (K = 23) and from 32 to 512 (K = 54), each
# result bit for bit wc = 1's.
SPREAD_SHAPES = ((2, 16, 23), (4, 128, 23), (48, 384, 23), (2, 16, 54),
                 (4, 128, 54))
SPREAD_WCS = (1, 2, 4, 8, 16, 17)
SPREAD_MAX_WARPS = 40000


def _exp_sqrt_ops(k):
    """Float64 operations of one expansion sqrt_rsqrt (mp/core.py):
    newton_steps(K) steps of three products, an add_f64, an addition
    and K halvings, then three products, two additions and K
    halvings."""
    from sdpb_tpu_torch.mp import core

    if k == 1:
        return 2
    mul, add = _exp_ops("exp_mul", k), _exp_ops("exp_add", k)
    step = 3 * mul + _exp_ops("exp_add_f64", k) + add + k
    return core.newton_steps(k) * step + 3 * mul + 2 * add + k


def _exp_chol_ops(bb, R, W, k):
    """Float64 operations of the column loop of a (bb, R, W) Cholesky
    panel: per column t the pivot's sqrt_rsqrt, R - t - 1 products by
    its rsqrt and one zero addition for each of the column's R - t
    finished entries (it stops there once an entry is unchanged), and a
    product and an addition for each lower entry of the columns right
    of it."""
    mul, add = _exp_ops("exp_mul", k), _exp_ops("exp_add", k)
    ops = 0
    for t in range(W):
        ops += _exp_sqrt_ops(k) + (R - t - 1) * mul + (R - t) * add
        ops += sum(R - c for c in range(t + 1, W)) * (mul + add)
    return bb * ops


def _exp_solve_ops(bb, n, m, k, transpose):
    """Float64 operations of one substitution: per row and column a
    product for each term found so far, an addition for each pair of
    the tree sum with such a term in it (a pair of masked +0 terms is
    skipped), then an addition and a product."""
    mul, add = _exp_ops("exp_mul", k), _exp_ops("exp_add", k)
    ops = 0
    for i in range(n):
        live = [(j > i) if transpose else (j < i) for j in range(n)]
        ops += sum(live) * mul + add + mul
        while len(live) > 1:
            h = len(live) // 2
            merged = [live[p] or live[p + h] for p in range(h)]
            ops += sum(merged) * add
            live = merged + live[2 * h:]
    return bb * m * ops


def _words_of(rng, a, k, dev):
    """Float64 values as normalized K-word expansions with random
    tails, on the device."""
    import torch

    from sdpb_tpu_torch.mp import core

    w = np.stack([a] + [a * rng.standard_normal(a.shape) * 2.0 ** (-53 * i)
                        for i in range(1, k)], axis=-1)
    return core.renorm_words(torch.from_numpy(w), k).to(dev)


def _spd_expansions(rng, bb, n, k, dev, cols=None):
    """An SPD (bb, n, n) matrix, or its first ``cols`` columns, in
    K-word expansions."""
    g = rng.standard_normal((bb, n, n))
    a = g @ g.transpose(0, 2, 1) + n * np.eye(n)
    return _words_of(rng, a[:, :, :cols or n], k, dev)


def _check_bits(name, got, want):
    """Every word's bits equal, NaN in the same places (any NaN bits)."""
    import torch

    nan = got.isnan() | want.isnan()
    if not (torch.equal(got.isnan(), want.isnan()) and torch.equal(
            got.view(torch.int64)[~nan], want.view(torch.int64)[~nan])):
        _check_same(name, got, want)
        raise AssertionError(f"{name} differs from its plain version in "
                             f"the sign of a zero")


def _panel_checks(dev, rng):
    """exp_cholesky_panel and exp_solve_unblocked against their plain
    loops, bit for bit with NaN in the same places.  On the card the
    plain loop is the loop over the elementwise expansion kernels,
    which this phase holds bit for bit to mp/core.py's plain functions
    above; the loop over those plain functions themselves would take
    minutes at these shapes.  Also a non-PD batch (NaN out as the loop
    gives) and NaN and +-inf words in a panel and in a solve; above K =
    20 the solve's spreads (_solve_spreads)."""
    import torch

    from sdpb_tpu_torch.mp import core
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    rows = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for idx, (bb, R, W, k) in enumerate(EXP_CHOL_SHAPES +
                                        EXP_WIDE_CHOL_SHAPES):
        name = "exp_cholesky_panel" + (
            "_warp" if k > ek.THREAD_MAX_WORDS else "")
        main = (idx < EXP_FULL_WIDTH["exp_cholesky_panel"]
                or (bb, R, W, k) == (2, 32, 32, 23))
        c = _spd_expansions(rng, bb, R, k, dev, cols=W)
        got = ek.exp_cholesky_panel(c)
        want, plain_ms = timed_once(lambda: ek.cholesky_panel_plain(c))
        _check_bits(f"{name} ({bb},{R},{W},{k})", got, want)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} ({bb},{R},{W},{k}): non-finite")
        ms = cuda_ms(lambda: ek.exp_cholesky_panel(c), 3)
        nbytes, ops = 2 * c.numel() * 8, _exp_chol_ops(bb, R, W, k)
        bound, by = bound_ms(nbytes, ops, PEAK_F64_PER_S)
        spread = ""
        if k > ek.THREAD_MAX_WORDS:
            units = bb * max(1, -(-(R - W) // ek.chol_row_tile(W)))
            blocks = ek.chol_cluster_blocks(units, ek._clusters("chol", k))
            spread = f"  clusters {units} of {blocks} blocks"
        print(f"{name} ({bb},{R},{W},{k}): bit-exact  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.1f} ms  bound {bound:.5f} ms ({by})  "
              f"ratio {ms / bound:.0f}{spread}", flush=True)
        rows.setdefault(name, []).append(dict(
            shape=[bb, R, W, k], err=0.0, ms=ms, plain_ms=plain_ms,
            bytes=nbytes, ops=ops, peak=PEAK_F64_PER_S, main=main))
    name = "exp_cholesky_panel"
    for k in (2, 8, 23, 54):
        bad = _spd_expansions(rng, 3, 32, k, dev)
        bad[1] = -bad[1]
        bad[2, 9, 9] = -bad[2, 9, 9]
        got = ek.exp_cholesky_panel(bad)
        if not (got[1].isnan().any() and got[2].isnan().any()
                and torch.isfinite(got[0]).all()):
            raise AssertionError(f"{name}: a non-PD input did not give NaN")
        _check_bits(f"{name} non-PD (K = {k})", got,
                    ek.cholesky_panel_plain(bad))
        c = _spd_expansions(rng, 2, 96, k, dev, cols=32)
        c[0, 40, 3, 0], c[0, 70, 5, 0] = math.nan, math.inf
        c[1, 50, 2, 0] = -math.inf
        c[1, 60] = 0.0
        _check_bits(f"{name} NaN/inf words (K = {k})",
                    ek.exp_cholesky_panel(c), ek.cholesky_panel_plain(c))
    print(f"{name}: non-PD input gives NaN and NaN/+-inf words match the "
          f"plain loop", flush=True)

    for idx, (bb, n, m, k) in enumerate(EXP_SOLVE_SHAPES +
                                        EXP_WIDE_SOLVE_SHAPES):
        name = "exp_solve_unblocked" + (
            "_warp" if k > ek.THREAD_MAX_WORDS else "")
        main = (idx < EXP_FULL_WIDTH["exp_solve_unblocked"]
                or (bb, n, m, k) == (2, 32, 16, 23))
        lfac = ek.exp_cholesky_panel(_spd_expansions(rng, bb, n, k, dev))
        didx = torch.arange(n, device=dev)
        inv_d = core.recip(lfac[:, didx, didx, :]).contiguous()
        b = _words_of(rng, rng.standard_normal((bb, n, m)), k, dev)
        for transpose in (False, True):
            got = ek.exp_solve_unblocked(lfac, b, inv_d, transpose)
            want, plain_ms = timed_once(lambda: ek.solve_unblocked_plain(
                lfac, b, inv_d, transpose))
            _check_bits(f"{name} ({bb},{n},{m},{k}) T={int(transpose)}",
                        got, want)
            ms = cuda_ms(lambda: ek.exp_solve_unblocked(
                lfac, b, inv_d, transpose), 3)
            nbytes = (lfac.numel() + 2 * b.numel() + inv_d.numel()) * 8
            ops = _exp_solve_ops(bb, n, m, k, transpose)
            bound, by = bound_ms(nbytes, ops, PEAK_F64_PER_S)
            spread = (f"lanes {ek.solve_lanes(bb, n, m)}" if k <= 20
                      else "warps a column "
                      + str(ek._solve_spread(bb, n, m, k, dev)))
            print(f"{name} ({bb},{n},{n})x{m} K={k} T={int(transpose)}: "
                  f"bit-exact  {spread}  kernel {ms:.3f} ms  plain "
                  f"{plain_ms:.1f} ms  bound {bound:.5f} ms ({by})  ratio "
                  f"{ms / bound:.0f}", flush=True)
            rows.setdefault(name, []).append(dict(
                shape=[bb, n, m, k, int(transpose)], err=0.0, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops,
                peak=PEAK_F64_PER_S, main=main))
    name = "exp_solve_unblocked"
    for k in (2, 8, 23, 54):
        lfac = ek.exp_cholesky_panel(_spd_expansions(rng, 2, 32, k, dev))
        didx = torch.arange(32, device=dev)
        inv_d = core.recip(lfac[:, didx, didx, :]).contiguous()
        lfac[0, 20, 3, 0], lfac[1, 25, 7, 0] = math.inf, math.nan
        b = _words_of(rng, rng.standard_normal((2, 32, 9)), k, dev)
        b[0, 5, 2, 0] = -math.inf
        b[1, 4] = 0.0
        for transpose in (False, True):
            _check_bits(f"{name} NaN/inf words (K = {k}, T = "
                        f"{int(transpose)})",
                        ek.exp_solve_unblocked(lfac, b, inv_d, transpose),
                        ek.solve_unblocked_plain(lfac, b, inv_d, transpose))
    print(f"{name}: NaN/+-inf words match the plain loop", flush=True)
    _solve_spreads(dev, rng)
    return rows


def _solve_spreads(dev, rng):
    """The solve above K = 20 at each spread of SPREAD_WCS (warps a
    column) over SPREAD_SHAPES: CUDA-event ms of each, every result bit
    for bit wc = 1's (a warp a column, the operations one after
    another), and the fastest beside solve_column_warps's choice."""
    import torch

    from sdpb_tpu_torch.mp import core
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    n = 32
    for bb, m, k in SPREAD_SHAPES:
        lfac = ek.exp_cholesky_panel(_spd_expansions(rng, bb, n, k, dev))
        didx = torch.arange(n, device=dev)
        inv_d = core.recip(lfac[:, didx, didx, :]).contiguous()
        b = _words_of(rng, rng.standard_normal((bb, n, m)), k, dev)
        times, outs = {}, {}
        for wc in SPREAD_WCS:
            if bb * m * wc > SPREAD_MAX_WARPS:
                continue

            def run(wc=wc):
                outs[wc] = ek.solve_warps(lfac, b, inv_d, False, wc)

            times[wc] = cuda_ms(run, 2)
            _check_bits(f"solve spread wc = {wc} ({bb},{n},{n})x{m} K={k}",
                        outs[wc], outs[1])
        print(f"solve spread ({bb},{n},{n})x{m} K={k}, {bb * m} columns: "
              f"ms by warps a column {json.dumps(times)}; fastest "
              f"{min(times, key=times.get)}, chosen "
              f"{ek._solve_spread(bb, n, m, k, dev)} (clusters of 1 .. 8 "
              f"blocks the card holds: "
              f"{list(ek._clusters('solve', k).values())})", flush=True)


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


class _FirstDirection:
    """Keeps, on the host, the search direction (dx, dy) that the solver
    hands to ``bucket_iteration.apply_step`` first: the first
    iteration's corrector direction, which needs no eigenvector."""

    def __enter__(self):
        from sdpb_tpu_torch.solver import bucket_iteration as bit

        self.dx = self.dy = None
        self._inner = inner = bit.apply_step

        def apply_step(problem, state, res, dx, dX, dy, dY, *args):
            if self.dy is None:
                self.dx = [t.cpu().numpy() for t in dx]
                self.dy = dy.cpu().numpy()
            return inner(problem, state, res, dx, dX, dy, dY, *args)

        bit.apply_step = apply_step
        return self

    def __exit__(self, *exc):
        from sdpb_tpu_torch.solver import bucket_iteration as bit

        bit.apply_step = self._inner


class _LayerSpans:
    """The program's layer spans switched on (``utils/timers.py``); on
    exit ``records`` holds them."""

    def __enter__(self):
        from sdpb_tpu_torch.utils import timers

        timers.take()
        self._setting = timers.layer_spans(True)
        self.records = []
        return self

    def __exit__(self, *exc):
        from sdpb_tpu_torch.utils import timers

        timers.layer_spans(self._setting)
        self.records = timers.take()[0]


def _phase_split(timers, spans) -> dict:
    """Seconds by the driver's residues and step spans and by the
    solver's phase spans, summed over the iterations."""
    split = {}
    for name, start, stop in timers.named:
        leaf = name.rsplit(".", 1)[-1]
        if stop is not None and name.count(".") >= 2:
            split[leaf] = split.get(leaf, 0.0) + (stop - start)
    for layer, name, start, stop, _ in spans.records:
        if layer == "phases":
            split[name] = split.get(name, 0.0) + (stop - start) / 1e9
    return split


def _direction_gap(got, want):
    """max |got - want| / max |want| of dx (all blocks) and of dy, each
    value exact in mpmath (limbs or float64 words)."""
    import mpmath

    from sdpb_tpu_torch.mp import decimal as mpdec

    ctx = mpmath.mp.clone()
    ctx.prec = 1200
    gap = {}
    flat = lambda blocks: np.concatenate(
        [a.reshape(-1, a.shape[-1]) for a in blocks])
    for key in ("dx", "dy"):
        g, w = getattr(got, key), getattr(want, key)
        if key == "dx":
            g, w = flat(g), flat(w)
        num = den = ctx.mpf(0)
        for gi, wi in zip(g, w):
            vw = mpdec.to_mpf(wi, ctx)
            num = max(num, abs(mpdec.to_mpf(gi, ctx) - vw))
            den = max(den, abs(vw))
        gap[key] = float(num / den)
    return gap


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
    with _FirstDirection() as direction, _LayerSpans() as spans:
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
    split = _phase_split(timers, spans)
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
    _profile_iteration(problem, state, seconds / n_it,
                       SolverParams(precision=400, max_iterations=1),
                       "full width")
    phase("5 full width", t)
    return launches, {"N": problem.dual_dim, "peak": peak,
                      "estimate": estimate,
                      "first": result.iterations[0],
                      "direction": direction,
                      "s_per_it": seconds / n_it}


# Device kernels by what launched them: the port's own CUDA kernels, the
# integer elementwise glue (CRT digits and residues, limb exponents),
# library matrix products, and the rest (float glue, copies).
PORT_KERNELS = (
    ("cholesky_unblocked_batched", r"\(anonymous namespace\)::chol_warp_kernel<"),
    ("solve_unblocked_batched", r"\(anonymous namespace\)::solve_warp_kernel<"),
    ("limb_elementwise",
     r"\(anonymous namespace\)::elementwise_warp_kernel<"),
    ("expansion_elementwise",
     r"\(anonymous namespace\)::exp_thread_kernel<"),
    ("expansion_elementwise_warp",
     r"\(anonymous namespace\)::exp_warp_kernel<"),
    ("exp_cholesky_panel", r"\(anonymous namespace\)::exp_chol_kernel<"),
    ("exp_solve_unblocked", r"\(anonymous namespace\)::exp_solve_kernel<"),
    ("exp_cholesky_panel_warp",
     r"\(anonymous namespace\)::exp_chol_warps_kernel<"),
    ("exp_solve_unblocked_warp",
     r"\(anonymous namespace\)::exp_solve_warps_kernel<"),
)
PROFILE_CLASSES = (
    ("port_kernels", "|".join(pat for _, pat in PORT_KERNELS)),
    ("matmul", r"gemm|xmma|cutlass"),
    ("integer_glue", r"<(int|long)\b|\b(int|long)>|\((int|long)\)#"),
)


def _profile_iteration(problem, state, s_per_it, params, label):
    """One more full-width iteration under torch.profiler, summed by
    _profile_report against the unprofiled seconds per iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdpb_tpu_torch.solver import driver

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver.solve(problem, params, state=state)
        torch.cuda.synchronize()
    return _profile_report(prof, s_per_it, label)


def _profile_report(prof, s_per_it, label):
    """Device time per CUDA kernel name of a profiled iteration, summed,
    and that total over ``s_per_it`` (the device's busy share; kernels
    run on one stream, so they do not overlap); prints it and returns
    the port's kernels' device ms and launches."""
    from torch.autograd import DeviceType

    # the trace's raw events summed by name: key_averages() builds a
    # Python object tree over every event first, minutes for the ~10^6
    # events of an iteration, where this loop takes about a second
    device_ms, calls = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        key = ev.name()
        device_ms[key] = device_ms.get(key, 0.0) + ev.duration_ns() / 1e6
        calls[key] = calls.get(key, 0) + 1
    total = sum(device_ms.values())
    classes = {}
    for key, ms in device_ms.items():
        cls = next((c for c, pat in PROFILE_CLASSES if re.search(pat, key)),
                   "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    kernels = {}
    for name, pat in PORT_KERNELS:
        keys = [k for k in device_ms if re.search(pat, k)]
        kernels[name] = {"device_ms": sum(device_ms[k] for k in keys),
                         "launches": sum(calls[k] for k in keys)}
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} profiled iteration: " + json.dumps({
        "device_ms_total": total,
        "busy_share": total / 1e3 / s_per_it if total else "not measured",
        "device_ms_by_class": classes,
        "port_kernels": kernels,
        "top_device_ms": {k[:120]: v for k, v in top}}), flush=True)
    return kernels, total


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


def _recorded_spectrum(work: Path) -> list:
    """The zeros of the spectrum of sdpb_tpu's recorded 1d solution
    (data/reference_trajectories.json, the expansion run at 212 bits):
    x_0.txt and c_minus_By.json written from its words by the port's
    writers, then the port's spectrum in process."""
    import torch

    from sdpb_tpu_torch.apps import spectrum
    from sdpb_tpu_torch.io import output as out_io
    from sdpb_tpu_torch.io.sdp_json import read_sdp
    from sdpb_tpu_torch.solver.data import bucketed_problem_from_raw

    sdp = REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
    ref = json.loads((REPO / "sdpb_tpu_torch" / "data" /
                      "reference_trajectories.json").read_text())[
        "quickstart_1d_expansion"]
    k, sol = ref["words"], ref["solution"]
    problem = bucketed_problem_from_raw(read_sdp(sdp, k=k), k, "cpu",
                                        torch.float64)
    out = work / "recorded_out"
    out_io.save_c_minus_By(out / "c_minus_By" / "c_minus_By.json", problem,
                           torch.as_tensor(np.asarray(sol["y"])))
    out_io.write_vector(out / "x_0.txt",
                        np.asarray(sol["blocks"][0]["x"], dtype=np.float64))
    if spectrum.main(["--precision", "768", "-i", str(sdp / "pmp_info.json"),
                      "--solution", str(out), "--threshold", "1e-10", "-o",
                      str(work / "recorded_spectrum.json"), "-j", "1",
                      "-v", "0"]) != 0:
        raise AssertionError("spectrum of the recorded solution failed")
    return json.loads((work / "recorded_spectrum.json").read_text())


# Phase 6's spectrum: each zero of the card's solution within this of the
# recorded solution's (tests/test_torch_spectrum.py::
# test_zero_moves_less_than_y: both solutions stop at a duality gap below
# 1e-30, and a relative change d of y moves the zero by ~0.61 d).
SPECTRUM_ZERO_TOL = "1e-30"


def _spectrum_step(work: Path) -> None:
    """The quickstart's last step (examples/quickstart.py:52-55) as a
    process: spectrum on the restarted sdpb run's solution, its zeros
    against the recorded solution's."""
    t0 = time.time()
    _run([sys.executable, "-m", "sdpb_tpu_torch.apps.spectrum",
          "--precision", "768", "-i", "quickstart_1d_sdp/pmp_info.json",
          "--solution", "out", "--threshold", "1e-10", "-o",
          "spectrum.json"], work)
    seconds = time.time() - t0
    got = json.loads((work / "spectrum.json").read_text())
    want = _recorded_spectrum(work)
    counts = [len(b["zeros"]) for b in got]
    if counts != [len(b["zeros"]) for b in want] or counts != [1]:
        raise AssertionError(f"spectrum: zeros per block {counts}, the "
                             f"recorded solution's "
                             f"{[len(b['zeros']) for b in want]}")
    import mpmath

    ctx = mpmath.mp.clone()
    ctx.prec = 2600
    worst = ctx.mpf(0)
    for gb, wb in zip(got, want):
        for gz, wz in zip(gb["zeros"], wb["zeros"]):
            worst = max(worst, abs(ctx.mpf(gz["zero"])
                                   - ctx.mpf(wz["zero"])))
    if not worst < ctx.mpf(SPECTRUM_ZERO_TOL):
        raise AssertionError(f"spectrum: a zero {mpmath.nstr(worst, 5)} "
                             f"from the recorded solution's")
    print(f"spectrum (process) in {seconds:.2f} s: {sum(counts)} zero at "
          f"x = {got[0]['zeros'][0]['zero'][:30]}, |diff| from the "
          f"recorded solution's {mpmath.nstr(worst, 5)} (tolerance "
          f"{SPECTRUM_ZERO_TOL})", flush=True)


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
    _spectrum_step(work)

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


# ---------------------------------------------------------------------------
# Phase 8: the float64-expansion format on the card
# ---------------------------------------------------------------------------

EXP_ELEMENTWISE = ("exp_add", "exp_mul", "exp_div", "exp_add_f64",
                   "exp_mul_f64")
EXP_KERNELS = EXP_ELEMENTWISE + ("exp_cholesky_panel", "exp_solve_unblocked")
# The kernels the expansion solves launch: exp_add_f64's one caller on
# these paths was the pivots' sqrt_rsqrt, which runs inside
# exp_cholesky_panel (add_diag's shifts there are MP values).
EXP_PATH_KERNELS = tuple(n for n in EXP_KERNELS if n != "exp_add_f64")
# Phase 8b's gate: elementwise expansion launches of one full-width
# iteration (85,585 when the column loops were launch sequences).
EXP_ELEMENTWISE_MAX = 5000


def _mpf400(text):
    import mpmath

    ctx = mpmath.mp.clone()
    ctx.prec = 400
    return ctx.mpf(text)


def _rel(a, b):
    a, b = _mpf400(a), _mpf400(b)
    return float(abs(a - b) / max(abs(a), abs(b), _mpf400("1e-300")))


def _require_launches(label, launches, names):
    """Each kernel of ``names`` launched, an elementwise operation in
    either design (``exp_mul`` or ``exp_mul_warp``)."""
    missing = [n for n in names if launches.get(n, 0) +
               launches.get(n + "_warp", 0) <= 0]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}: {launches}")


class _LaunchCallers:
    """Counts the expansion kernels' launches by the function that asked
    for them: the first frame outside mp/core.py,
    ops/expansion_kernels.py and utils/timers.py (``module.function``),
    per kernel."""

    def __enter__(self):
        from sdpb_tpu_torch.mp import core
        from sdpb_tpu_torch.ops import expansion_kernels as ek
        from sdpb_tpu_torch.utils import timers

        self.counts = {}
        self._inner = inner = ek._status
        # the layer spans' wrapper is no caller either
        skip = {core.__file__, ek.__file__, timers.__file__}

        def status(name, err):
            f = sys._getframe(1)
            # _BatchHistogram's wrapper of ek._launch is no caller either
            while f.f_code.co_filename in skip or (
                    f.f_code.co_filename == __file__
                    and f.f_code.co_name == "launch"):
                f = f.f_back
            key = f"{Path(f.f_code.co_filename).stem}.{f.f_code.co_name}"
            per = self.counts.setdefault(key, {})
            per[name] = per.get(name, 0) + 1
            return inner(name, err)

        ek._status = status
        return self

    def __exit__(self, *exc):
        from sdpb_tpu_torch.ops import expansion_kernels as ek

        ek._status = self._inner

    def report(self):
        """{caller: {kernel: launches}}, the callers by launches."""
        return dict(sorted(self.counts.items(),
                           key=lambda kv: -sum(kv[1].values())))


class _BatchHistogram:
    """The elementwise expansion launches by operation, values a launch
    (n) and design: {op: {n: {design: launches}}}."""

    def __enter__(self):
        from sdpb_tpu_torch.ops import expansion_kernels as ek

        self.counts = {}
        self._inner = inner = ek._launch

        def launch(name, a, b, batch, k, b_width, design):
            n = math.prod(batch)
            d = design or ek.elementwise_design(n, k)
            per = self.counts.setdefault(name, {}).setdefault(n, {})
            per[d] = per.get(d, 0) + 1
            return inner(name, a, b, batch, k, b_width, design)

        ek._launch = launch
        return self

    def __exit__(self, *exc):
        from sdpb_tpu_torch.ops import expansion_kernels as ek

        ek._launch = self._inner

    def report(self):
        return {op: dict(sorted(per.items()))
                for op, per in sorted(self.counts.items())}


def _check_exp_trajectory(records, ref):
    """The card's expansion trajectory against sdpb_tpu's recorded CPU
    run: the same number of iterations; mu, the objectives, the gap and
    beta to 1e-12 relative and the step lengths to 1e-12; the error
    norms to 1e-6 relative or 1e-10 absolute.  Over the 160 iterations
    the port's own CPU run differs from the recording by up to 1.4e-14
    in mu, 8.8e-15 in the objectives and 1.7e-14 in the steps (the
    eigenvectors behind the step lengths come from two LAPACK builds),
    and by up to 1.7e-13 absolute in the dual error, a residual that
    is rounding noise once the iterate is dual feasible (iteration 47
    on); the card's rsqrt seeds may also differ in the last bit."""
    want = ref["iterations"]
    if len(records) != len(want):
        raise AssertionError(f"expansion 1d took {len(records)} iterations, "
                             f"sdpb_tpu {len(want)}")
    worst = {}
    for g, w in zip(records, want):
        for key in ("mu", "primal_objective", "dual_objective",
                    "duality_gap", "beta_corrector"):
            r = _rel(getattr(g, key), w[key])
            worst[key] = max(worst.get(key, 0.0), r)
            if r > 1e-12:
                raise AssertionError(f"expansion 1d iteration {g.iteration} "
                                     f"{key}: {getattr(g, key)} vs {w[key]}")
        for key in ("primal_error_P", "primal_error_p", "dual_error"):
            a, b = _mpf400(getattr(g, key)), _mpf400(w[key])
            d = float(abs(a - b))
            worst[key] = max(worst.get(key, 0.0), d)
            if d > 1e-6 * float(max(abs(a), abs(b))) + 1e-10:
                raise AssertionError(f"expansion 1d iteration {g.iteration} "
                                     f"{key}: {getattr(g, key)} vs {w[key]}")
        for key in ("primal_step", "dual_step"):
            d = abs(getattr(g, key) - w[key])
            worst[key] = max(worst.get(key, 0.0), d)
            if d > 1e-12:
                raise AssertionError(f"expansion 1d iteration "
                                     f"{g.iteration} {key}")
    return worst


def _expansion_1d(dev, out_root: Path):
    """(a) The 1d SDP in float64 expansions through the library
    (driver.solve on CUDA tensors), to termination."""
    import torch

    from sdpb_tpu_torch.io import output as out_io
    from sdpb_tpu_torch.io.sdp_json import read_sdp
    from sdpb_tpu_torch.ops import expansion_kernels as ek
    from sdpb_tpu_torch.ops import limb_kernels as lk
    from sdpb_tpu_torch.solver import driver
    from sdpb_tpu_torch.solver.data import bucketed_problem_from_raw
    from sdpb_tpu_torch.solver.params import SolverParams

    ref = json.loads((REPO / "sdpb_tpu_torch" / "data" /
                      "reference_trajectories.json").read_text())[
        "quickstart_1d_expansion"]
    params = SolverParams(precision=212, word_dtype="float64")
    raw = read_sdp(REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp",
                   k=params.n_words)
    problem = bucketed_problem_from_raw(raw, params.n_words, dev,
                                        torch.float64)
    ek.reset_launches()
    lk.reset_launches()
    t0 = time.time()
    result = driver.solve(problem, params)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(ek.LAUNCHES)
    if any(lk.LAUNCHES.values()):
        raise AssertionError(f"the expansion solve launched limb kernels: "
                             f"{lk.LAUNCHES}")
    _require_launches("expansion 1d", launches, EXP_PATH_KERNELS)
    if result.reason.name != "PrimalDualOptimal":
        raise AssertionError(f"expansion 1d ended {result.reason.name}")
    diff = abs(_mpf400(result.primal_objective)
               - _mpf400(ref["primal_objective"]))
    if not diff <= _mpf400("1e-30"):
        raise AssertionError(f"expansion 1d primalObjective "
                             f"{result.primal_objective} off by {diff}")
    worst = _check_exp_trajectory(result.iterations, ref)
    sol_dir = out_root / "exp_1d_out"
    out_io.save_solution(sol_dir, result, problem, int(seconds),
                         write_solution="x,y,X,Y")
    print(f"(a) expansion 1d (K = {params.n_words}): "
          f"{len(result.iterations)} iterations in {seconds:.2f} s, "
          f"{result.reason.name}, primalObjective "
          f"{result.primal_objective[:50]} |diff| {float(diff):.3e}; "
          f"trajectory vs sdpb_tpu, worst: {json.dumps(worst)}; launches "
          f"{launches}", flush=True)
    return launches, sol_dir, seconds


def _expansion_full(dev, limb_first, limb_direction):
    """(b) bench.py's synthetic problem at full width in expansions
    (400 bits, K = 8) for 1 iteration: time, phase split, peak memory
    against the estimate, and the first iteration against the limb
    format's (phase 5): mu, objectives, gap and beta to 1e-30 relative
    (both formats carry 400 bits), the search direction (dx of every
    block and dy, through the Schur complement, both Cholesky
    factorizations and the solves) to 1e-30 relative to its largest
    entry, and the error norms to 1e-4 relative (the limb format
    reports them as float32 estimates from its three leading limbs,
    ~2^-17 resolution).  The step lengths are held only to 1e-2
    relative: the limb format takes its lambda_min eigenvectors
    from those float32 estimates of the matrices, whose Rayleigh
    quotient is off by ~||C|| (2^-17 ||C|| / gap)^2: 1.3e-3 relative
    at this iteration's dual step on the card."""
    import torch

    from sdpb_tpu_torch.ops import expansion_kernels as ek
    from sdpb_tpu_torch.solver import driver, memory, synthetic
    from sdpb_tpu_torch.solver.params import SolverParams
    from sdpb_tpu_torch.utils.timers import Timers

    params = SolverParams(precision=400, max_iterations=1,
                          word_dtype="float64")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    problem, state = synthetic.build_problem(params, device=dev)
    estimate = memory.estimate_solver_memory(problem).total
    timers = Timers()
    ek.reset_launches()
    t0 = time.time()
    with _FirstDirection() as direction, _LaunchCallers() as callers, \
            _BatchHistogram() as hist, _LayerSpans() as spans:
        result = driver.solve(problem, params, state=state, timers=timers)
        torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(ek.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _require_launches("expansion full width", launches, EXP_PATH_KERNELS)
    elementwise = sum(launches[n] + launches[n + "_warp"]
                      for n in EXP_ELEMENTWISE)
    print(f"(b) expansion launches by caller: {json.dumps(callers.report())}",
          flush=True)
    print(f"(b) elementwise launches by n and design: "
          f"{json.dumps(hist.report())}", flush=True)
    if elementwise >= EXP_ELEMENTWISE_MAX:
        raise AssertionError(f"expansion full width: {elementwise} "
                             f"elementwise expansion launches an iteration "
                             f"(at most {EXP_ELEMENTWISE_MAX - 1})")
    if len(result.iterations) != 1:
        raise AssertionError(f"expansion full width ran "
                             f"{len(result.iterations)} iterations")
    split = _phase_split(timers, spans)
    got = result.iterations[0]
    worst = {}
    for keys, tol in ((("mu", "primal_objective", "dual_objective",
                        "duality_gap", "beta_corrector"), 1e-30),
                      (("primal_error_P", "primal_error_p", "dual_error",
                        "R_error"), 1e-4)):
        for key in keys:
            r = _rel(getattr(got, key), getattr(limb_first, key))
            worst[key] = r
            if r > tol:
                raise AssertionError(f"expansion full width {key} "
                                     f"{getattr(got, key)} vs limb "
                                     f"{getattr(limb_first, key)}")
    for key, r in _direction_gap(direction, limb_direction).items():
        worst[key] = r
        if not r <= 1e-30:
            raise AssertionError(f"expansion full width {key} is "
                                 f"{r} (relative) from the limb format's")
    for key in ("primal_step", "dual_step"):
        d = abs(getattr(got, key) / getattr(limb_first, key) - 1.0)
        worst[key] = d
        if d > 1e-2:
            raise AssertionError(f"expansion full width {key} "
                                 f"{getattr(got, key)} vs limb "
                                 f"{getattr(limb_first, key)}")
    print(f"(b) expansion full width (K = {params.n_words}): 1 iteration "
          f"in {seconds:.2f} s; phase split (s): "
          + json.dumps({k: round(v, 3) for k, v in split.items()})
          + f"; max_memory_allocated {peak / 2**30:.3f} GiB estimate "
          f"{estimate / 2**30:.3f} GiB; vs the limb iteration, worst: "
          f"{json.dumps(worst)}; launches {launches}", flush=True)
    _profile_iteration(problem, state, seconds, params,
                       "expansion full width")
    return launches, {"N": f"{problem.dual_dim} (expansions)", "peak": peak,
                      "estimate": estimate}


def _run_json(fn, argv):
    """stdout of an entry point, parsed as JSON."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]}... exited {rc}")
    return json.loads(buf.getvalue())


def _perturbed_sdp(work: Path) -> Path:
    """The quickstart PMP with one coefficient moved
    (examples/quickstart.py:33-44 with 1/12 moved to 0.0834), compiled
    by the port's pmp2sdp into work/sdp_new."""
    from sdpb_tpu_torch.apps import pmp2sdp
    from sdpb_tpu_torch.io import pmp_writer

    pmp_writer.write_pmp_json(
        work / "pmp.json", objective=[0, -1], normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "0.0834"]]]])])
    if pmp2sdp.main(["-p", "768", "-i", str(work / "pmp.json"), "-o",
                     str(work / "sdp_new"), "-v", "0"]) != 0:
        raise AssertionError("pmp2sdp failed on the perturbed PMP")
    return work / "sdp_new"


def _approx_argv(sol_dir: Path, new_sdp: Path, precision: int):
    return ["--sdp", str(REPO / "sdpb_tpu_torch" / "data" /
                         "quickstart_1d_sdp"),
            "--precision", str(precision), "--newSdp", str(new_sdp),
            "--solutionDir", str(sol_dir), "-v", "0"]


# approx_objective above K = 20 (phase 8c): --precision 1200 (K = 23) and
# 2800 (K = 53), each against the same CLI on the CPU, which runs in a
# process of its own from phase 3 on (~20 s and ~100 s there).
WIDE_PRECISIONS = (1200, 2800)


def start_cpu_approx(out_root: Path):
    """The CPU side of phase 8c's runs above K = 20, started early: the
    1d SDP's solution as sdpb_tpu's recorded expansion run left it
    (data/reference_trajectories.json), the perturbed SDP, and one
    approx_objective CLI process on the CPU per WIDE_PRECISIONS (one
    torch thread each).  Returns (argv per precision, processes)."""
    from sdpb_tpu_torch.io import output as out_io

    work = out_root / "exp_approx_wide"
    shutil.rmtree(work, ignore_errors=True)
    (work / "sol").mkdir(parents=True)
    sol = json.loads((REPO / "sdpb_tpu_torch" / "data" /
                      "reference_trajectories.json").read_text())[
        "quickstart_1d_expansion"]["solution"]
    f = lambda v: np.asarray(v, dtype=np.float64)
    out_io.write_vector(work / "sol" / "y.txt", f(sol["y"]))
    for j, blk in enumerate(sol["blocks"]):
        out_io.write_vector(work / "sol" / f"x_{j}.txt", f(blk["x"]))
        for p in range(2):
            if f(blk["X"][p]).size:
                out_io.write_matrix(work / "sol" / f"X_matrix_{2 * j + p}.txt",
                                    f(blk["X"][p]))
                out_io.write_matrix(work / "sol" / f"Y_matrix_{2 * j + p}.txt",
                                    f(blk["Y"][p]))
    new_sdp = _perturbed_sdp(work)
    env = _port_env()
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from sdpb_tpu_torch.apps import approx_objective as a; "
            "sys.exit(a.main(sys.argv[1:], device='cpu'))")
    argvs, procs = {}, {}
    for prec in WIDE_PRECISIONS:
        argvs[prec] = _approx_argv(work / "sol", new_sdp, prec)
        procs[prec] = subprocess.Popen(
            [sys.executable, "-c", code, *argvs[prec]], cwd=str(REPO),
            env=env, stdout=open(work / f"cpu_{prec}.json", "w"),
            stderr=open(work / f"cpu_{prec}.err", "w"))
    return argvs, procs


def _compare_approx(label, card, cpu):
    """The card's approx_objective output against the CPU's: the linear
    term to 1e-60 relative (the same operations on the same words), the
    quadratic term and the objective to 1e-30 (the rebuilt Schur
    complement's condition estimate, ~4e59 at the solution, amplifies
    last-bit differences of the pivots' rsqrt seeds between the card
    and the CPU)."""
    worst = {}
    for key, tol in (("d_objective", 1e-60), ("dd_objective", 1e-30),
                     ("objective", 1e-30)):
        r = _rel(card[0][key], cpu[0][key])
        worst[key] = r
        if r > tol:
            raise AssertionError(f"{label} {key} on the card "
                                 f"{card[0][key]} vs the CPU "
                                 f"{cpu[0][key]}")
    if not _mpf400(card[0]["dd_objective"]) != 0:
        raise AssertionError(f"{label}: zero quadratic term")
    return worst


def _expansion_approx(dev, out_root: Path, sol_dir: Path, cpu_jobs):
    """(c) approx_objective's CLI on the card (its default device) on
    the 1d SDP and a nearby SDP (_perturbed_sdp) against the same CLI on
    the CPU (_compare_approx): at --precision 212 (K = 4) with (a)'s
    solution, then at WIDE_PRECISIONS (K = 23 and 53: every operation a
    value a warp) with the recorded solution (start_cpu_approx); and
    --precision 3000 exiting 2 at startup on the card, naming the
    prime pool's limit."""
    import contextlib
    import io

    from sdpb_tpu_torch.apps import approx_objective
    from sdpb_tpu_torch.ops import expansion_kernels as ek
    from sdpb_tpu_torch.solver.params import SolverParams

    work = out_root / "exp_approx"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = _approx_argv(sol_dir, _perturbed_sdp(work), 212)
    ek.reset_launches()
    t0 = time.time()
    card = _run_json(approx_objective.main, argv)
    seconds = time.time() - t0
    paths = {"exp_approx_objective": dict(ek.LAUNCHES)}
    _require_launches("approx_objective", paths["exp_approx_objective"],
                      ("exp_add", "exp_mul", "exp_div", "exp_cholesky_panel",
                       "exp_solve_unblocked"))
    cpu = _run_json(lambda a: approx_objective.main(a, device="cpu"), argv)
    worst = _compare_approx("approx_objective", card, cpu)
    print(f"(c) approx_objective on the card in {seconds:.2f} s: objective "
          f"{card[0]['objective'][:40]} d {card[0]['d_objective'][:24]} dd "
          f"{card[0]['dd_objective'][:24]}; vs the CPU, worst relative "
          f"{json.dumps(worst)}; launches {paths['exp_approx_objective']}",
          flush=True)
    argvs, procs = cpu_jobs
    for prec in WIDE_PRECISIONS:
        k = SolverParams(precision=prec, word_dtype="float64").n_words
        ek.reset_launches()
        t0 = time.time()
        card = _run_json(approx_objective.main, argvs[prec])
        seconds = time.time() - t0
        key = f"exp_approx_objective_{prec}"
        paths[key] = dict(ek.LAUNCHES)
        _require_launches(f"approx_objective --precision {prec}",
                          paths[key],
                          ("exp_add_warp", "exp_mul_warp", "exp_div_warp",
                           "exp_cholesky_panel_warp",
                           "exp_solve_unblocked_warp"))
        t1 = time.time()
        rc = procs[prec].wait(timeout=900)
        waited = time.time() - t1
        out_file = out_root / "exp_approx_wide" / f"cpu_{prec}.json"
        if rc != 0:
            raise AssertionError(
                f"approx_objective --precision {prec} on the CPU exited "
                f"{rc}: {out_file.with_suffix('.err').read_text()[-2000:]}")
        cpu = json.loads(out_file.read_text())
        worst = _compare_approx(f"approx_objective --precision {prec}",
                                card, cpu)
        print(f"(c) approx_objective --precision {prec} (K = {k}) on the "
              f"card in {seconds:.2f} s (the CPU process waited for "
              f"{waited:.1f} s more): objective {card[0]['objective'][:40]}"
              f" dd {card[0]['dd_objective'][:24]}; vs the CPU, worst "
              f"relative {json.dumps(worst)}; launches {paths[key]}",
              flush=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = approx_objective.main(_approx_argv(sol_dir, work / "sdp_new",
                                                3000))
    if rc != 2 or "prime pool" not in err.getvalue() or \
            "largest precision it takes is" not in err.getvalue():
        raise AssertionError(f"approx_objective --precision 3000 on the "
                             f"card exited {rc}: {err.getvalue()[-2000:]}")
    print(f"(c) approx_objective --precision 3000 on the card: exit 2, "
          f"{err.getvalue().strip()}", flush=True)
    return paths


def _expansion_wide(dev, precision, label):
    """bench.py's synthetic problem at full width in expansions at
    ``precision``: one iteration under torch.profiler, its seconds (the
    profiler's cost included), peak memory and the expansion kernels'
    launches, the elementwise launches by values and design, finite
    objectives and mu, and the trace's device time by kernel.  Returns
    (launches, the iteration's record, the port kernels' device ms and
    launches, the trace's device ms)."""
    import mpmath
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdpb_tpu_torch.ops import expansion_kernels as ek
    from sdpb_tpu_torch.solver import driver, synthetic
    from sdpb_tpu_torch.solver.params import SolverParams

    params = SolverParams(precision=precision, max_iterations=1,
                          word_dtype="float64")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    problem, state = synthetic.build_problem(params, device=dev)
    ek.reset_launches()
    with _BatchHistogram() as hist, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        result = driver.solve(problem, params, state=state)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    launches = dict(ek.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} elementwise launches by n and design: "
          f"{json.dumps(hist.report())}", flush=True)
    name = f"expansion K = {params.n_words}"
    _require_launches(name, launches, EXP_PATH_KERNELS)
    if len(result.iterations) != 1:
        raise AssertionError(f"{name} ran {len(result.iterations)} "
                             f"iterations")
    got = result.iterations[0]
    for key in ("mu", "primal_objective", "dual_objective"):
        if not mpmath.isfinite(_mpf400(getattr(got, key))):
            raise AssertionError(f"{name} {key} is {getattr(got, key)}")
    print(f"{label} expansion full width (K = {params.n_words}): 1 "
          f"iteration in {seconds:.2f} s under the profiler; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; mu "
          f"{got.mu[:24]}; launches {launches}", flush=True)
    kernels, total = _profile_report(prof, seconds, f"{name} full width")
    return launches, got, kernels, total


# Phase 8e against 8d: the same float64 data (synthetic.build_problem
# pads the same float64 values with zero words) through the same
# arithmetic at 1024 and 1200 bits.  What is formed before any float64
# rounding, the start point's mu, objectives, gap and error norms (its
# residues and R = mu I - XY), agrees to about 2^-1024 ~ 1e-308 times the
# iteration's condition: held to 1e-250 relative, read at 1400 bits.  The
# step lengths take their eigenvectors from float64 eigensolves
# (solver/iteration.py min_eig_mp) of matrices that agree to that, and so
# to their float64 roundings, then round to float64 themselves: held to
# 1e-12 relative, a float64 eigensolve's own accuracy at these sizes;
# beta_corrector follows the predictor's step lengths and is held to the
# same.
K23_EXACT = ("mu", "primal_objective", "dual_objective", "duality_gap",
             "primal_error_P", "primal_error_p", "dual_error", "R_error")
K23_EXACT_TOL = 1e-250
K23_STEP = ("primal_step", "dual_step", "beta_corrector")
K23_STEP_TOL = 1e-12


def _rel_fine(a, b):
    """|a - b| / max(|a|, |b|), read at 1400 bits (K = 23 carries up to
    1219)."""
    import mpmath

    ctx = mpmath.mp.clone()
    ctx.prec = 1400
    a, b = ctx.mpf(a), ctx.mpf(b)
    return float(abs(a - b) / max(abs(a), abs(b), ctx.mpf("1e-400")))


def _expansion_k23(dev, k20):
    """(e) The full-width iteration at --precision 1200 (K = 23, the
    column loops above K = 20 on their widest shapes) against (d)'s at
    1024 (K = 20): K23_EXACT to K23_EXACT_TOL, K23_STEP to K23_STEP_TOL;
    the two column-loop kernels' device time and launches and their
    share of the iteration's device time."""
    launches, got, kernels, total = _expansion_wide(dev, 1200, "(e)")
    for key in ("exp_cholesky_panel_warp", "exp_solve_unblocked_warp"):
        if launches.get(key, 0) <= 0 or kernels[key]["launches"] <= 0:
            raise AssertionError(f"(e) never launched {key}: {launches}")
    worst = {}
    for keys, tol in ((K23_EXACT, K23_EXACT_TOL), (K23_STEP, K23_STEP_TOL)):
        for key in keys:
            r = _rel_fine(getattr(got, key), getattr(k20, key))
            worst[key] = r
            if not r <= tol:
                raise AssertionError(f"(e) {key} {getattr(got, key)} vs "
                                     f"K = 20 {getattr(k20, key)}")
    loops = {k: kernels[k] for k in ("exp_cholesky_panel_warp",
                                     "exp_solve_unblocked_warp")}
    share = sum(v["device_ms"] for v in loops.values()) / total
    print(f"(e) K = 23 vs K = 20, worst relative: {json.dumps(worst)}; "
          f"column loops above K = 20 {json.dumps(loops)}, "
          f"{share:.4f} of the device time", flush=True)
    return launches


def phase_expansion(dev, out_root: Path, limb_full, cpu_jobs):
    """Phase 8: the expansion format on the card, paths (a)-(e)."""
    t = time.time()
    paths = {}
    paths["exp_1d"], sol_dir, _ = _expansion_1d(dev, out_root)
    paths["exp_full_width"], mem = _expansion_full(
        dev, limb_full["first"], limb_full["direction"])
    paths.update(_expansion_approx(dev, out_root, sol_dir, cpu_jobs))
    paths["exp_full_width_k20"], k20, _, _ = _expansion_wide(dev, 1024,
                                                              "(d)")
    paths["exp_full_width_k23"] = _expansion_k23(dev, k20)
    phase("8 expansion format", t)
    return paths, mem


# ---------------------------------------------------------------------------
# Phase 9: outer_limits on the card, each step a process
# ---------------------------------------------------------------------------

def _reference_outer_limits() -> dict:
    """sdpb_tpu's outer_limits run on the quickstart at --precision 128
    (data/reference_trajectories.json, tests/make_torch_reference_
    trajectories.py): its options, optimal, y, constraints per
    generation and solves."""
    return json.loads((REPO / "sdpb_tpu_torch" / "data" /
                       "reference_trajectories.json").read_text())[
        "outer_limits_quickstart"]


# The runs above K = 3 hold the card to the same CLI on the CPU, in a
# process of its own started after phase 2.  The whole loop of the
# quickstart (7 solves) takes the CPU 938 s at 1024 bits and 1204 s at
# 1200 (one thread, the CLI's printed seconds on a CPU host), more
# than the script's limit; so these runs cut the loop's depth: the gap
# threshold 1e-2, its other options the recorded run's (2 solves and one
# generation; 169 s on the CPU at 1024 bits).
OL_CUT_GAP = "1e-2"
OL_PRECISIONS = (1024, 1200)
# The full-width run: three function blocks (1x1, 1x1 with a pole, 2x2
# with three poles) and two decision variables, at --precision 1024,
# cut to the duality gap threshold 1.1 (2 generations and solves; its
# whole loop at 1e-10 takes the CPU 677 s at 128 bits, 35 constraints).
OL_FULL_WIDTH = 1024
OL_FULL_WIDTH_GAP = "1.1"
# outer_limits on the card against the CPU: the largest |difference| of
# the optimal and the y.  The pieces are host code equal in both; the
# solves run the same MP operations, bit for bit kernel by kernel (phase
# 3), but for the pivots' rsqrt seeds (8c) and the float64 eigensolves
# behind the step lengths (cuSOLVER against LAPACK; steps that differ in
# a float64 bit move the iterate's path, not the optimum): the 1x1
# quickstart runs agree to the last digit (exploratory chip run, both
# precisions), the full-width run, whose 2x2 blocks make the eigensolves
# real and whose loop stops at a duality gap of 1.1, differed by
# 8.2e-32.  A wrong operation moves them by far more.
OL_DEVICE_TOL = {"quickstart": "1e-30", "full_width": "1e-24"}


def _outer_limits_pmp(path: Path, seed: int = 11) -> None:
    """A seeded PMP of three blocks, each polynomial's coefficients a
    seeded +-10% from a positive pattern so that the problem stays
    feasible and bounded: the quickstart's 1x1 block with a third
    function, a 1x1 block with the pole -0.5 and a 2x2 block with the
    poles -0.5, -1.25, -1.25; objective (0, -1, -1)."""
    from sdpb_tpu_torch.io import pmp_writer as w

    rng = np.random.default_rng(seed)

    def c(*vals):
        return [f"{v * (1 + 0.1 * rng.uniform(-1, 1)):.6f}" if v else "0"
                for v in vals]

    off = [c(0, 0.1, 0, 0, 0), c(0, 0, 0.05, 0, 0), c(0, 0, 0, 0, 0)]
    w.write_pmp_json(path, objective=[0, -1, -1], normalization=[1, 0, 0],
                     matrices=[
        w.PositiveMatrixWithPrefactor(
            prefactor=w.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=[[[c(1, 0, 0, 0, 1), c(0, 0, 1, 0, 1 / 12),
                           c(0, 1, 0, 0.2, 0)]]]),
        w.PositiveMatrixWithPrefactor(
            prefactor=w.DampedRational(constant=1, base="0.5",
                                       poles=["-0.5"]),
            polynomials=[[[c(1, 0, 1, 0, 1), c(0, 1, 0, 0, 0.1),
                           c(0, 0, 1, 0, 0)]]]),
        w.PositiveMatrixWithPrefactor(
            prefactor=w.DampedRational(constant="0.75", base="0.5",
                                       poles=["-0.5", "-1.25", "-1.25"]),
            polynomials=[[[c(3, 0, 1, 0, 1), c(0, 0, 1, 0, 0),
                           c(0, 1, 0, 0, 0)], off],
                         [off, [c(2, 0, 0, 0, 1), c(0, 0, 1, 0, 0.1),
                                c(0, 0, 0, 1, 0)]]])])


def _ol_argv(work: Path, case: str, precision: int, tag: str,
             gap=None) -> list:
    opts = _reference_outer_limits()["options"]
    return ["--functions", str(work / f"{case}_functions.json"),
            "--points", str(work / f"{case}_points.json"),
            "--precision", str(precision),
            "--dualityGapThreshold", gap or opts["dualityGapThreshold"],
            "--primalErrorThreshold", opts["primalErrorThreshold"],
            "--dualErrorThreshold", opts["dualErrorThreshold"],
            "--initialMatrixScalePrimal", opts["initialMatrixScalePrimal"],
            "--initialMatrixScaleDual", opts["initialMatrixScaleDual"],
            "-o", str(work / f"{tag}.json")]


def _ol_cpu_cases():
    """{tag: (case, precision, duality gap threshold)} of the runs held
    to the CPU."""
    cases = {f"quickstart_{p}": ("quickstart", p, OL_CUT_GAP)
             for p in OL_PRECISIONS}
    cases[f"full_width_{OL_FULL_WIDTH}"] = ("full_width", OL_FULL_WIDTH,
                                            OL_FULL_WIDTH_GAP)
    return cases


def start_cpu_outer_limits(out_root: Path):
    """Phase 9's inputs and the CPU side of its cut runs, started early:
    the quickstart PMP (examples/quickstart.py:33-44) and the full-width
    PMP through pmp2functions -p 128 in process, their points files, and
    one outer_limits CLI process on the CPU per run (one torch thread
    each).  Returns (work dir, processes by tag)."""
    from sdpb_tpu_torch.apps import pmp2functions
    from sdpb_tpu_torch.io import pmp_writer

    work = out_root / "outer_limits"
    shutil.rmtree(work, ignore_errors=True)
    (work / "cpu").mkdir(parents=True)
    pmp_writer.write_pmp_json(
        work / "quickstart_pmp.json", objective=[0, -1],
        normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "1/12"]]]])])
    _outer_limits_pmp(work / "full_width_pmp.json")
    points = {"quickstart": _reference_outer_limits()["options"]["points"],
              "full_width": [["0", "1", "4"], ["0", "2"], ["0", "1", "3"]]}
    for case, pts in points.items():
        if pmp2functions.main(["-p", "128", "-i", str(work /
                                                     f"{case}_pmp.json"),
                               "-o", str(work / "cpu" /
                                         f"{case}_functions.json"),
                               "-v", "0"]) != 0:
            raise AssertionError(f"pmp2functions failed on {case}")
        for d in (work, work / "cpu"):
            (d / f"{case}_points.json").write_text(
                json.dumps({"points": pts}))
    env = _port_env()
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from sdpb_tpu_torch.apps import outer_limits as o; "
            "sys.exit(o.main(sys.argv[1:], device='cpu'))")
    procs = {}
    for tag, (case, prec, gap) in _ol_cpu_cases().items():
        argv = _ol_argv(work / "cpu", case, prec, tag, gap)
        procs[tag] = subprocess.Popen(
            [sys.executable, "-c", code, *argv], cwd=str(REPO), env=env,
            stdout=open(work / "cpu" / f"{tag}.log", "w"),
            stderr=subprocess.STDOUT)
    return work, procs


def outer_limits_child(argv) -> int:
    """Body of phase 9's processes on the card: outer_limits' CLI on
    its default device, with the expansion kernels' launches and their
    callers written beside its output (<out>.launches.json)."""
    from sdpb_tpu_torch.apps import outer_limits
    from sdpb_tpu_torch.ops import expansion_kernels as ek

    ek.reset_launches()
    with _LaunchCallers() as callers:
        rc = outer_limits.main(argv)
    out = Path(argv[argv.index("-o") + 1])
    out.with_suffix(".launches.json").write_text(json.dumps(
        {"launches": dict(ek.LAUNCHES), "callers": callers.report()}))
    return rc


def _ol_card(argv, label):
    """One outer_limits run on the card in a process of its own: its
    output, seconds, generations, solves and launches."""
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.outer_limits_child(sys.argv[1:]))")
    t0 = time.time()
    proc = _run([sys.executable, "-c", code, *argv], str(REPO), timeout=900)
    seconds = time.time() - t0
    out = Path(argv[argv.index("-o") + 1])
    lines = proc.stdout.splitlines()
    run = {"out": json.loads(out.read_text()), "seconds": seconds,
           "generations": sum(x.startswith("num_constraints:")
                              for x in lines),
           "solves": sum(x.startswith("Threshold:") for x in lines),
           "constraints": [int(x.split()[1]) for x in lines
                           if x.startswith("num_constraints:")],
           **json.loads(out.with_suffix(".launches.json").read_text())}
    _require_launches(label, run["launches"], EXP_PATH_KERNELS)
    return run


def _ol_gap(a: dict, b: dict):
    """The largest |difference| of the optimal and the y of two
    outer_limits outputs."""
    import mpmath

    ctx = mpmath.mp.clone()
    ctx.prec = 4096
    pairs = [(a["optimal"], b["optimal"])] + list(zip(a["y"], b["y"]))
    if len(a["y"]) != len(b["y"]):
        raise AssertionError(f"y of {len(a['y'])} and {len(b['y'])} "
                             f"entries")
    return max(abs(ctx.mpf(x) - ctx.mpf(y)) for x, y in pairs)


def _ol_report(label, run, extra):
    print(f"{label}: {run['seconds']:.1f} s, {run['generations']} "
          f"generations ({run['constraints']} constraints), "
          f"{run['solves']} solves, optimal {run['out']['optimal'][:40]}; "
          f"{extra}; launches {json.dumps(run['launches'])}; by caller "
          f"{json.dumps(run['callers'])}", flush=True)


def phase_outer_limits(dev, out_root: Path, cpu_jobs):
    """Phase 9: the quickstart through pmp2functions (a process, its
    file byte for byte the in-process call's), outer_limits on the card
    at --precision 128 (K = 3) against the known objective and sdpb_tpu's
    recorded run, at 1024 and 1200 (K = 20, 23) and the full-width PMP at
    1024 against the CPU processes of start_cpu_outer_limits, and
    --precision 3000 exiting 2; each a process of its own."""
    t = time.time()
    import mpmath

    work, procs = cpu_jobs
    ref = _reference_outer_limits()
    py = sys.executable
    for case in ("quickstart", "full_width"):
        _run([py, "-m", "sdpb_tpu_torch.apps.pmp2functions", "-p", "128",
              "-i", f"{case}_pmp.json", "-o", f"{case}_functions.json"],
             work)
        if (work / f"{case}_functions.json").read_bytes() != \
                (work / "cpu" / f"{case}_functions.json").read_bytes():
            raise AssertionError(f"pmp2functions' process wrote another "
                                 f"{case} functions file than its call")
    print("pmp2functions -p 128 (process): the quickstart's and the full "
          "width's functions files equal byte for byte to the in-process "
          "call's", flush=True)

    runs = {}
    ctx = mpmath.mp.clone()
    ctx.prec = 4096
    run = _ol_card(_ol_argv(work, "quickstart", 128, "card_128"),
                   "outer_limits --precision 128")
    known = abs(ctx.mpf(run["out"]["optimal"])
                - ctx.mpf("1.8402657631320492"))
    recorded = _ol_gap(run["out"], ref)
    if not (known <= ctx.mpf("1e-10") and recorded <= ctx.mpf("1e-19")):
        raise AssertionError(f"outer_limits --precision 128 on the card: "
                             f"optimal {run['out']['optimal']}, "
                             f"{mpmath.nstr(known, 5)} from the known "
                             f"objective, {mpmath.nstr(recorded, 5)} from "
                             f"sdpb_tpu's run")
    _ol_report("outer_limits --precision 128 (K = 3) on the card", run,
               f"|diff| from 1.8402657631320492 {mpmath.nstr(known, 5)}, "
               f"from sdpb_tpu's recorded run (optimal and y) "
               f"{mpmath.nstr(recorded, 5)}; sdpb_tpu's constraints "
               f"{ref['constraints']}, solves {ref['solves']}")
    runs["outer_limits_128"] = run["launches"]

    from sdpb_tpu_torch.solver.params import SolverParams

    for tag, (case, prec, gap) in _ol_cpu_cases().items():
        k = SolverParams(precision=prec, word_dtype="float64").n_words
        run = _ol_card(_ol_argv(work, case, prec, f"card_{tag}", gap),
                       f"outer_limits {tag}")
        t1 = time.time()
        rc = procs[tag].wait(timeout=900)
        waited = time.time() - t1
        log = (work / "cpu" / f"{tag}.log").read_text()
        if rc != 0:
            raise AssertionError(f"outer_limits {tag} on the CPU exited "
                                 f"{rc}: {log[-2000:]}")
        cpu = json.loads((work / "cpu" / f"{tag}.json").read_text())
        diff, tol = _ol_gap(run["out"], cpu), OL_DEVICE_TOL[case]
        if not diff <= ctx.mpf(tol):
            raise AssertionError(f"outer_limits {tag}: the card's optimal "
                                 f"{run['out']['optimal']} or y "
                                 f"{mpmath.nstr(diff, 5)} from the CPU's "
                                 f"{cpu['optimal']}")
        cpu_seconds = re.findall(r"outer_limits finished in ([0-9.]+)s",
                                 log) or ["?"]
        _ol_report(f"outer_limits {tag} (K = {k}, duality gap threshold "
                   f"{gap}) on the card", run,
                   f"the CPU process {cpu_seconds[-1]} s (waited "
                   f"{waited:.1f} s more), |diff| from it "
                   f"{mpmath.nstr(diff, 5)} (tolerance {tol})")
        runs[f"outer_limits_{tag}"] = run["launches"]

    proc = subprocess.run(
        [py, "-m", "sdpb_tpu_torch.apps.outer_limits",
         *_ol_argv(work, "quickstart", 3000, "card_3000")], cwd=str(REPO),
        env=_port_env(), capture_output=True, text=True, timeout=300)
    if proc.returncode != 2 or "prime pool" not in proc.stderr or \
            "largest precision it takes is" not in proc.stderr:
        raise AssertionError(f"outer_limits --precision 3000 exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    print(f"outer_limits --precision 3000 on the card: exit 2, "
          f"{proc.stderr.strip()}", flush=True)
    phase("9 outer_limits", t)
    return runs


# ---------------------------------------------------------------------------
# Phase 10: several ranks on the one card (parallel/)
# ---------------------------------------------------------------------------

# Phase 10c's shapes: the full-width Q (N = 384) by row panels, and the
# full-width Schur block (240 rows) and a pairing-sized SYRK by rows, at
# --precision 400 (S = 47)
ROWPANEL_N, INTRA_N, INTRA_M, RANK_S = 384, 240, 64, 47
# the row-panel factorization against the dense one (a reordered
# blocking of 400-bit arithmetic on well-conditioned inputs)
ROWPANEL_TOL = 1e-100


def sdpb_rank_child(argv) -> int:
    """Body of phase 10a's ranks (``python -m chip_smoke --sdpb-rank
    <dir> <sdpb argv>``, started by parallel/multihost.py's
    launch_local): the sdpb CLI joining the group from torchrun's
    variables, its standard output in <dir>/rank<RANK>.log and its
    limb-kernel launches in <dir>/launches.<RANK>.json."""
    import contextlib

    from sdpb_tpu_torch.apps import sdpb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    work, rank = Path(argv[0]), os.environ["RANK"]
    lk.reset_launches()
    with open(work / f"rank{rank}.log", "w") as log, \
            contextlib.redirect_stdout(log):
        rc = sdpb.main(argv[1:])
    (work / f"launches.{rank}.json").write_text(json.dumps(dict(lk.LAUNCHES)))
    return rc


def rowpanel_rank_child(argv) -> int:
    """Body of phase 10c's ranks (``python -m chip_smoke --rowpanel-rank
    <dir>``, started by launch_local): the row-panel Cholesky of a
    full-width Q (parallel/dist_q.py) and its solve, the intra-block
    Cholesky of a Schur-sized block and the exact SYRK over its rows
    (parallel/intra.py), against the one-device la.cholesky, solve and
    SYRK on the same card; rank 0 writes <dir>/rowpanel.json."""
    import torch

    from sdpb_tpu_torch.mp import limb
    from sdpb_tpu_torch.mp import linalg as la
    from sdpb_tpu_torch.ops import limb_kernels as lk
    from sdpb_tpu_torch.ops import mpmm
    from sdpb_tpu_torch.parallel import comm as comm_mod
    from sdpb_tpu_torch.parallel import dist_q, intra, multihost

    work = Path(argv[0])
    comm = multihost.maybe_init_distributed()
    try:
        dev = comm.device
        rng = np.random.default_rng(10)          # the same on every rank
        q = spd_limbs(rng, 1, ROWPANEL_N, RANK_S, dev)[0]
        rhs = torch.from_numpy(limb.from_words_np(
            rng.standard_normal((ROWPANEL_N, 1)), RANK_S)).to(dev)
        blk = spd_limbs(rng, 1, INTRA_N, RANK_S, dev)[0]
        x = torch.from_numpy(limb.from_words_np(
            rng.standard_normal((INTRA_N, INTRA_M, 1)), RANK_S)).to(dev)
        out = {"backend": comm.backend, "ranks": comm.world}

        def timed(fn, together=True):
            if together:
                comm.barrier()
            torch.cuda.synchronize()
            t0 = time.time()
            val = fn()
            torch.cuda.synchronize()
            return val, time.time() - t0

        lk.reset_launches()
        l_loc, out["dist_q_cholesky_s"] = timed(
            lambda: dist_q.cholesky_rowpanel(comm, intra.shard_rows(comm, q)))
        sol, out["dist_q_solve_s"] = timed(
            lambda: dist_q.dist_cholesky_solve(comm, l_loc, rhs, ROWPANEL_N))
        b_loc, out["intra_cholesky_s"] = timed(
            lambda: intra.cholesky(comm, intra.shard_rows(comm, blk)))
        sy, out["intra_syrk_s"] = timed(
            lambda: intra.syrk(comm, intra.shard_rows(comm, x)))
        launches = dict(lk.LAUNCHES)
        l_full = intra.gather_rows(comm, l_loc)
        b_full = intra.gather_rows(comm, b_loc)
        names = sorted(launches)
        every = comm.all_gather(torch.tensor(
            [launches[n] for n in names], dtype=torch.int64, device=dev))
        if comm.is_root:
            l_ref, out["dense_q_cholesky_s"] = timed(
                lambda: la.cholesky(q), together=False)
            out["dist_q_cholesky_err"] = abs_rel_err(l_full, l_ref)[1]
            out["dist_q_solve_err"] = abs_rel_err(
                sol, la.cholesky_solve(l_ref, rhs))[1]
            out["intra_cholesky_err"] = abs_rel_err(b_full,
                                                    la.cholesky(blk))[1]
            plan = mpmm.plan_for(mpmm.precision_of(x.dtype, RANK_S), INTRA_N)
            out["intra_syrk_same_bits"] = same_bits(
                sy, mpmm.syrk_mp_batched(x, plan))
            out["launches_by_rank"] = [dict(zip(names, row))
                                       for row in every.cpu().tolist()]
            (work / "rowpanel.json").write_text(json.dumps(out))
    finally:
        comm_mod.destroy(comm)
    return 0


def _launch_ranks(argv, n=2):
    """``python -m chip_smoke <argv>`` as n ranks on this card through
    parallel/multihost.py's launch_local (torchrun's variables; more
    ranks than cards, so gloo); its exit code and seconds."""
    from sdpb_tpu_torch.parallel import multihost

    os.environ["PYTHONPATH"] = (str(REPO) + os.pathsep
                                + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    rc = multihost.launch_local("chip_smoke", argv, n)
    return rc, time.time() - t0


def _require_rank_launches(label, by_rank):
    for rank, launches in enumerate(by_rank):
        for name in ("cholesky_unblocked_batched", "solve_unblocked_batched"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{label}: rank {rank} never launched "
                                     f"{name}: {launches}")


# Phase 10a's depth: the 1d SDP over 2 ranks for this many iterations
# (of the 160 phase 4 takes to PrimalDualOptimal), each iteration's mu,
# objectives and gap within 1e-30 (relative) of phase 4's, as the whole
# solve's objectives were.
RANKS_1D_ITERATIONS = 20
RANKS_1D_FIELDS = ("mu", "P-obj", "D-obj", "gap")


def phase_ranks(dev, out_root: Path, full):
    """Phase 10: (a) the 1d SDP through the sdpb CLI as two ranks sharing
    the card over gloo for RANKS_1D_ITERATIONS iterations, against phase
    4's one-device solve; (b) a full-width iteration through
    parallel/mesh.py as a world of one over NCCL, against phase 5's; (c)
    the row-panel (dist_q) and intra-block factorizations on two ranks
    sharing the card, against the dense ones.  Every rank must launch
    both limb kernels."""
    t = time.time()
    import torch

    from sdpb_tpu_torch.ops import limb_kernels as lk
    from sdpb_tpu_torch.parallel import comm as comm_mod
    from sdpb_tpu_torch.parallel import mesh, multihost
    from sdpb_tpu_torch.solver import driver, synthetic
    from sdpb_tpu_torch.solver.params import SolverParams

    work = out_root / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = {}

    # (a)
    sdp = REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
    rc, cli_s = _launch_ranks(
        ["--sdpb-rank", str(work), "-s", str(sdp), "-o", str(work / "out"),
         "-c", str(work / "ck"), "--precision", "212",
         "--maxIterations", str(RANKS_1D_ITERATIONS),
         "--noFinalCheckpoint"])
    if rc != 0:
        raise AssertionError(f"sdpb over 2 ranks exited {rc}: "
                             f"{(work / 'rank0.log').read_text()[-2000:]}")
    log0 = (work / "rank0.log").read_text().splitlines()
    backend = next(x for x in log0 if "rank(s) over" in x)
    reason = next(line.partition("=")[2].strip().rstrip(";")
                  for line in (work / "out" / "out.txt").read_text()
                  .splitlines() if line.startswith("terminateReason"))
    got = _records(work / "out" / "iterations.json")
    want = _records(out_root / "quickstart_out" / "iterations.json")
    if reason != '"maxIterations exceeded"' or \
            len(got) != RANKS_1D_ITERATIONS:
        raise AssertionError(f"2 ranks ended {reason} after {len(got)} "
                             f"iterations")
    worst = 0.0
    for g, w in zip(got, want):
        for key in RANKS_1D_FIELDS:
            r = _rel(g[key], w[key])
            worst = max(worst, r)
            if not r <= 1e-30:
                raise AssertionError(f"2 ranks' iteration {g['iteration']} "
                                     f"{key} {g[key]} vs phase 4's {w[key]}")
    by_rank = [json.loads((work / f"launches.{r}.json").read_text())
               for r in range(2)]
    _require_rank_launches("10a", by_rank)
    print(f"10a sdpb CLI, {backend.strip()}: {reason} after "
          f"{len(got)} iterations, {cli_s:.1f} s wall (processes "
          f"included), each iteration's {', '.join(RANKS_1D_FIELDS)} "
          f"within {worst:.3e} (relative) of phase 4's, launches by rank "
          f"{by_rank}", flush=True)
    for r, launches in enumerate(by_rank):
        paths[f"ranks_cli_rank{r}"] = launches

    # (b)
    comm = comm_mod.init_process_group(
        0, 1, dev, f"file://{work / 'nccl_store'}", "nccl")
    try:
        params = SolverParams(precision=400, max_iterations=1)
        host, _ = synthetic.build_problem(params, device="cpu")
        mproblem = mesh.shard_problem(host, comm)
        lk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        result = driver.solve(mproblem, params)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = dict(lk.LAUNCHES)
    finally:
        comm_mod.destroy(comm)
    if len(result.iterations) != 1:
        raise AssertionError(f"10b ran {len(result.iterations)} iterations")
    _require_rank_launches("10b", [launches])
    first, want = result.iterations[0], full["first"]
    off = max(_rel(getattr(first, f), getattr(want, f))
              for f in ("mu", "primal_objective", "dual_objective",
                        "duality_gap", "beta_corrector"))
    if not off <= 1e-30:
        raise AssertionError(f"10b's first iteration off phase 5's by {off}")
    print(f"10b mesh, world of 1 over {comm.backend}: 1 full-width "
          f"iteration in {seconds:.2f} s "
          f"({[round(r.iter_time, 3) for r in result.iterations]} s each; "
          f"phase 5 {full['s_per_it']:.2f} s/iteration), first iteration "
          f"within {off:.3e} of phase 5's, launches {launches}", flush=True)
    paths["ranks_mesh_nccl"] = launches

    # (c)
    rc, rp_s = _launch_ranks(["--rowpanel-rank", str(work)])
    if rc != 0:
        raise AssertionError(f"the row-panel ranks exited {rc}")
    rp = json.loads((work / "rowpanel.json").read_text())
    _require_rank_launches("10c", rp["launches_by_rank"])
    bad = {k: rp[k] for k in ("dist_q_cholesky_err", "dist_q_solve_err",
                              "intra_cholesky_err")
           if not rp[k] <= ROWPANEL_TOL}
    if bad or not rp["intra_syrk_same_bits"]:
        raise AssertionError(f"10c against the dense routes: {bad}, SYRK "
                             f"bits {rp['intra_syrk_same_bits']}")
    print(f"10c row panels over {rp['ranks']} ranks ({rp['backend']}), "
          f"{rp_s:.1f} s wall: " + json.dumps(
              {k: v for k, v in rp.items() if k != "launches_by_rank"}),
          flush=True)
    for r, launches in enumerate(rp["launches_by_rank"]):
        paths[f"ranks_rowpanel_rank{r}"] = launches
    phase("10 several ranks", t)
    return paths


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
    """One record per kernel and design: its main shape's times and
    bound, ``launches`` from its path (phase 5's full-width iteration for
    the limb kernels; for the expansion kernels phase 8b's, and for the
    value-a-warp designs phase 8c's --precision 1200 run), and each
    path's launches beside them."""
    meta = {
        "cholesky_unblocked_batched": "sdpb_tpu/ops/limb_kernels.py:251",
        "solve_unblocked_batched": "sdpb_tpu/ops/limb_kernels.py:180",
        "limb_add": "sdpb_tpu/mp/limb.py:499",
        "limb_mul": "sdpb_tpu/mp/limb.py:532",
        "limb_div": "sdpb_tpu/mp/limb.py:670",
        "exp_add": "sdpb_tpu/mp/core.py:422",
        "exp_add_f64": "sdpb_tpu/mp/core.py:446",
        "exp_mul": "sdpb_tpu/mp/core.py:487",
        "exp_mul_f64": "sdpb_tpu/mp/core.py:516",
        "exp_div": "sdpb_tpu/mp/core.py:558",
        "exp_cholesky_panel": "sdpb_tpu/mp/linalg.py:207",
        "exp_solve_unblocked": "sdpb_tpu/mp/linalg.py:354",
    }
    sources = {"cholesky_unblocked_batched": "sdpb_tpu_torch/csrc/limb_chol.cu",
               "solve_unblocked_batched": "sdpb_tpu_torch/csrc/limb_solve.cu",
               "limb_add": "sdpb_tpu_torch/csrc/limb_elementwise.cu",
               "limb_mul": "sdpb_tpu_torch/csrc/limb_elementwise.cu",
               "limb_div": "sdpb_tpu_torch/csrc/limb_elementwise.cu",
               "exp_cholesky_panel": "sdpb_tpu_torch/csrc/expansion_chol.cu",
               "exp_solve_unblocked":
                   "sdpb_tpu_torch/csrc/expansion_solve.cu"}
    out = []
    for name, recs in rows.items():
        base = name.removesuffix("_warp")
        rec = max((r for r in recs if r["main"]), key=lambda r: r["ops"])
        bound, bound_by = bound_ms(rec["bytes"], rec["ops"],
                                   rec.get("peak", PEAK_F32_PER_S))
        if base not in EXP_KERNELS:
            path = "full_width"
        elif name.endswith("_warp"):
            path = f"exp_approx_objective_{WIDE_PRECISIONS[0]}"
        else:
            path = "exp_full_width"
        out.append({
            "name": name, "route": "cuda",
            "source": sources.get(
                base, "sdpb_tpu_torch/csrc/expansion_elementwise.cu"),
            "replaces": meta[base], "launches": paths[path].get(name, 0),
            "max_abs_err": max(r["err"] for r in recs),
            "ms": rec["ms"], "device_ms": rec.get("device_ms"),
            "plain_ms": rec["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "shape": rec["shape"],
            "design": rec.get("design"), "launches_path": path,
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
    cpu_jobs = start_cpu_approx(out_root)
    ol_jobs = start_cpu_outer_limits(out_root)
    try:
        rows = phase_kernels(dev)
        paths = {"1d": phase_1d(dev, out_root)}
        paths["full_width"], full_mem = phase_full(dev)
        paths["cli_2048"] = phase_frontend(dev, out_root)
        paths["n_1024"], large_mem = phase_large(dev)
        exp_paths, exp_mem = phase_expansion(dev, out_root, full_mem,
                                             cpu_jobs)
        phase_outer_limits(dev, out_root, ol_jobs)
        paths.update(phase_ranks(dev, out_root, full_mem))
    finally:
        for proc in [*cpu_jobs[1].values(), *ol_jobs[1].values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    paths.update(exp_paths)
    check_memory_estimates([full_mem, large_mem, exp_mem])
    print(card, flush=True)
    print(json.dumps(kernel_json(rows, paths)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sdpb-rank"]:
        sys.exit(sdpb_rank_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--rowpanel-rank"]:
        sys.exit(rowpanel_rank_child(sys.argv[2:]))
    sys.exit(main())
