"""Smoke test of the PyTorch/CUDA port (sdpb_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its name and elapsed seconds:
  1. environment: card name and power limit, torch/CUDA versions, mpmath
  2. build: the limb kernels with nvcc, one process per unit (the
     -Xptxas -v lines printed, and registers, stack frame and spills
     per factorization kernel)
  3. kernels against their plain PyTorch versions, bit for bit: the
     factorization kernels at the full-width shapes (S = 47, 400 bits)
     and at S = 26 (--precision 212), S = 116 (--precision 1024),
     n = 64 and n = 7; the elementwise kernels at S = 47; CUDA-event
     times
  4. the 1d quickstart SDP end to end through the sdpb CLI entry point
     at the stock contract (--precision 212): PrimalDualOptimal and the
     known objective
  5. the full-width synthetic problem (bench.py's build_problem: 48+16
     blocks, Schur 96/240, N = 384, 400 bits) for 2 solver iterations

The line before the last is one JSON object with a record per kernel;
the last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import re
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
    t = time.time()
    from sdpb_tpu_torch.ops import limb_kernels as lk

    info = lk.build(force=True)
    print(f"nvcc build {info['seconds']:.1f} s -> "
          f"{Path(info['library']).name}", flush=True)
    for line in info["ptxas"]:
        print(f"  ptxas: {line}", flush=True)
    for name, res in _ptxas_resources(info["ptxas"]).items():
        print(f"  {name}: {json.dumps(res)}", flush=True)
    lk._lib()
    phase("2 build", t)


def _ptxas_resources(lines):
    """Registers, stack frame and spill bytes per factorization kernel
    instantiation, read from the -Xptxas -v lines."""
    out, cur = {}, None
    for line in lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"(chol_warp|solve_warp)_kernelILi(\d+)ELi(\d+)E",
                          m.group(1))
            cur = f"{k.group(1)}_kernel<{k.group(2)},{k.group(3)}>" \
                if k else None
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
# (--precision 1024), n = 64 (the largest unblocked n) and an odd n.
CHOL_SHAPES = ((48, 32, 47), (16, 48, 47), (1, 32, 47), (4, 32, 26),
               (2, 32, 116), (2, 64, 47), (1, 64, 116), (8, 7, 47))
SOLVE_SHAPES = ((272, 32, 32, 47), (48, 32, 96, 47), (1, 32, 384, 47),
                (4, 32, 16, 26), (2, 32, 24, 116), (2, 64, 40, 47),
                (1, 64, 8, 116), (5, 7, 9, 47))
FULL_WIDTH = 3


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
        want = lk.cholesky_unblocked_plain(a)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"cholesky ({bb},{n},{n},{S}) differs from "
                                 f"its plain version (abs, rel err "
                                 f"{abs_rel_err(got, want)})")
        ms = cuda_ms(lambda: lk.cholesky_unblocked_batched(a), 5)
        plain_ms = cuda_ms(lambda: lk.cholesky_unblocked_plain(a), 1)
        print(f"cholesky ({bb},{n},{n},{S}): bit-exact  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms", flush=True)
        rows.setdefault("cholesky_unblocked_batched", []).append(
            dict(shape=[bb, n, n, S], err=0.0, ms=ms, plain_ms=plain_ms,
                 bytes=2 * a.numel() * 4, main=idx < FULL_WIDTH,
                 ops=_chol_ops(bb, n, L, limb.newton_steps(L))))
    for S in (47, 116):
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
            want = lk.solve_unblocked_plain(lfac, b, inv_d, transpose)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(
                    f"solve ({bb},{n},{m},{S}) transpose={transpose} "
                    f"differs from its plain version (abs, rel err "
                    f"{abs_rel_err(got, want)})")
            ms = cuda_ms(lambda: lk.solve_unblocked_batched(
                lfac, b, inv_d, transpose), 5)
            plain_ms = cuda_ms(lambda: lk.solve_unblocked_plain(
                lfac, b, inv_d, transpose), 1)
            print(f"solve ({bb},{n},{n})x{m} S={S} T={int(transpose)}: "
                  f"bit-exact  tile {geo['tm']} blocks {geo['blocks']}  "
                  f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
            rows.setdefault("solve_unblocked_batched", []).append(
                dict(shape=[bb, n, m, S, int(transpose)], err=0.0, ms=ms,
                     plain_ms=plain_ms, main=idx < FULL_WIDTH,
                     bytes=(lfac.numel() + 2 * b.numel() + inv_d.numel()) * 4,
                     ops=_solve_ops(bb, n, m, L)))
    rows.update(_elementwise_checks(dev, rng, 47))
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


def _elementwise_checks(dev, rng, S, n=48 * 32 * 32):
    """limb_add/mul/div against their plain versions, bit for bit, at
    the size of one full-width trailing update (48 x 32 x 32 values)."""
    import torch

    from sdpb_tpu_torch.mp import limb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    L = S - 1
    a = _random_limbs(rng, n, S, dev)
    b = _random_limbs(rng, n, S, dev)
    # float additions / the convolution's multiply-adds / the L + 2
    # quotient digits' multiply-subtracts; carry passes not counted
    per_op = {"limb_add": L, "limb_mul": _mul_flops(L),
              "limb_div": (L + 2) * 2 * L}
    rows = {}
    for name, kern, plain in (("limb_add", lk.limb_add, limb.add_plain),
                              ("limb_mul", lk.limb_mul, limb.mul_plain),
                              ("limb_div", lk.limb_div, limb.div_plain)):
        got = kern(a, b)
        want = plain(a, b)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            bad = (got.nan_to_num(0.0) != want.nan_to_num(0.0)).any(-1)
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at {i}: {got[i].tolist()} vs "
                                 f"{want[i].tolist()}")
        ms = cuda_ms(lambda: kern(a, b), 5)
        plain_ms = cuda_ms(lambda: plain(a, b), 2)
        print(f"{name} ({n},{S}): bit-exact  kernel {ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms", flush=True)
        rows[name] = [dict(shape=[n, S], err=0.0, ms=ms, plain_ms=plain_ms,
                           bytes=3 * n * S * 4, ops=n * per_op[name],
                           main=True)]
    return rows


def phase_1d(dev, out_root: Path):
    t = time.time()
    from sdpb_tpu_torch.apps import sdpb
    from sdpb_tpu_torch.ops import limb_kernels as lk

    sdp = REPO / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"
    out = out_root / "quickstart_out"
    lk.reset_launches()
    rc = sdpb.main(["-s", str(sdp), "-o", str(out), "--precision", "212",
                    "--noFinalCheckpoint", "--verbosity", "0"])
    launches = dict(lk.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"sdpb exited {rc}")
    fields = {}
    for line in (out / "out.txt").read_text().splitlines():
        key, _, val = line.partition("=")
        fields[key.strip()] = val.strip().rstrip(";")
    import mpmath

    mpmath.mp.prec = 256
    obj = mpmath.mpf(fields["primalObjective"])
    dev_obj = abs(obj - mpmath.mpf("1.8402657631320492"))
    print(f"1d: {fields['terminateReason']} primalObjective "
          f"{fields['primalObjective'][:40]} |diff| "
          f"{mpmath.nstr(dev_obj, 5)} launches {launches}", flush=True)
    if fields["terminateReason"] != '"found primal-dual optimal solution"':
        raise AssertionError(f"1d ended {fields['terminateReason']}")
    if not dev_obj <= mpmath.mpf("1e-15"):
        raise AssertionError(f"1d primalObjective off by {dev_obj}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"1d did not launch every kernel: {launches}")
    _check_1d_trajectory(out / "iterations.json")
    phase("4 1d end to end", t)
    return launches


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


def phase_full(dev, iterations=2):
    t = time.time()
    import torch

    from sdpb_tpu_torch.ops import limb_kernels as lk
    from sdpb_tpu_torch.solver import driver, synthetic
    from sdpb_tpu_torch.solver.params import SolverParams
    from sdpb_tpu_torch.utils.timers import Timers

    params = SolverParams(precision=400, max_iterations=iterations)
    problem, state = synthetic.build_problem(params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    print(f"full width max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"launches {launches}", flush=True)
    if n_it < iterations:
        raise AssertionError(f"full width ran {n_it} iterations")
    if min(launches.values()) <= 0:
        raise AssertionError(f"full width missed a kernel: {launches}")
    _profile_iteration(problem, state, seconds / n_it)
    phase("5 full width", t)
    return launches


# Device kernels by what launched them: the port's own CUDA kernels, the
# integer elementwise glue (CRT digits and residues, limb exponents),
# library matrix products, and the rest (float glue, copies).
LIMB_KERNELS = (
    ("cholesky_unblocked_batched", r"\(anonymous namespace\)::chol_warp_kernel<"),
    ("solve_unblocked_batched", r"\(anonymous namespace\)::solve_warp_kernel<"),
    ("limb_elementwise", r"\(anonymous namespace\)::elementwise_kernel\("),
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


def kernel_json(rows, launches):
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
        t_bytes = rec["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = rec["ops"] / PEAK_F32_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda",
            "source": sources[name],
            "replaces": meta[name], "launches": launches.get(name, 0),
            "max_abs_err": max(r["err"] for r in recs),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": rec["shape"]})
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
    phase_1d(dev, out_root)
    launches = phase_full(dev)
    print(card, flush=True)
    print(json.dumps(kernel_json(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
