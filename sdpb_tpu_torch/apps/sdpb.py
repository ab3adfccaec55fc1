"""`sdpb` CLI of the port: solve an SDP directory on one CUDA device in
the base-2^9 limb format, or on the CPU in the float64-expansion format
(--device cpu), with the JAX package's flags and contract.

    python -m sdpb_tpu_torch.apps.sdpb -s <sdp dir> [-o <out dir>] \\
        [-c <checkpoint dir>] --precision 400

Outputs: out.txt, y.txt, x_<i>.txt (per --writeSolution),
iterations.json and c_minus_By/c_minus_By.json; in the checkpoint
directory (default <sdpDir sibling>/ck) a checkpoint every
--checkpointInterval seconds, on SIGTERM (then exit 143) and at the end
unless --noFinalCheckpoint, and block_timings after every solve.  A run
restarts from -i, or from an existing ck/checkpoint.json.  The memory
estimate is checked against the device's free memory before anything is
allocated there (exit 1 over it).  --precision is refused at startup
(exit 2, naming the limit) above what the CRT prime pool
(ops/exact.py) holds for the SDP's sizes, ~2800 bits, in either
format, and on the card above the limb kernels' largest slot class
(ops/limb_kernels.py).

Not in this port yet (exit 2, naming the missing module): multi-device
solves (parallel/, with the intra-block fallback).
"""

from __future__ import annotations

import argparse
import pathlib
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdpb", description="SDPB on one CUDA device: "
        "arbitrary-precision SDP solver for polynomial matrix programs")
    p.add_argument("-s", "--sdpDir", required=True,
                   help="Directory (or .zip) containing the SDP")
    p.add_argument("-o", "--outDir", default=None,
                   help="Output directory (default: <sdpDir sibling>/out)")
    p.add_argument("-p", "--precision", type=int, default=400,
                   help="Binary precision (bits); at most what the CRT "
                        "prime pool holds for the SDP (~2800)")
    p.add_argument("--maxIterations", type=int, default=500)
    p.add_argument("--maxRuntime", type=float, default=2 ** 53)
    p.add_argument("--checkpointInterval", type=float, default=3600,
                   help="Seconds between checkpoints")
    p.add_argument("--maxSharedMemory", default="0",
                   help="Byte cap (optional K/M/G suffix) on the Q residue "
                        "buffers: the exact integer SYRK is tiled into "
                        "block chunks that fit under it. 0 = no cap. The "
                        "total allocation is checked separately against "
                        "the device's free memory at startup.")
    p.add_argument("--dualityGapThreshold", default="1e-30")
    p.add_argument("--primalErrorThreshold", default="1e-30")
    p.add_argument("--dualErrorThreshold", default="1e-30")
    p.add_argument("--initialMatrixScalePrimal", default="1e20")
    p.add_argument("--initialMatrixScaleDual", default="1e20")
    p.add_argument("--feasibleCenteringParameter", default="0.1")
    p.add_argument("--infeasibleCenteringParameter", default="0.3")
    p.add_argument("--stepLengthReduction", type=float, default=0.7)
    p.add_argument("--minPrimalStep", default="0")
    p.add_argument("--minDualStep", default="0")
    p.add_argument("--maxComplementarity", default="1e100")
    p.add_argument("--findPrimalFeasible", action="store_true")
    p.add_argument("--findDualFeasible", action="store_true")
    p.add_argument("--detectPrimalFeasibleJump", action="store_true")
    p.add_argument("--detectDualFeasibleJump", action="store_true")
    p.add_argument("--writeSolution", default="x,y",
                   help="Comma-separated subset of x,y,z,X,Y")
    p.add_argument("--noFinalCheckpoint", action="store_true")
    p.add_argument("-c", "--checkpointDir", default=None)
    p.add_argument("-i", "--initialCheckpointDir", default=None)
    p.add_argument("--verbosity", type=int, default=1,
                   help="0=none, 1=regular, 2=debug, 3=trace")
    p.add_argument("--device", default="auto",
                   choices=["auto", "cuda", "tpu", "cpu"],
                   help="auto/cuda (tpu is accepted as its alias): the "
                        "limb format on the CUDA device. cpu: the "
                        "float64-expansion format on the CPU")
    p.add_argument("--procsPerNode", type=int, default=None,
                   help="[OBSOLETE] determined automatically")
    p.add_argument("--procGranularity", type=int, default=None,
                   help="[OBSOLETE]")
    return p


def _missing(what: str, module: str) -> int:
    print(f"sdpb: {what} needs {module}, which this port does not have "
          "yet", file=sys.stderr)
    return 2


def main(argv=None, device=None) -> int:
    """CLI entry point.  ``device`` (a torch device or name) overrides
    --device and keeps the limb format; tests pass "cpu" to run the limb
    path on CPU tensors.  Without it, --device cpu solves in float64
    expansions on the CPU (as sdpb_tpu's --device cpu does) and any
    other --device in limbs on the CUDA device."""
    args = build_parser().parse_args(argv)
    import torch

    from ..ops.limb_kernels import MAX_SLOTS, max_precision_bits

    word_dtype = "float32"
    if device is None and args.device == "cpu":
        device, word_dtype = "cpu", "float64"
    if word_dtype == "float32" and args.precision > max_precision_bits():
        print(f"sdpb: --precision {args.precision} needs more than the "
              f"{MAX_SLOTS} slots of the largest kernel class, which holds "
              f"{max_precision_bits()} bits; the CRT prime pool holds less "
              f"(~2800 bits, the limit named once the SDP is read)",
              file=sys.stderr)
        return 2
    sdp_dir = pathlib.Path(args.sdpDir)
    out_dir = pathlib.Path(args.outDir) if args.outDir else \
        sdp_dir.parent / "out"
    ck_dir = pathlib.Path(args.checkpointDir) if args.checkpointDir else \
        sdp_dir.parent / "ck"
    if device is None:
        from ..device import resolve_device

        device = resolve_device(None)
        if torch.cuda.device_count() > 1:
            return _missing(
                f"{torch.cuda.device_count()} visible CUDA devices "
                "(multi-device solves; make one visible with "
                "CUDA_VISIBLE_DEVICES)", "parallel/")
    device = torch.device(device)

    from ..io import output as out_io
    from ..io.sdp_json import read_sdp
    from ..solver import placement
    from ..solver.checkpoint import load_checkpoint, save_checkpoint
    from ..solver.data import bucketed_problem_from_raw
    from ..solver.driver import NonFiniteIterateError, solve
    from ..solver.memory import (MemoryLimitError, check_memory_limit,
                                 crt_rows, max_crt_precision, shape_of_raw)
    from ..solver.params import SolverParams
    from ..utils.timers import Timers, Verbosity, rotate_profiling_dir

    params = SolverParams(
        precision=args.precision,
        max_iterations=args.maxIterations,
        max_runtime=args.maxRuntime,
        checkpoint_interval=args.checkpointInterval,
        duality_gap_threshold=args.dualityGapThreshold,
        primal_error_threshold=args.primalErrorThreshold,
        dual_error_threshold=args.dualErrorThreshold,
        initial_matrix_scale_primal=args.initialMatrixScalePrimal,
        initial_matrix_scale_dual=args.initialMatrixScaleDual,
        feasible_centering_parameter=args.feasibleCenteringParameter,
        infeasible_centering_parameter=args.infeasibleCenteringParameter,
        step_length_reduction=args.stepLengthReduction,
        min_primal_step=args.minPrimalStep,
        min_dual_step=args.minDualStep,
        max_complementarity=args.maxComplementarity,
        find_primal_feasible=args.findPrimalFeasible,
        find_dual_feasible=args.findDualFeasible,
        detect_primal_feasible_jump=args.detectPrimalFeasibleJump,
        detect_dual_feasible_jump=args.detectDualFeasibleJump,
        max_shared_memory=str(args.maxSharedMemory),
        word_dtype=word_dtype,
    )

    t_start = time.time()
    raw = read_sdp(sdp_dir, k=params.n_read_words)
    shape = shape_of_raw(raw, params.n_words, params.dtype)
    limit = max_crt_precision(
        lambda p: SolverParams(precision=p, word_dtype=word_dtype).n_words,
        params.dtype, crt_rows(shape))
    if args.precision > limit:
        print(f"sdpb: --precision {args.precision} needs a larger CRT "
              f"modulus than the prime pool (ops/exact.py) holds for this "
              f"SDP; the largest precision it takes is {limit}",
              file=sys.stderr)
        return 2
    # fail fast, before anything is allocated on the device
    # (`run.cxx:80-183`)
    try:
        check_memory_limit(shape,
                           device=device,
                           verbose=args.verbosity >= 2,
                           q_bytes_cap=args.maxSharedMemory)
    except MemoryLimitError as e:
        print(f"sdpb: {e}", file=sys.stderr)
        return 1
    problem = bucketed_problem_from_raw(raw, params.n_words, device,
                                        params.dtype)
    if args.verbosity >= 1:
        dims = sum(bk.nb * bk.shape.schur_size for bk in problem.buckets)
        print(f"SDPB (PyTorch, {device}, {word_dtype} words) started at "
              f"{time.strftime('%Y-%m-%d %H:%M:%S')}")
        print(f"SDP directory   : {sdp_dir}")
        print(f"out directory   : {out_dir}")
        print(f"\tprimal dimension: {dims}\n"
              f"\tdual dimension: {problem.dual_dim}\n"
              f"\tSDP blocks: {problem.num_blocks}", flush=True)

    state = None
    if args.initialCheckpointDir or (ck_dir / "checkpoint.json").exists():
        ck_in = pathlib.Path(args.initialCheckpointDir or ck_dir)
        state = load_checkpoint(ck_in, problem, params)
        if state is not None and args.verbosity >= 1:
            print(f"Loaded checkpoint from {ck_in}", flush=True)

    # SIGTERM drain (`Environment.cxx:12-18`, `run.cxx:330-360`)
    sigterm = {"flag": False}

    def _on_sigterm(signum, frame):
        sigterm["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    it_writer = out_io.IterationsJsonWriter(out_dir / "iterations.json")
    last_ck = {"t": time.time()}

    def hook(rec, cur_state):
        it_writer.write(rec, total_time=time.time() - t_start)
        if args.verbosity >= 1:
            print(f"it {rec.iteration:3d} mu={float(rec.mu):.3e} "
                  f"gap={float(rec.duality_gap):.3e} "
                  f"steps=({rec.primal_step:.4f},{rec.dual_step:.4f})",
                  flush=True)
        if time.time() - last_ck["t"] >= params.checkpoint_interval:
            save_checkpoint(ck_dir, cur_state, problem, params)
            last_ck["t"] = time.time()
        if sigterm["flag"]:
            # drain: checkpoint the iterate, then unwind
            save_checkpoint(ck_dir, cur_state, problem, params)
            raise KeyboardInterrupt("SIGTERM")

    timers = Timers(Verbosity(min(args.verbosity, 3)))
    try:
        with timers.scoped("sdpb.solve"):
            result = solve(problem, params, state=state, iteration_hook=hook,
                           timers=timers)
    except NonFiniteIterateError as e:
        print(f"sdpb: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        if args.verbosity >= 1:
            print("SIGTERM received; checkpoint written", flush=True)
        return 143
    finally:
        it_writer.close()
        signal.signal(signal.SIGTERM, old_handler)

    placement.write_flop_model_timings(ck_dir, problem)
    if args.verbosity >= 2:
        prof_dir = rotate_profiling_dir(
            ck_dir.parent / (ck_dir.name + ".profiling"))
        timers.write_profile(prof_dir / "profiling.0")
    runtime = int(time.time() - t_start)
    if not args.noFinalCheckpoint:
        save_checkpoint(ck_dir, result.state, problem, params)
    out_io.save_solution(out_dir, result, problem, runtime,
                         write_solution=args.writeSolution,
                         normalization=raw.normalization)
    out_io.save_c_minus_By(out_dir / "c_minus_By" / "c_minus_By.json",
                           problem, result.state.y)
    if args.verbosity >= 1:
        print(f"terminateReason = \"{result.reason.value}\"")
        print(f"primalObjective = {result.primal_objective[:50]}...")
        print(f"Solver runtime  = {runtime}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
