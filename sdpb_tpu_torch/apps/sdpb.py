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

Several devices: one process (rank) per GPU over torch.distributed
(parallel/).  Started plainly with more than one visible GPU, sdpb
starts one rank per GPU itself and forwards SIGTERM to them; under
torchrun (``torchrun --nproc-per-node=<gpus> -m sdpb_tpu_torch.apps.sdpb
...``) or the SDPB_COORDINATOR / SDPB_NUM_PROCESSES / SDPB_PROCESS_ID
variables (one process per GPU, parallel/multihost.py) each process
joins the group.  The blocks are sharded over the ranks by cost (Q
distributed by row panels once it crowds a device); a problem over the
memory limit whose blocks fit when sharded by rows takes the
intra-block path instead of exit 1.  Rank 0 alone writes the outputs,
checkpoints and block_timings, from the gathered state; a checkpoint
of any world size restarts into any other (the intra-block path starts
cold).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    from ..parallel import comm as comm_mod
    from ..parallel import multihost

    if device is None and multihost.env_config() is None:
        from ..device import resolve_device

        resolve_device(None)
        if torch.cuda.device_count() > 1:
            return multihost.launch_local(
                "sdpb_tpu_torch.apps.sdpb",
                sys.argv[1:] if argv is None else list(argv),
                torch.cuda.device_count())
    comm = multihost.maybe_init_distributed(device)
    own_group = comm is not None
    if comm is None:
        from ..device import resolve_device

        comm = comm_mod.Comm.local(resolve_device(device))
    try:
        return _run(args, params_of(args, word_dtype), comm, sdp_dir,
                    out_dir, ck_dir)
    finally:
        if own_group:
            comm_mod.destroy(comm)


def params_of(args, word_dtype: str):
    from ..solver.params import SolverParams

    return SolverParams(
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


class _NullWriter:
    def write(self, *a, **kw):
        pass

    def close(self):
        pass


def _run(args, params, comm, sdp_dir, out_dir, ck_dir) -> int:
    """The solve on ``comm``'s ranks (a local Comm: one device)."""
    import os

    import torch

    device = comm.device
    word_dtype = params.word_dtype
    rank0 = comm.is_root
    say = args.verbosity >= 1 and rank0

    from ..io import output as out_io
    from ..io.sdp_json import read_sdp
    from ..parallel import intra_solver, mesh
    from ..parallel.multihost import broadcast_from_root, broadcast_state
    from ..solver import placement
    from ..solver.checkpoint import load_checkpoint, save_checkpoint
    from ..solver.data import bucketed_problem_from_raw, problem_from_raw
    from ..solver.driver import NonFiniteIterateError, solve
    from ..solver.memory import (MemoryLimitError, check_memory_limit,
                                 crt_rows, detect_device_memory,
                                 intra_would_fit, max_crt_precision,
                                 shape_of_raw)
    from ..solver.params import SolverParams
    from ..utils import timers as tracing
    from ..utils.timers import Timers, Verbosity, rotate_profiling_dir

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
    if comm.active and say:
        print(f"{comm.world} rank(s) over {comm.backend}", flush=True)
    # fail fast, before anything is allocated on the device
    # (`run.cxx:80-183`); every rank takes the same route
    over = None
    try:
        check_memory_limit(shape, device=device, n_devices=comm.world,
                           verbose=args.verbosity >= 2 and rank0,
                           q_bytes_cap=args.maxSharedMemory)
    except MemoryLimitError as e:
        over = e
    use_intra = False
    if comm.any_(over is not None):
        mem = os.environ.get("SDPB_TPU_DEVICE_MEMORY") or \
            detect_device_memory(device)
        fits = comm.world > 1 and intra_would_fit(shape, mem, comm.world)
        if comm.any_(not fits):
            if rank0:
                print(f"sdpb: {over or 'another rank is over its limit'}",
                      file=sys.stderr)
            return 1
        use_intra = True
        if say:
            print(f"memory: blocks exceed one device; using intra-block "
                  f"row sharding over {comm.world} ranks", flush=True)

    sharded = comm.world > 1
    host_dev = "cpu" if sharded else device
    host_problem = bucketed_problem_from_raw(raw, params.n_words, host_dev,
                                             params.dtype)
    problem = host_problem
    if use_intra:
        problem = intra_solver.IntraProblem(
            problem_from_raw(raw, device, params.dtype, params.n_words),
            comm)
    elif sharded:
        # rank 0 reads the costs, so that every rank places the blocks
        # alike (on several hosts the directories need not be shared)
        costs = torch.zeros(host_problem.num_blocks, dtype=torch.float64)
        if rank0:
            costs = torch.as_tensor(placement.read_block_costs(
                ck_dir, sdp_dir, host_problem.num_blocks,
                problem=host_problem), dtype=torch.float64)
        costs = broadcast_from_root(comm, costs).numpy()
        problem = mesh.shard_problem(
            host_problem, comm,
            costs=[[costs[j] for j in bk.block_indices]
                   for bk in host_problem.buckets])
        if say:
            loads = placement.bucket_loads(host_problem, costs, comm.world)
            print(f"sharding blocks over {comm.world} ranks (imbalance "
                  f"{placement.imbalance(loads):.3f})", flush=True)
    if say:
        dims = sum(bk.nb * bk.shape.schur_size
                   for bk in host_problem.buckets)
        print(f"SDPB (PyTorch, {device}, {word_dtype} words) started at "
              f"{time.strftime('%Y-%m-%d %H:%M:%S')}")
        print(f"SDP directory   : {sdp_dir}")
        print(f"out directory   : {out_dir}")
        print(f"\tprimal dimension: {dims}\n"
              f"\tdual dimension: {host_problem.dual_dim}\n"
              f"\tSDP blocks: {host_problem.num_blocks}", flush=True)

    def host_state(st):
        """The whole state in block order (collective when sharded)."""
        if use_intra:
            return intra_solver.to_bucketed_state(problem, st,
                                                  host_problem.buckets)
        if sharded:
            return mesh.unshard_state(st, problem)
        return st

    # what rank 0 sees and reads, on every rank
    state = None
    has_ck = bool(broadcast_from_root(comm, torch.tensor([int(
        bool(args.initialCheckpointDir)
        or (ck_dir / "checkpoint.json").exists())], dtype=torch.int32))[0])
    if has_ck and use_intra:
        if rank0:
            print("sdpb: checkpoint restart into the intra-block path is "
                  "not supported yet; starting cold", file=sys.stderr)
    elif has_ck:
        ck_in = pathlib.Path(args.initialCheckpointDir or ck_dir)
        state = load_checkpoint(ck_in, host_problem, params) \
            if rank0 else None
        state = broadcast_state(comm, state, host_problem)
        if state is not None and sharded:
            state = mesh.shard_state(state, problem)
        if state is not None and say:
            print(f"Loaded checkpoint from {ck_in}", flush=True)

    # SIGTERM drain (`Environment.cxx:12-18`, `run.cxx:330-360`): the
    # flag is all-reduced at the iteration boundary, so every rank drains
    sigterm = {"flag": False}

    def _on_sigterm(signum, frame):
        sigterm["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    # rank 0 owns every file (the reference gathers to rank 0 and
    # writes there, `save_solution.cxx:8`)
    it_writer = out_io.IterationsJsonWriter(out_dir / "iterations.json") \
        if rank0 else _NullWriter()
    last_ck = {"t": time.time()}

    def checkpoint(cur_state):
        whole = host_state(cur_state)
        if rank0:
            save_checkpoint(ck_dir, whole, host_problem, params)

    def hook(rec, cur_state):
        if layers:
            timers.add_layer_spans(tracing.take()[0])
        it_writer.write(rec, total_time=time.time() - t_start)
        if say:
            print(f"it {rec.iteration:3d} mu={float(rec.mu):.3e} "
                  f"gap={float(rec.duality_gap):.3e} "
                  f"steps=({rec.primal_step:.4f},{rec.dual_step:.4f})",
                  flush=True)
        due = time.time() - last_ck["t"] >= params.checkpoint_interval
        stop = sigterm["flag"]
        if comm.active:
            flags = torch.tensor([float(due), float(stop)],
                                 dtype=torch.float64, device=device)
            due, stop = (bool(v) for v in comm.max_(flags).cpu() > 0)
        if due:
            checkpoint(cur_state)
            last_ck["t"] = time.time()
        if stop:
            # drain: checkpoint the iterate, then unwind
            checkpoint(cur_state)
            raise KeyboardInterrupt("SIGTERM")

    timers = Timers(Verbosity(min(args.verbosity, 3)))
    # --verbosity 3: the layer spans of the whole solve, summed per span
    # path into the profile
    layers = timers.verbosity >= Verbosity.trace
    setting = tracing.layer_spans(True) if layers else None
    try:
        with timers.scoped("sdpb.solve"):
            result = solve(problem, params, state=state, iteration_hook=hook,
                           timers=timers)
    except NonFiniteIterateError as e:
        if rank0:
            print(f"sdpb: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        if say:
            print("SIGTERM received; checkpoint written", flush=True)
        return 143
    finally:
        it_writer.close()
        signal.signal(signal.SIGTERM, old_handler)
        if layers:
            tracing.layer_spans(setting)
            timers.add_layer_spans(tracing.take()[0])

    final_state = host_state(result.state)
    runtime = int(time.time() - t_start)
    if not rank0:
        return 0
    placement.write_flop_model_timings(ck_dir, host_problem)
    if args.verbosity >= 2:
        prof_dir = rotate_profiling_dir(
            ck_dir.parent / (ck_dir.name + ".profiling"))
        timers.write_profile(prof_dir / "profiling.0")
    result = dataclasses.replace(result, state=final_state)
    if not args.noFinalCheckpoint:
        save_checkpoint(ck_dir, final_state, host_problem, params)
    out_io.save_solution(out_dir, result, host_problem, runtime,
                         write_solution=args.writeSolution,
                         normalization=raw.normalization)
    out_io.save_c_minus_By(out_dir / "c_minus_By" / "c_minus_By.json",
                           host_problem, final_state.y)
    if say:
        print(f"terminateReason = \"{result.reason.value}\"")
        print(f"primalObjective = {result.primal_objective[:50]}...")
        print(f"Solver runtime  = {runtime}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
