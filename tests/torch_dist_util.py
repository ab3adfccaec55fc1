"""Run a function as the ranks of a gloo group on the CPU, each rank a
spawned process with one intra-op thread, joined by a file:// store in
the test's temporary directory (no TCP port, so that tests under
pytest-xdist never collide).  A rank that raises fails the call with its
traceback; a rank that hangs fails it at the timeout, and every rank is
killed either way.

The rank bodies live in this module or the port's package, never in a
test module, so that a spawned rank imports neither pytest's test
modules nor JAX."""

import itertools
import multiprocessing
import os
import queue
import signal
import time
import traceback

import numpy as np

_RUNS = itertools.count()


def _rank_main(fn, rank, world, init, args, q, env):
    import torch

    torch.set_num_threads(1)
    os.environ.update(env)
    try:
        if init is None:
            out = fn(rank, *args)
        else:
            from sdpb_tpu_torch.parallel import comm as cm

            comm = cm.init_process_group(rank, world, "cpu", init, "gloo",
                                         timeout_s=120)
            try:
                out = fn(comm, *args)
            finally:
                cm.destroy(comm)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise


def _run(fn, world, store_dir, args, timeout, env_of, with_group,
         beside=None):
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    init = None
    store = os.path.join(str(store_dir), f"store_{os.getpid()}_{next(_RUNS)}")
    if with_group:
        init = f"file://{store}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, args, q, env_of(r, store)))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    try:
        side = beside() if beside is not None else None
        while len(results) < world:
            try:
                rank, ok, out = q.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(world)) - set(results))} did "
                    f"not finish within {timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
            p.close()
        q.close()
        q.join_thread()
    return [results[r] for r in range(world)], side


def run_ranks(fn, world, store_dir, *args, timeout=150):
    """[fn(comm, *args) of each rank], in rank order."""
    return _run(fn, world, store_dir, args, timeout,
                lambda r, store: {}, True)[0]


def run_ranks_beside(beside, fn, world, store_dir, *args, timeout=150):
    """``run_ranks``'s results, and ``beside()``, which this process
    runs while the ranks do."""
    return _run(fn, world, store_dir, args, timeout,
                lambda r, store: {}, True, beside)


def run_cli_ranks(argv, world, store_dir, sigterm_rank=None,
                  sigterm_at=None, timeout=150, log_dir=None, env=None,
                  root_only_io=False, beside=None):
    """The sdpb CLI as ``world`` ranks on the CPU (``main(argv,
    device="cpu")``), joined through the SDPB_* variables (and ``env``);
    rank ``sigterm_rank`` sends itself SIGTERM after iteration
    ``sigterm_at``; with ``log_dir`` rank r's standard output and error
    go to rank<r>.log and rank<r>.err there; ``root_only_io`` makes
    every output writer, and the readers of checkpoints and block costs,
    of the ranks other than 0 raise (rank 0 reads and broadcasts, so
    that ranks on hosts without a shared directory agree).  Returns
    each rank's exit code, and with ``beside`` also ``beside()``, which
    this process runs while the ranks do."""
    def env_of(rank, store):
        return dict(env or {}, SDPB_COORDINATOR=f"file://{store}",
                    SDPB_NUM_PROCESSES=str(world), SDPB_PROCESS_ID=str(rank))

    codes, side = _run(_cli_rank, world, store_dir,
                       (list(argv), sigterm_rank, sigterm_at,
                        None if log_dir is None else str(log_dir),
                        root_only_io),
                       timeout, env_of, False, beside)
    return codes if beside is None else (codes, side)


def _cli_rank(rank, argv, sigterm_rank, sigterm_at, log_dir, root_only_io):
    import contextlib

    if log_dir is None:
        return _cli_main(rank, argv, sigterm_rank, sigterm_at, root_only_io)
    with open(os.path.join(log_dir, f"rank{rank}.log"), "w") as out, \
            open(os.path.join(log_dir, f"rank{rank}.err"), "w") as err, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        return _cli_main(rank, argv, sigterm_rank, sigterm_at, root_only_io)


def _forbid(*_a, **_kw):
    raise AssertionError("a rank other than 0 wrote an output file or "
                         "read a checkpoint or the block costs")


def _cli_main(rank, argv, sigterm_rank, sigterm_at, root_only_io):
    from sdpb_tpu_torch.apps import sdpb as app
    from sdpb_tpu_torch.solver import driver

    if root_only_io and rank != 0:
        from sdpb_tpu_torch.io import output
        from sdpb_tpu_torch.solver import checkpoint, placement
        from sdpb_tpu_torch.utils import timers

        output.save_solution = output.save_c_minus_By = _forbid
        output.IterationsJsonWriter = _forbid
        checkpoint.save_checkpoint = checkpoint.load_checkpoint = _forbid
        placement.read_block_costs = _forbid
        placement.write_flop_model_timings = _forbid
        timers.rotate_profiling_dir = _forbid

    if rank == sigterm_rank:
        solve = driver.solve

        def solve_then_sigterm(problem, params, state=None,
                               iteration_hook=None, **kw):
            def hook(rec, cur_state):
                if rec.iteration == sigterm_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                iteration_hook(rec, cur_state)
            return solve(problem, params, state=state, iteration_hook=hook,
                         **kw)

        driver.solve = solve_then_sigterm
    return app.main(argv, device="cpu")


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

SDP_1D = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "sdpb_tpu_torch", "data",
    "quickstart_1d_sdp")


def mesh_solve(comm, arrays, precision, word_dtype, iterations,
               dist_q_min_n=None, costs=None):
    """A mesh solve of the problem carried in ``arrays`` (torch_port_util
    .jax_arrays); returns the records, the gathered state as numpy
    arrays, each bucket's slot array and L_Q of the first iteration."""
    from sdpb_tpu_torch.parallel import mesh
    from sdpb_tpu_torch.parallel.multihost import replicate
    from sdpb_tpu_torch.solver import bucket_iteration as bi
    from sdpb_tpu_torch.solver import driver
    from sdpb_tpu_torch.solver.data import bucketed_problem_from_arrays
    from sdpb_tpu_torch.solver.params import SolverParams

    params = SolverParams(precision=precision, word_dtype=word_dtype,
                          max_iterations=iterations)
    problem, _ = bucketed_problem_from_arrays(arrays, "cpu")
    mproblem = mesh.shard_problem(problem, comm, costs=costs)
    first_lq = {}
    factorize, min_n = bi.schur_factorize, mesh.DIST_Q_MIN_N

    def keep_first(prob, res, max_q_bytes=None):
        out = factorize(prob, res, max_q_bytes)
        if not first_lq:
            lq = out[2]
            if isinstance(lq, mesh.DistLQ):
                lq = replicate(comm, lq.l_local)[:lq.n, :lq.n]
            first_lq["L_Q"] = lq.numpy().copy()
        return out

    bi.schur_factorize = keep_first
    if dist_q_min_n is not None:
        mesh.DIST_Q_MIN_N = dist_q_min_n
    try:
        result = driver.solve(mproblem, params)
    finally:
        bi.schur_factorize, mesh.DIST_Q_MIN_N = factorize, min_n
    state = mesh.unshard_state(result.state, mproblem)
    return {"reason": result.reason.name,
            "records": [r.__dict__ for r in result.iterations],
            "y": state.y.numpy(), "x": [x.numpy() for x in state.x],
            "X": [[a.numpy() for a in Xb] for Xb in state.X],
            "slots": mproblem.slots, "distribute_q": mproblem.distribute_q,
            "L_Q": first_lq["L_Q"]}


def mesh_solves(comm, runs):
    """[mesh_solve(comm, *args) for args in runs], in one group."""
    return [mesh_solve(comm, *args) for args in runs]


def mesh_round_trip(comm, arrays):
    """shard_state then unshard_state gives the state back."""
    import torch

    from sdpb_tpu_torch.parallel import mesh as m
    from sdpb_tpu_torch.solver.data import (bucketed_problem_from_arrays,
                                            initial_bucketed_state)

    problem, _ = bucketed_problem_from_arrays(arrays, "cpu")
    state = initial_bucketed_state(problem, 1e20, 1e20)
    gen = torch.Generator().manual_seed(0)
    state.x = [torch.randn(x.shape, generator=gen).to(x.dtype)
               for x in state.x]
    mp_ = m.shard_problem(problem, comm, costs=[list(range(bk.nb, 0, -1))
                                                for bk in problem.buckets])
    back = m.unshard_state(m.shard_state(state, mp_), mp_)
    return all(torch.equal(a, b) for a, b in zip(back.x, state.x))


def _pad_identity(a, n1):
    """(n, n, K) numpy -> (n1, n1, K) with 1 on the padded diagonal."""
    n, k = a.shape[0], a.shape[-1]
    out = np.zeros((n1, n1, k), a.dtype)
    out[:n, :n] = a
    out[np.arange(n, n1), np.arange(n, n1), 0] = 1.0
    return out


def rowpanel_linalg(comm, a, b, bm):
    """The row-panel Cholesky of the SPD ``a`` (padded to the rank
    count), the row-panel solves of the vector ``b`` and of the matrix
    ``bm``; the factor and the solutions gathered, as numpy."""
    import torch

    from sdpb_tpu_torch.parallel import dist_q, intra
    from sdpb_tpu_torch.parallel.multihost import replicate

    n = a.shape[0]
    n1 = dist_q.padded_rows(n, comm.world) * comm.world
    a_loc = intra.shard_rows(comm, torch.from_numpy(_pad_identity(a, n1)))
    l_loc = dist_q.cholesky_rowpanel(comm, a_loc)
    bt = torch.from_numpy(b)
    bmp = torch.nn.functional.pad(torch.from_numpy(bm),
                                  (0, 0, 0, 0, 0, n1 - n))
    return {"L": replicate(comm, l_loc)[:n, :n].numpy(),
            "x": dist_q.dist_cholesky_solve(comm, l_loc, bt, n).numpy(),
            "lo": dist_q.solve_lower_rowpanel(comm, l_loc, bmp)[:n].numpy(),
            "lo_t": dist_q.solve_lower_t_rowpanel(comm, l_loc,
                                                  bmp)[:n].numpy()}


def dist_q_from_rows(comm, x, e_col, plan_rows):
    """L_Q of X^T X through this rank's rows of X: per-rank residues,
    reduce-scatter, row-panel restore and Cholesky; gathered."""
    import torch

    from sdpb_tpu_torch.ops import mpmm
    from sdpb_tpu_torch.parallel import dist_q
    from sdpb_tpu_torch.parallel.multihost import replicate
    from sdpb_tpu_torch.solver import bucket_iteration as bi

    xt = torch.from_numpy(x)
    k = xt.shape[-1]
    plan = mpmm.plan_for(mpmm.precision_of(xt.dtype, k), plan_rows)
    per = -(-xt.shape[0] // comm.world)
    mine = xt[comm.rank * per:(comm.rank + 1) * per]
    q_res, _ = bi._q_residues(mine[None], torch.from_numpy(e_col), plan)
    l_loc = dist_q.restore_cholesky(comm, q_res, torch.from_numpy(e_col),
                                    torch.tensor(True), plan, k, xt.dtype)
    n = xt.shape[1]
    return replicate(comm, l_loc)[:n, :n].numpy()


def intra_linalg(comm, a, u, x, y):
    """parallel/intra.py's Cholesky, solves, SYRK and GEMM over this
    rank's rows; the results whole, as numpy."""
    import torch

    from sdpb_tpu_torch.parallel import intra

    l_loc = intra.cholesky(comm, intra.shard_rows(comm, torch.from_numpy(a)))
    ut = torch.from_numpy(u)
    xs = intra.shard_rows(comm, torch.from_numpy(x))
    ys = intra.shard_rows(comm, torch.from_numpy(y))
    return {"L": intra.gather_rows(comm, l_loc).numpy(),
            "t": intra.solve_lower(comm, l_loc, ut).numpy(),
            "tt": intra.solve_lower_t(comm, l_loc, ut).numpy(),
            "cs": intra.cholesky_solve(comm, l_loc, ut).numpy(),
            "syrk": intra.syrk(comm, xs).numpy(),
            "gemm": intra.gemm(comm, xs, ys).numpy()}


def intra_solve(comm, precision, iterations):
    """The 1d SDP through parallel/intra_solver.py in float64
    expansions; the records and the whole state as numpy."""
    from sdpb_tpu_torch.io.sdp_json import read_sdp
    from sdpb_tpu_torch.parallel import intra_solver
    from sdpb_tpu_torch.solver import driver
    from sdpb_tpu_torch.solver.data import (bucketed_problem_from_raw,
                                            problem_from_raw)
    from sdpb_tpu_torch.solver.params import SolverParams

    params = SolverParams(precision=precision, word_dtype="float64",
                          max_iterations=iterations)
    raw = read_sdp(SDP_1D, k=params.n_read_words)
    ip = intra_solver.IntraProblem(
        problem_from_raw(raw, "cpu", params.dtype, params.n_words), comm)
    result = driver.solve(ip, params)
    host = bucketed_problem_from_raw(raw, params.n_words, "cpu",
                                     params.dtype)
    state = intra_solver.to_bucketed_state(ip, result.state, host.buckets)
    return {"reason": result.reason.name,
            "records": [r.__dict__ for r in result.iterations],
            "y": state.y.numpy(), "x": [x.numpy() for x in state.x],
            "X": [[a.numpy() for a in Xb] for Xb in state.X]}


def bucketed_step(comm, arrays):
    """One step of parallel/bucketed.py's sharded step from the cold
    start, this rank taking its contiguous share of the one bucket."""
    from sdpb_tpu_torch.parallel import bucketed
    from sdpb_tpu_torch.solver.data import (BucketedState, SDPBucket,
                                            bucketed_problem_from_arrays,
                                            initial_bucketed_state)
    from sdpb_tpu_torch.solver.params import SolverParams

    problem, _ = bucketed_problem_from_arrays(arrays, "cpu")
    bk = problem.buckets[0]
    state = initial_bucketed_state(problem, 1e20, 1e20)
    if comm is not None:
        per = bk.nb // comm.world
        sl = slice(comm.rank * per, (comm.rank + 1) * per)
        bk = SDPBucket(c=bk.c[sl], B=bk.B[sl],
                       q=tuple(q[sl] for q in bk.q),
                       u=tuple(u[sl] for u in bk.u), shape=bk.shape)
        state = BucketedState(x=[state.x[0][sl]], y=state.y,
                              X=[tuple(a[sl] for a in state.X[0])],
                              Y=[tuple(a[sl] for a in state.Y[0])])
    params = SolverParams(precision=212)
    step = bucketed.make_sharded_step(bk.shape, comm=comm)
    new, info = step(bk, state, problem.b, problem.total_psd_rows,
                     torch_tensor(params.infeasible_centering_mp()))
    return new.y.numpy(), info


def torch_tensor(a):
    import torch

    return torch.as_tensor(np.asarray(a))


def synthetic_arrays(precision, word_dtype, buckets, n_dual, seed):
    """The seeded synthetic problem (solver/synthetic.py) of ``buckets``
    ((nb, m, pts), ...) as the flat arrays of torch_port_util.jax_arrays
    (what mesh_solve and the rank bodies read)."""
    from sdpb_tpu_torch.solver import synthetic
    from sdpb_tpu_torch.solver.params import SolverParams

    params = SolverParams(precision=precision, word_dtype=word_dtype)
    problem, _ = synthetic.build_problem(params, "cpu", buckets=buckets,
                                         n_dual=n_dual, seed=seed)
    out = {"objective_const": problem.objective_const.numpy(),
           "b": problem.b.numpy()}
    for i, bk in enumerate(problem.buckets):
        p = f"buckets.{i}."
        out.update({p + "c": bk.c.numpy(), p + "B": bk.B.numpy(),
                    p + "shape": np.array([bk.shape.m, bk.shape.pts]),
                    p + "block_indices": np.array(bk.block_indices)})
        for par in range(2):
            out[p + f"q.{par}"] = bk.q[par].numpy()
            out[p + f"u.{par}"] = bk.u[par].numpy()
    return out


def blocks_sdp(out_dir, seed: int = 13):
    """A seeded PMP of eight blocks in three shapes, compiled by the
    port's pmp2sdp into ``out_dir``: five 1x1 blocks of degree 4 (the
    quickstart's, each with its own pole), two 2x2 blocks of degree 4
    and one 1x1 block of degree 2; N = 3.  Every coefficient is a
    seeded +-10% from a positive pattern, so that the problem stays
    feasible and bounded, and well conditioned: a block-sharded solve
    differs from the one-device solve only by the order of its sums.
    With costs the five-block bucket is reordered by LPT on 2 and 3
    ranks, and the one-block bucket leaves phantoms on every rank but
    one."""
    import contextlib
    import io
    import pathlib

    from sdpb_tpu_torch.apps import pmp2sdp
    from sdpb_tpu_torch.io import pmp_writer as w

    rng = np.random.default_rng(seed)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def c(*vals):
        return [f"{v * (1 + 0.1 * rng.uniform(-1, 1)):.6f}" if v else "0"
                for v in vals]

    def one_by_one(pole):
        return w.PositiveMatrixWithPrefactor(
            prefactor=w.DampedRational(constant=1, base="0.5",
                                       poles=[pole]),
            polynomials=[[[c(1, 0, 1, 0, 1), c(0, 0, 1, 0, 1 / 12),
                           c(0, 1, 0, 0.2, 0), c(0, 0, 1, 0, 0)]]])

    def two_by_two():
        off = [c(0, 0.1, 0, 0, 0), c(0, 0, 0.05, 0, 0), c(0, 0, 0, 0, 0),
               c(0, 0, 0, 0, 0)]
        return w.PositiveMatrixWithPrefactor(
            prefactor=w.DampedRational(constant="0.75", base="0.5",
                                       poles=["-0.5", "-1.25"]),
            polynomials=[[[c(3, 0, 1, 0, 1), c(0, 0, 1, 0, 0),
                           c(0, 1, 0, 0, 0), c(0, 0, 0, 1, 0)], off],
                         [off, [c(2, 0, 0, 0, 1), c(0, 0, 1, 0, 0.1),
                                c(0, 0, 0, 1, 0), c(0, 1, 0, 0, 0)]]])

    small = w.PositiveMatrixWithPrefactor(
        prefactor=w.DampedRational(constant=1, base="0.5", poles=[]),
        polynomials=[[[c(1, 0, 1), c(0, 1, 0), c(0, 0, 1), c(0, 1, 0)]]])
    matrices = [one_by_one(f"-{0.25 * (i + 1)}") for i in range(5)]
    matrices[2:2] = [two_by_two(), small]
    matrices.insert(6, two_by_two())
    w.write_pmp_json(out_dir / "pmp.json", objective=[0, -1, -1, -1],
                     normalization=[1, 0, 0, 0], matrices=matrices)
    with contextlib.redirect_stdout(io.StringIO()):
        assert pmp2sdp.main(["-p", "512", "-i", str(out_dir / "pmp.json"),
                             "-o", str(out_dir / "sdp"), "-j", "1",
                             "-v", "0"]) == 0
    return out_dir / "sdp"
