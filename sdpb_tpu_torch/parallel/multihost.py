"""Multi-process start-up and the gathers for solution and checkpoint
I/O.

The JAX package connects one process per host with ``jax.distributed``
from the SDPB_* variables, and each process drives all of its host's
chips.  The port runs one process per GPU instead, so the same
variables count GPUs here:

  torchrun's RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and
  MASTER_ADDR/MASTER_PORT (``torchrun --nproc-per-node=<gpus>``) --
  or, failing those,
  SDPB_COORDINATOR   host:port of rank 0 (tcp://), or a file:// URL
  SDPB_NUM_PROCESSES total process count (one per GPU)
  SDPB_PROCESS_ID    this process's rank

A rank's GPU is LOCAL_RANK modulo the visible GPUs.  The backend is
NCCL when no two ranks of a host share a GPU, else gloo
(``comm.choose_backend``).  ``launch_local`` is what ``sdpb`` does when
it is started plainly with several visible GPUs: it starts one rank per
GPU itself with torchrun's variables and forwards SIGTERM to them.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from . import comm as comm_mod


def env_config() -> dict | None:
    """rank, world, local_rank, ranks_per_host (None without
    LOCAL_WORLD_SIZE) and init_method from the environment, or None when
    neither torchrun's nor the SDPB_* variables are set."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init = "env://"
    elif env.get("SDPB_COORDINATOR"):
        coord = env["SDPB_COORDINATOR"]
        init = coord if "://" in coord else f"tcp://{coord}"
        rank = int(env["SDPB_PROCESS_ID"])
        world = int(env["SDPB_NUM_PROCESSES"])
    else:
        return None
    local = int(env.get("LOCAL_RANK", rank))
    per_host = int(env["LOCAL_WORLD_SIZE"]) if "LOCAL_WORLD_SIZE" in env \
        else None
    return {"rank": rank, "world": world, "local_rank": local,
            "ranks_per_host": per_host, "init_method": init}


def maybe_init_distributed(device=None):
    """Join the group the environment names (None without one).
    ``device`` None: the rank's GPU; a device given (the CPU in tests)
    is taken as it is."""
    cfg = env_config()
    if cfg is None:
        return None
    n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        if not n_gpus:
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the "
                "caller passes device='cpu'")
        device = torch.device("cuda", cfg["local_rank"] % n_gpus)
    device = torch.device(device)
    # without LOCAL_WORLD_SIZE, one process per GPU: no rank shares one
    per_host = cfg["ranks_per_host"] or max(1, n_gpus)
    backend = comm_mod.choose_backend(device, per_host, n_gpus)
    return comm_mod.init_process_group(cfg["rank"], cfg["world"], device,
                                       cfg["init_method"], backend)


def fetch(x) -> np.ndarray:
    """Host numpy value of a replicated tensor."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def replicate(comm, x_local):
    """Every rank's leading-axis shard, concatenated in rank order, on
    every rank (rank 0 writes solutions and checkpoints from it)."""
    g = comm.all_gather(x_local)
    return g.reshape((-1,) + tuple(x_local.shape[1:]))


def broadcast_from_root(comm, t):
    """Rank 0's ``t`` on every rank, on ``t``'s device (every rank
    passes a tensor of that shape and dtype): what rank 0 read from its
    disk, for ranks on hosts that do not share the directory."""
    if not comm.active:
        return t
    return comm.broadcast(t.to(comm.device), 0).to(t.device)


def broadcast_state(comm, state, problem):
    """Rank 0's BucketedState of the whole ``problem`` (a checkpoint it
    loaded; None when it has none) on every rank."""
    from ..solver.data import BucketedState, initial_bucketed_state

    have = broadcast_from_root(comm, torch.tensor([int(state is not None)],
                                                  dtype=torch.int32))
    if not bool(have[0]):
        return None
    if state is None:           # the shapes and dtypes to receive into
        state = initial_bucketed_state(problem, 1.0, 1.0)
    b = lambda t: broadcast_from_root(comm, t)
    return BucketedState(x=[b(x) for x in state.x], y=b(state.y),
                         X=[tuple(b(a) for a in Xb) for Xb in state.X],
                         Y=[tuple(b(a) for a in Yb) for Yb in state.Y])


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(module: str, argv, n_ranks: int,
                 grace_s: float = 30.0) -> int:
    """Run ``python -m module argv`` as ``n_ranks`` ranks on this host,
    one per GPU, with torchrun's variables; SIGTERM is forwarded to
    every rank (a terminal's SIGINT reaches them as their group's).  When a rank fails, the others get
    ``grace_s`` seconds and are then killed.  Returns the first non-zero
    exit code, else 0."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(n_ranks),
               LOCAL_WORLD_SIZE=str(n_ranks))
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(n_ranks)]

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = signal.signal(signal.SIGTERM, forward)
    try:
        failed_at = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if failed_at is None and any(c not in (None, 0) for c in codes):
                failed_at = time.time()
            if failed_at is not None and time.time() - failed_at > grace_s:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.2)
    finally:
        signal.signal(signal.SIGTERM, old)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return next((c for c in (p.returncode for p in procs) if c), 0)
