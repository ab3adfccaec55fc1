"""Limb CUDA kernels for Hopper, their plain PyTorch versions, and the
build and loader.

``solve_unblocked_batched`` and ``cholesky_unblocked_batched`` replace
the two Pallas TPU kernels of the JAX package
(``sdpb_tpu/ops/limb_kernels.py``); ``limb_add``, ``limb_mul`` and
``limb_div`` run one MP operation per launch where the JAX package
leaves the elementwise limb arithmetic to XLA fusions.  The CUDA sources
are ``csrc/limb.cuh`` (the limb arithmetic per thread),
``csrc/limb_warp.cuh`` (the same arithmetic with one value per warp),
``csrc/limb_chol.cu`` and ``csrc/limb_solve.cu`` (the two factorization
kernels, one MP operation per warp) and ``csrc/limb_elementwise.cu``,
each kernel with a plain ``extern "C"`` launcher.  Each unit is compiled with ``nvcc`` at
first use, all at once, and linked into one shared library
(``csrc/build/``, rebuilt when a source changes) called through
``ctypes``; no PyTorch header is involved.  ``chol_geometry`` and
``solve_geometry`` choose each launch's warps, tile width and shared
memory.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; it never falls back from one
to the other.  ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

import torch

from ..mp import limb

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("limb.cuh", "limb_warp.cuh", "limb_chol.cu", "limb_solve.cu",
           "limb_elementwise.cu")
UNITS = ("limb_chol.cu", "limb_solve.cu", "limb_elementwise.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

# Largest slot count S the kernels hold per element (csrc/limb.cuh
# kMaxSlots); --precision 1024 needs S = 116.
MAX_SLOTS = 128

# Launch geometry of the factorization kernels (csrc/limb_chol.cu,
# csrc/limb_solve.cu): the card's SMs, the shared memory one block may
# use, the floats of one warp's scratch row past its 32 R slots
# (limb_warp.cuh kPad), and warps per block by the registers R a lane
# spends on one limb value (the (R, warps) pairs the launchers are
# built for).
SMS = 132
SMEM_LIMIT = 232_448
ROW_PAD = 4
CHOL_WARPS = {1: 32, 2: 16, 3: 16, 4: 8, 5: 8}
SOLVE_WARPS = 8
SOLVE_MAX_TILE = 4

LAUNCHES = {"cholesky_unblocked_batched": 0, "solve_unblocked_batched": 0,
            "limb_add": 0, "limb_mul": 0, "limb_div": 0}

_LIB = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    return "nvcc"


def build(force: bool = False) -> dict:
    """Compile the kernels into ``csrc/build/`` unless a library built
    from the same sources exists: one ``nvcc -c`` per unit, all started
    together, then one link.  Returns the build record (seconds, the
    ``-Xptxas -v`` resource lines, the library path)."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"liblimb_kernels_{tag}.so"
    if lib.exists() and not force:
        return {"library": str(lib), "seconds": 0.0, "ptxas": [],
                "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    t0 = time.time()
    objs, procs = [], []
    for unit in UNITS:
        obj = BUILD_DIR / f"{Path(unit).stem}_{tag}.{pid}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
               str(CSRC / unit)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    lines = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building the limb kernels:"
                f"\n{' '.join(cmd)}\n{out}\n{err}")
        lines += [ln.strip() for ln in err.splitlines()
                  if re.search(r"registers|spill|Compiling entry|stack frame",
                               ln)]
    tmp = lib.with_suffix(f".{pid}.tmp")
    cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"library": str(lib), "seconds": time.time() - t0,
            "ptxas": lines, "cached": False}


def _lib():
    global _LIB
    if _LIB is None:
        info = build()
        BUILD_INFO.update(info)
        lib = ctypes.CDLL(info["library"])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.chol_unblocked_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci,
                                              vp]
        lib.chol_unblocked_launch.restype = ci
        lib.solve_unblocked_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               ci, ci, ci, ci, vp]
        lib.solve_unblocked_launch.restype = ci
        lib.limb_elementwise_launch.argtypes = [vp, vp, vp, ctypes.c_long,
                                                ci, ci, vp]
        lib.limb_elementwise_launch.restype = ci
        lib.limb_max_slots.restype = ci
        lib.limb_chol_smem_bytes.argtypes = [ci, ci, ci]
        lib.limb_chol_smem_bytes.restype = ci
        lib.limb_solve_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.limb_solve_smem_bytes.restype = ci
        if lib.limb_max_slots() != MAX_SLOTS:
            raise RuntimeError("limb kernel library disagrees on MAX_SLOTS")
        for n, S in ((7, 26), (32, 47), (64, 116), (64, MAX_SLOTS)):
            chol = chol_geometry(n, S)
            solve = solve_geometry(1, n, 40, S)
            if (lib.limb_chol_smem_bytes(n, S, chol["warps"]) != chol["smem"]
                    or lib.limb_solve_smem_bytes(n, solve["tm"], S,
                                                 solve["warps"])
                    != solve["smem"]):
                raise RuntimeError("limb kernel library disagrees on the "
                                   "shared-memory layout")
        _LIB = lib
    return _LIB


def _on_cuda(name, *tensors):
    """Check dtype and device agreement; True for CUDA tensors, False
    for CPU ones, and raise for any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: limb tensors must be float32")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _check_slots(name, S):
    if S > MAX_SLOTS:
        raise ValueError(
            f"{name}: S={S} slots exceeds the CUDA kernels' limit of "
            f"{MAX_SLOTS} (precision {limb.precision_bits(MAX_SLOTS)} bits)")


def value_regs(S: int) -> int:
    """Registers per lane for one limb value spread over a warp: S slots
    and the L + 4 slots of a product (csrc/limb_warp.cuh regs_for)."""
    _check_slots("value_regs", S)
    return -(-(S + 3) // 32)


def _scratch_floats(warps: int, R: int) -> int:
    """The warps' scratch rows (csrc/limb_warp.cuh scratch_floats): a row
    of 32 R + ROW_PAD floats and a padded row of 64 R per warp."""
    return warps * (32 * R + ROW_PAD + 64 * R)


def chol_geometry(n: int, S: int) -> dict:
    """Warps and dynamic shared memory (bytes) of one Cholesky block:
    the scaled column (n S floats), the pivot's sqrt and rsqrt (2 S) and
    the warps' scratch rows."""
    R = value_regs(S)
    warps = CHOL_WARPS[R]
    smem = 4 * (n * S + 2 * S + _scratch_floats(warps, R))
    if smem > SMEM_LIMIT:
        raise ValueError(f"cholesky n={n}, S={S} needs {smem} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")
    return {"warps": warps, "smem": smem}


def solve_geometry(BB: int, n: int, m: int, S: int) -> dict:
    """Tile width, warps, grid and dynamic shared memory (bytes) of the
    solve kernel: tiles of SOLVE_MAX_TILE columns, halved while the grid
    has fewer than two blocks per SM; x_i of the tile (tm S floats), L's
    column i (n S) and the warps' scratch rows.  (Measured on the card,
    PERF.md: more, narrower tiles beat fewer wide ones at every
    main-path shape.)"""
    R = value_regs(S)
    tm = max(1, min(m, SOLVE_MAX_TILE))
    while tm > 1 and BB * -(-m // tm) < 2 * SMS:
        tm //= 2
    blocks = BB * -(-m // tm)
    smem = 4 * (tm * S + n * S + _scratch_floats(SOLVE_WARPS, R))
    if smem > SMEM_LIMIT:
        raise ValueError(f"solve n={n}, S={S} needs {smem} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")
    return {"tm": tm, "warps": SOLVE_WARPS, "blocks": blocks, "smem": smem}


def _status(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {err}")


# ---------------------------------------------------------------------------
# Batched unblocked triangular solves
# ---------------------------------------------------------------------------

def solve_unblocked_plain(l, b, inv_d, transpose: bool = False):
    """Plain PyTorch version of the solve kernel, in its order of
    operations: right-looking substitution, every pending row updated
    with one limb mul + add per step."""
    BB, n, m, S = b.shape
    acc = b
    out = torch.empty_like(b)
    rows = torch.arange(n, device=b.device)
    for t in range(n):
        i = n - 1 - t if transpose else t
        xi = limb.mul_plain(acc[:, i], inv_d[:, i, None, :])  # (BB, m, S)
        out[:, i] = xi
        if transpose:
            col = l[:, i, :, :]                               # L[i, :]
            mask = rows < i
        else:
            col = l[:, :, i, :]                               # L[:, i]
            mask = rows > i
        upd = limb.mul_plain(col[:, :, None, :], xi[:, None, :, :])
        acc = limb.add_plain(acc, torch.where(mask[:, None, None], -upd, 0.0))
    return out


def solve_unblocked_batched(l, b, inv_d, transpose: bool = False):
    """X = L^{-1} B (or L^{-T} B) for a batch of small lower-triangular
    limb systems:

      l      (BB, n, n, S)
      b      (BB, n, m, S)
      inv_d  (BB, n, S)     reciprocals of diag(l), precomputed
      ->     (BB, n, m, S)
    """
    name = "solve_unblocked_batched"
    if b.dim() != 4 or l.shape != (b.shape[0], b.shape[1], b.shape[1],
                                   b.shape[3]) \
            or inv_d.shape != (b.shape[0], b.shape[1], b.shape[3]):
        raise ValueError(f"{name}: shapes {tuple(l.shape)}, "
                         f"{tuple(b.shape)}, {tuple(inv_d.shape)}")
    if not _on_cuda(name, l, b, inv_d):
        return solve_unblocked_plain(l, b, inv_d, transpose)
    BB, n, m, S = b.shape
    _check_slots(name, S)
    for t in (l, b, inv_d):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    geo = solve_geometry(BB, n, m, S)
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    err = _lib().solve_unblocked_launch(
        l.data_ptr(), b.data_ptr(), inv_d.data_ptr(), out.data_ptr(),
        BB, n, m, S, geo["tm"], int(transpose), geo["warps"],
        torch.cuda.current_stream(b.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Batched unblocked Cholesky
# ---------------------------------------------------------------------------

def cholesky_unblocked_plain(a):
    """Plain PyTorch version of the Cholesky kernel: right-looking, pivot
    by sqrt_rsqrt, column scaled by the reciprocal root, rank-1 update
    added to every entry under the trailing mask, lower-triangle mask."""
    BB, n, _, S = a.shape
    out = a.clone()
    rows = torch.arange(n, device=a.device)
    for j in range(n):
        d, dinv = limb.sqrt_rsqrt_plain(out[:, j, j])         # (BB, S)
        col = limb.mul_plain(out[:, :, j], dinv[:, None, :])  # (BB, n, S)
        below = rows > j
        col = torch.where(below[:, None], col,
                          torch.where((rows == j)[:, None], d[:, None, :],
                                      0.0))
        out[:, :, j] = col
        upd = limb.mul_plain(col[:, :, None, :], col[:, None, :, :])
        mask = (below[:, None] & below[None, :])[:, :, None]
        out = limb.add_plain(out, torch.where(mask, -upd, 0.0))
    lower = (rows[:, None] >= rows[None, :])[:, :, None]
    return torch.where(lower, out, 0.0)


def cholesky_unblocked_batched(a):
    """Lower Cholesky of a batch of small SPD limb matrices
    (BB, n, n, S) -> (BB, n, n, S).  A non-PD pivot gives NaN limbs."""
    name = "cholesky_unblocked_batched"
    if a.dim() != 4 or a.shape[1] != a.shape[2]:
        raise ValueError(f"{name}: shape {tuple(a.shape)}")
    if not _on_cuda(name, a):
        return cholesky_unblocked_plain(a)
    BB, n, _, S = a.shape
    _check_slots(name, S)
    geo = chol_geometry(n, S)
    if not a.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    err = _lib().chol_unblocked_launch(
        a.data_ptr(), out.data_ptr(), BB, n, S,
        limb.newton_steps(S - 1), geo["warps"],
        torch.cuda.current_stream(a.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Elementwise limb add / mul / div
# ---------------------------------------------------------------------------

_OPS = {"limb_add": 0, "limb_mul": 1, "limb_div": 2}


def _elementwise(name, a, b, plain):
    if not _on_cuda(name, a, b):
        return plain(a, b)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"{name}: slot counts {a.shape[-1]} != "
                         f"{b.shape[-1]}")
    S = a.shape[-1]
    _check_slots(name, S)
    if S < 4:
        raise ValueError(f"{name}: S={S} below the format's minimum of 4")
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(batch + (S,)).contiguous()
    b = b.expand(batch + (S,)).contiguous()
    out = torch.empty_like(a)
    n = out.numel() // S
    if n == 0:
        return out
    err = _lib().limb_elementwise_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, S, _OPS[name],
        torch.cuda.current_stream(a.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out


def limb_add(a, b):
    """a + b (limb format, broadcasting over the batch axes)."""
    return _elementwise("limb_add", a, b, limb.add_plain)


def limb_mul(a, b):
    """a * b, truncated (limb format, broadcasting)."""
    return _elementwise("limb_mul", a, b, limb.mul_plain)


def limb_div(a, b):
    """a / b by long division (limb format, broadcasting)."""
    return _elementwise("limb_div", a, b, limb.div_plain)
