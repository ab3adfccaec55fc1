"""Limb CUDA kernels for Hopper, their plain PyTorch versions, and the
build and loader.

``solve_unblocked_batched`` and ``cholesky_unblocked_batched`` replace
the two Pallas TPU kernels of the JAX package
(``sdpb_tpu/ops/limb_kernels.py``); ``limb_add``, ``limb_mul`` and
``limb_div`` run one MP operation per launch where the JAX package
leaves the elementwise limb arithmetic to XLA fusions, and
``limb_digits`` and ``limb_planes`` the CRT pipeline's two base
conversions (limbs to base-256 digits and digit planes back) in one
launch a call.  The CUDA sources
are ``csrc/limb.cuh`` (the limb arithmetic per thread, the reference
of the warp operations), ``csrc/limb_warp.cuh`` (the same arithmetic
with one value per warp), ``csrc/limb_chol.cu`` and
``csrc/limb_solve.cu`` (the two factorization kernels, one MP operation
per warp), ``csrc/limb_elementwise.cu`` (add, mul and div, one value
per warp) and ``csrc/limb_digits.cu`` (the two conversions), each
kernel with a plain ``extern "C"`` launcher.  The kernels are built per
slot class (``SLOT_CLASSES``): a class's library takes values of up to
its capacity in slots, and a tensor of S slots runs on the smallest
class that holds S.  The factorization and elementwise units are
compiled once for each R (registers per value) of the class, the
conversions' unit once per class, all with ``nvcc`` at first use and
all at once, and linked into one shared library per class
(``csrc/build/``, keyed by sources, flags and class) called through
``ctypes``; no PyTorch header is involved.  ``chol_geometry``,
``solve_geometry``, ``elementwise_geometry``, ``digits_geometry`` and
``planes_geometry`` choose each launch's warps, grid, tile width and
shared memory.

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
from ..utils import timers

_span = timers.span("limb_kernels")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("limb.cuh", "limb_warp.cuh", "limb_chol.cu", "limb_solve.cu",
           "limb_elementwise.cu", "limb_digits.cu")
# Each unit is compiled once per R of the class (-DLIMB_R) ...
PER_R_UNITS = ("limb_chol.cu", "limb_solve.cu", "limb_elementwise.cu")
# ... but these once per class, every R they need in the one object.
PER_CLASS_UNITS = ("limb_digits.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

# Slot classes: the capacity (csrc/limb.cuh kMaxSlots) of each library
# that build() makes.  --precision 1024 needs S = 116, 2048 S = 230 and
# 4096 S = 458; the largest class, 512 slots, holds --precision 4590
# (the CRT prime pool, ops/exact.py, stops a solve near 2800).
SLOT_CLASSES = (128, 256, 512)
MAX_SLOTS = SLOT_CLASSES[-1]
MIN_SLOTS = 4

# Launch geometry of the factorization kernels (csrc/limb_chol.cu,
# csrc/limb_solve.cu): the card's SMs, the shared memory one block may
# use, the floats of one warp's scratch row past its 32 R slots
# (limb_warp.cuh kPad), and warps per block by the registers R a lane
# spends on one limb value (the (R, warps) pairs the launchers are
# built for).
SMS = 132
SMEM_LIMIT = 232_448
ROW_PAD = 4
CHOL_WARPS = {R: 32 if R == 1 else 16 if R <= 3 else 8
              for R in range(1, (MAX_SLOTS + 34) // 32 + 1)}
SOLVE_WARPS = 8
SOLVE_MAX_TILE = 4
# The elementwise kernel (csrc/limb_elementwise.cu kElementwiseWarps):
# four warps a block, one value per warp.
ELEMENTWISE_WARPS = 4
# The conversions (csrc/limb_digits.cu): a thread per digit in blocks of
# DIGITS_THREADS, at most one wave of resident blocks (2048 threads an
# SM) and a grid-stride loop past it; a warp per value for the planes,
# PLANES_WARPS a block.
DIGITS_THREADS = 256
DIGITS_MAX_BLOCKS = SMS * 2048 // DIGITS_THREADS
PLANES_WARPS = 4

LAUNCHES = {"cholesky_unblocked_batched": 0, "solve_unblocked_batched": 0,
            "limb_add": 0, "limb_mul": 0, "limb_div": 0, "limb_digits": 0,
            "limb_planes": 0}

_LIBS: dict = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    return "nvcc"


def slot_class(S: int) -> tuple:
    """(smallest, largest) slot count of the smallest class that holds
    S slots; ValueError above the largest class."""
    _check_slots("slot_class", S)
    i = next(i for i, cap in enumerate(SLOT_CLASSES) if S <= cap)
    return (SLOT_CLASSES[i - 1] + 1 if i else MIN_SLOTS), SLOT_CLASSES[i]


def _library_path(cap: int) -> Path:
    lo = slot_class(cap)[0]
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS + _class_flags(lo, cap)).encode())
    return BUILD_DIR / f"liblimb_kernels_{cap}_{digest.hexdigest()[:16]}.so"


def _class_flags(lo: int, cap: int) -> list:
    return [f"-DLIMB_MIN_SLOTS={lo}", f"-DLIMB_MAX_SLOTS={cap}"]


def class_regs(cap: int) -> range:
    """The R of the values a class holds."""
    lo = slot_class(cap)[0]
    return range(value_regs(lo), value_regs(cap) + 1)


def planes_regs(cap: int) -> range:
    """The R of the planes kernel in a class's library: the class's own
    and one more, for the extended limbs above a value's top."""
    regs = class_regs(cap)
    return range(regs[0], regs[-1] + 2)


def _objects(cap: int) -> list:
    """(object stem, source, extra flags) of each compilation of a
    class: every per-R unit for each R (the lowest R's object also
    carrying the class's entry points) and each per-class unit once."""
    regs = class_regs(cap)
    out = []
    for unit in PER_R_UNITS:
        for R in regs:
            extra = [f"-DLIMB_R={R}"] + (["-DLIMB_CLASS_ENTRIES"]
                                         if R == regs[0] else [])
            out.append((f"{Path(unit).stem}_r{R}", unit, extra))
    out += [(Path(unit).stem, unit, []) for unit in PER_CLASS_UNITS]
    return out


@timers.span("build", "limb_kernels.build")
def build(classes=SLOT_CLASSES, force: bool = False) -> dict:
    """Compile the kernels of each slot class in ``classes`` into
    ``csrc/build/`` unless a library built from the same sources, flags
    and class exists: one ``nvcc -c`` per object (``_objects``) and
    class, all started together, then one link per class.  Returns
    {class: build record} (seconds, the ``-Xptxas -v`` resource lines,
    the library path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    t0 = time.time()
    out, jobs = {}, {}
    for cap in classes:
        lib = _library_path(cap)
        if lib.exists() and not force:
            out[cap] = {"library": str(lib), "seconds": 0.0, "ptxas": [],
                        "cached": True}
            continue
        flags = NVCC_FLAGS + _class_flags(slot_class(cap)[0], cap)
        jobs[cap] = []
        for stem, unit, extra in _objects(cap):
            obj = BUILD_DIR / f"{stem}_{cap}.{pid}.o"
            cmd = [_nvcc(), *flags, *extra, "-Xptxas", "-v", "-c", "-o",
                   str(obj), str(CSRC / unit)]
            jobs[cap].append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    failure = None
    for cap, units in jobs.items():
        lines = []
        for obj, cmd, proc in units:
            stdout, err = proc.communicate()
            if proc.returncode != 0 and failure is None:
                failure = (f"nvcc failed ({proc.returncode}) building the "
                           f"limb kernels (class {cap}):\n{' '.join(cmd)}"
                           f"\n{stdout}\n{err}")
            lines += [ln.strip() for ln in err.splitlines()
                      if re.search(r"registers|spill|Compiling entry|"
                                   r"stack frame", ln)]
        out[cap] = {"ptxas": lines}
    if failure is not None:
        for units in jobs.values():
            for obj, _, _ in units:
                obj.unlink(missing_ok=True)
        raise RuntimeError(failure)
    for cap, units in jobs.items():
        lib = _library_path(cap)
        tmp = lib.with_suffix(f".{pid}.tmp")
        cmd = [_nvcc(), "-shared", "-o", str(tmp),
               *(str(obj) for obj, _, _ in units)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for obj, _, _ in units:
            obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
        out[cap].update(library=str(lib), seconds=time.time() - t0,
                        cached=False)
        timers.count("builds", "limb_kernels.build")
    return out


def _lib(S: int):
    """The loaded library of the slot class that holds S, built at
    first use."""
    lo, cap = slot_class(S)
    if cap in _LIBS:
        return _LIBS[cap]
    return _load(lo, cap)


@timers.span("build", "limb_kernels.load")
def _load(lo: int, cap: int):
    timers.count("loads", "limb_kernels.load")
    lib = ctypes.CDLL(build(classes=(cap,))[cap]["library"])
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for R in class_regs(cap):
        fn = getattr(lib, f"chol_unblocked_launch_r{R}")
        fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        fn = getattr(lib, f"solve_unblocked_launch_r{R}")
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        fn = getattr(lib, f"limb_elementwise_launch_r{R}")
        fn.argtypes = [vp, cl, vp, cl, vp, cl, ci, ci, ci, vp]
        fn.restype = ci
    lib.limb_min_slots.restype = ci
    lib.limb_max_slots.restype = ci
    lib.limb_chol_warps.argtypes = [ci]
    lib.limb_chol_warps.restype = ci
    lib.limb_chol_smem_bytes.argtypes = [ci, ci, ci]
    lib.limb_chol_smem_bytes.restype = ci
    lib.limb_solve_smem_bytes.argtypes = [ci, ci, ci, ci]
    lib.limb_solve_smem_bytes.restype = ci
    lib.limb_elementwise_smem_bytes.argtypes = [ci]
    lib.limb_elementwise_smem_bytes.restype = ci
    lib.limb_digits_launch.argtypes = [vp, vp, cl, ci, ci, ci, ci, vp]
    lib.limb_digits_launch.restype = ci
    lib.limb_planes_launch.argtypes = [vp, vp, cl, ci, ci, ci, ci, ci, vp]
    lib.limb_planes_launch.restype = ci
    lib.limb_digits_threads.restype = ci
    lib.limb_planes_smem_bytes.argtypes = [ci]
    lib.limb_planes_smem_bytes.restype = ci
    if (lib.limb_min_slots(), lib.limb_max_slots()) != (lo, cap):
        raise RuntimeError(f"limb kernel library of class {cap} was built "
                           f"for {lib.limb_min_slots()}.."
                           f"{lib.limb_max_slots()} slots")
    for n, s in ((7, lo), (32, (lo + cap) // 2), (64, cap)):
        chol = chol_geometry(n, s)
        solve = solve_geometry(1, n, 40, s)
        if (lib.limb_chol_warps(s) != chol["warps"]
                or lib.limb_chol_smem_bytes(n, s, chol["warps"])
                != chol["smem"]
                or lib.limb_solve_smem_bytes(n, solve["tm"], s,
                                             solve["warps"])
                != solve["smem"]
                or lib.limb_elementwise_smem_bytes(s)
                != elementwise_geometry(1, s)["smem"]):
            raise RuntimeError("limb kernel library disagrees on the "
                               "launch geometry")
    regs = planes_regs(cap)
    if (lib.limb_digits_threads() != DIGITS_THREADS
            or [lib.limb_planes_smem_bytes(R) for R in regs]
            != [4 * _scratch_floats(PLANES_WARPS, R) for R in regs]
            or lib.limb_planes_smem_bytes(regs[-1] + 1) != 0):
        raise RuntimeError("limb kernel library disagrees on the "
                           "conversions' launch geometry")
    _LIBS[cap] = lib
    return lib


def _on_cuda(name, *tensors, dtype=torch.float32):
    """Check dtype (limbs: float32) and device agreement; True for CUDA
    tensors, False for CPU ones, and raise for any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != dtype:
            raise TypeError(f"{name}: tensors must be {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def max_precision_bits() -> int:
    """The largest --precision whose values the kernels hold (its
    limbs and the guard limb fill MAX_SLOTS)."""
    return limb.B * (MAX_SLOTS - 2)


def _check_slots(name, S):
    if S < MIN_SLOTS:
        raise ValueError(f"{name}: S={S} below the format's minimum of "
                         f"{MIN_SLOTS}")
    if S > MAX_SLOTS:
        raise ValueError(
            f"{name}: S={S} slots exceeds the CUDA kernels' limit of "
            f"{MAX_SLOTS} (--precision {max_precision_bits()})")


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


def elementwise_geometry(n: int, S: int) -> dict:
    """Grid and dynamic shared memory (bytes) of the elementwise kernel
    for n values of S slots: ELEMENTWISE_WARPS warps a block, a warp for
    each value (one block for a single value), and each warp's scratch
    rows."""
    return {"blocks": max(1, -(-n // ELEMENTWISE_WARPS)),
            "smem": 4 * _scratch_floats(ELEMENTWISE_WARPS, value_regs(S))}


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


@_span
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
    launch = getattr(_lib(S), f"solve_unblocked_launch_r{value_regs(S)}")
    err = launch(
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


@_span
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
    launch = getattr(_lib(S), f"chol_unblocked_launch_r{value_regs(S)}")
    err = launch(
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


def elementwise_operand(x, batch):
    """(tensor, stride) of one operand for the elementwise kernel: a
    single value broadcast over the batch is passed as it is, with batch
    stride 0; any other operand is broadcast to ``batch`` and made
    contiguous (stride S)."""
    S = x.shape[-1]
    if x.numel() == S:
        return x.reshape(S).contiguous(), 0
    return x.expand(batch + (S,)).contiguous(), S


def _elementwise(name, a, b, plain):
    if not _on_cuda(name, a, b):
        return plain(a, b)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"{name}: slot counts {a.shape[-1]} != "
                         f"{b.shape[-1]}")
    S = a.shape[-1]
    _check_slots(name, S)
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.empty(batch + (S,), dtype=a.dtype, device=a.device)
    n = out.numel() // S
    if n == 0:
        return out
    (a, sa), (b, sb) = (elementwise_operand(a, batch),
                        elementwise_operand(b, batch))
    geo = elementwise_geometry(n, S)
    launch = getattr(_lib(S), f"limb_elementwise_launch_r{value_regs(S)}")
    err = launch(a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), n, S,
                 _OPS[name], geo["blocks"],
                 torch.cuda.current_stream(out.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out


@_span
def limb_add(a, b):
    """a + b (limb format, broadcasting over the batch axes)."""
    return _elementwise("limb_add", a, b, limb.add_plain)


@_span
def limb_mul(a, b):
    """a * b, truncated (limb format, broadcasting)."""
    return _elementwise("limb_mul", a, b, limb.mul_plain)


@_span
def limb_div(a, b):
    """a / b by long division (limb format, broadcasting)."""
    return _elementwise("limb_div", a, b, limb.div_plain)


# ---------------------------------------------------------------------------
# Base conversions of the integer CRT pipeline
# ---------------------------------------------------------------------------

def digits_geometry(n: int, n_digits: int) -> dict:
    """Grid of the digits kernel for n values of n_digits digits: a
    thread per digit, at most DIGITS_MAX_BLOCKS blocks (a grid-stride
    loop takes the rest)."""
    return {"blocks": max(1, min(-(-n * n_digits // DIGITS_THREADS),
                                 DIGITS_MAX_BLOCKS))}


def planes_geometry(n: int, P: int, ref_bits: int, k_slots: int) -> dict:
    """Registers a lane (R: 32 R slots hold planes_to_limb's extended
    limbs and their two zero heads), grid and dynamic shared memory
    (bytes) of the planes kernel for n values: PLANES_WARPS warps a
    block, a warp for each value, each warp's scratch rows.  ValueError
    where the class's library has no such R."""
    ext = k_slots + 3 + max(0, -(-(8 * P - ref_bits) // limb.B))
    R = -(-ext // 32)
    if R not in planes_regs(slot_class(k_slots)[1]):
        raise ValueError(f"limb_planes: {P} planes at 2^-{ref_bits} need "
                         f"R = {R} for S = {k_slots}, beyond its class")
    return {"regs": R, "blocks": max(1, -(-n // PLANES_WARPS)),
            "smem": 4 * _scratch_floats(PLANES_WARPS, R)}


@_span
def limb_digits(x, shift_bits: int, n_digits: int):
    """Limb array (..., S) with |value| <= 1 -> balanced int32 base-256
    digits (..., n_digits) of value * 2^shift_bits, least significant
    first (mp/limb.py digits_dev_plain's bits)."""
    name = "limb_digits"
    if not _on_cuda(name, x):
        return limb.digits_dev_plain(x, shift_bits, n_digits)
    S = x.shape[-1]
    _check_slots(name, S)
    if n_digits < 1:
        raise ValueError(f"{name}: n_digits={n_digits}")
    x = x.contiguous()
    out = torch.empty(x.shape[:-1] + (n_digits,), dtype=torch.int32,
                      device=x.device)
    n = x.numel() // S
    if n == 0:
        return out
    geo = digits_geometry(n, n_digits)
    err = _lib(S).limb_digits_launch(
        x.data_ptr(), out.data_ptr(), n, S, shift_bits, n_digits,
        geo["blocks"], torch.cuda.current_stream(x.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out


@_span
def limb_planes(planes, ref_bits: int, k_slots: int):
    """Carry-normalized balanced base-256 digit planes (..., P), int32,
    least significant first, |plane| < 2^13 -> limb array (..., k_slots)
    of value * 2^-ref_bits (mp/limb.py planes_to_limb_plain's bits)."""
    name = "limb_planes"
    if not _on_cuda(name, planes, dtype=torch.int32):
        return limb.planes_to_limb_plain(planes, ref_bits, k_slots)
    _check_slots(name, k_slots)
    P = planes.shape[-1]
    if P < 1:
        raise ValueError(f"{name}: no planes")
    planes = planes.contiguous()
    out = torch.empty(planes.shape[:-1] + (k_slots,), dtype=torch.float32,
                      device=planes.device)
    n = planes.numel() // P
    if n == 0:
        return out
    geo = planes_geometry(n, P, ref_bits, k_slots)
    err = _lib(k_slots).limb_planes_launch(
        planes.data_ptr(), out.data_ptr(), n, P, ref_bits, k_slots,
        geo["regs"], geo["blocks"],
        torch.cuda.current_stream(planes.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out
