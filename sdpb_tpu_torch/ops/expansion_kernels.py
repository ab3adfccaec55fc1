"""Float64-expansion CUDA kernels for Hopper, their column loops' plain
PyTorch versions, and the build and loader.

``exp_add``, ``exp_mul``, ``exp_div``, ``exp_add_f64`` and
``exp_mul_f64`` run one expansion operation per launch, one value per
thread (``csrc/expansion_elementwise.cu`` over ``csrc/expansion.cuh``),
where the JAX package leaves the expansion arithmetic of
``sdpb_tpu/mp/core.py`` to XLA fusions.  Their plain PyTorch versions
are ``mp/core.py``'s ``add_plain`` ... ``mul_f64_plain``.

``exp_cholesky_panel`` and ``exp_solve_unblocked`` run a whole column
loop of the expansion Cholesky and of the triangular substitution per
launch (``csrc/expansion_chol.cu``, ``csrc/expansion_solve.cu`` over
``csrc/expansion_panels.cuh``: a Cholesky's pivots on a warp of their
own ahead of the update, ``csrc/expansion_warp.cuh``, the rest a value
per thread, ``csrc/expansion_regs.cuh``), where the JAX package's
``fori_loop``s are one XLA program.  Their plain versions, ``cholesky_panel_plain``
and ``solve_unblocked_plain``, are the loops over the elementwise
operations.

Each unit is compiled once for every word count K in 1..MAX_WORDS
(``-DEXP_K``), all with ``nvcc`` at first use and all at once, and
linked into one shared library (``csrc/build/``, keyed by sources and
flags) called through ``ctypes``; no PyTorch header is involved.

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

from ..mp import core
from .limb_kernels import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, _status

SOURCES = ("expansion.cuh", "expansion_regs.cuh", "expansion_warp.cuh",
           "expansion_panels.cuh",
           "expansion_elementwise.cu", "expansion_chol.cu",
           "expansion_solve.cu")
# Each unit is compiled once per K (-DEXP_K); the elementwise unit's
# K = 1 object also carries the library's entry points.
UNITS = ("expansion_elementwise.cu", "expansion_chol.cu",
         "expansion_solve.cu")
# csrc/expansion.cuh kMaxWords: K = 20 holds --precision 1060.
MAX_WORDS = 20
# csrc/expansion_elementwise.cu kThreads: threads a block, one value each.
EXPANSION_THREADS = 128
# The column-loop kernels (csrc/expansion_chol.cu, expansion_solve.cu):
# a Cholesky block's rows (its threads, 128, but the pivot warp: one
# update thread a row, so W + rows below it <= CHOL_MAX_ROWS), and the
# rows below the pivot block a block takes at most.
CHOL_MAX_ROWS = 96
CHOL_ROW_TILE = 32
# Above this many groups of G lanes that hold one leaf each, a solve
# packs two leaves a lane (half the lanes a column): the columns then
# fill the card, and a row costs a warp two products for twice the
# columns.
SOLVE_LATENCY_GROUPS = 1024

LAUNCHES = {"exp_add": 0, "exp_mul": 0, "exp_div": 0, "exp_add_f64": 0,
            "exp_mul_f64": 0, "exp_cholesky_panel": 0,
            "exp_solve_unblocked": 0}
_OPS = {"exp_add": 0, "exp_mul": 1, "exp_div": 2, "exp_add_f64": 3,
        "exp_mul_f64": 4}

_LIB = []


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def max_precision_bits() -> int:
    """The largest --precision whose expansions the kernels hold."""
    return core.WORD_BITS * MAX_WORDS


def check_words(name: str, k: int) -> None:
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(
            f"{name}: K={k} float64 words exceeds the CUDA expansion "
            f"kernels' limit of {MAX_WORDS} (--precision "
            f"{max_precision_bits()})")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS + [str(MAX_WORDS)]).encode())
    return BUILD_DIR / f"libexpansion_kernels_{digest.hexdigest()[:16]}.so"


def build(force: bool = False) -> dict:
    """Compile the units for every K into ``csrc/build/`` unless a
    library built from the same sources and flags exists: one
    ``nvcc -c`` per unit and K, all started together, then one link.  Returns
    the build record (seconds, the ``-Xptxas -v`` resource lines, the
    library path)."""
    lib = _library_path()
    if lib.exists() and not force:
        return {"library": str(lib), "seconds": 0.0, "ptxas": [],
                "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    t0 = time.time()
    jobs = []
    for unit in UNITS:
        for k in range(1, MAX_WORDS + 1):
            obj = BUILD_DIR / f"{Path(unit).stem}_k{k}.{pid}.o"
            extra = [f"-DEXP_K={k}"] + (
                ["-DEXP_CLASS_ENTRIES"] if k == 1 and unit == UNITS[0]
                else [])
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-c",
                   "-o", str(obj), str(CSRC / unit)]
            jobs.append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    failure, lines = None, []
    for obj, cmd, proc in jobs:
        stdout, err = proc.communicate()
        if proc.returncode != 0 and failure is None:
            failure = (f"nvcc failed ({proc.returncode}) building the "
                       f"expansion kernels:\n{' '.join(cmd)}\n{stdout}\n"
                       f"{err}")
        lines += [ln.strip() for ln in err.splitlines()
                  if re.search(r"registers|spill|Compiling entry|"
                               r"Function properties|stack frame", ln)]
    if failure is not None:
        for obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
        raise RuntimeError(failure)
    tmp = lib.with_suffix(f".{pid}.tmp")
    cmd = [_nvcc(), "-shared", "-o", str(tmp),
           *(str(obj) for obj, _, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"library": str(lib), "seconds": time.time() - t0,
            "ptxas": lines, "cached": False}


def _lib():
    """The loaded library, built at first use."""
    if _LIB:
        return _LIB[0]
    lib = ctypes.CDLL(build()["library"])
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for k in range(1, MAX_WORDS + 1):
        for name, args in (
                ("expansion_launch", [vp, cl, vp, cl, vp, cl, ci, ci, vp]),
                ("expansion_chol", [vp, vp, vp, ci, ci, ci, ci, ci, vp]),
                ("expansion_solve", [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                     vp])):
            fn = getattr(lib, f"{name}_k{k}")
            fn.argtypes = args
            fn.restype = ci
    lib.expansion_max_words.restype = ci
    lib.expansion_threads.restype = ci
    if (lib.expansion_max_words(), lib.expansion_threads()) != (
            MAX_WORDS, EXPANSION_THREADS):
        raise RuntimeError("expansion kernel library disagrees on its "
                           "word limit or block size")
    _LIB.append(lib)
    return lib


def _operand(x, batch, width: int):
    """(tensor, stride) of one operand: a single value broadcast over the
    batch (every batch axis of size 1 or stride 0) is read in place with
    batch stride 0; any other operand is broadcast to ``batch`` and made
    contiguous (stride ``width``)."""
    lead = x.dim() - (0 if width == 1 else 1)
    if all(d == 1 or s == 0
           for d, s in zip(x.shape[:lead], x.stride()[:lead])):
        return x[(0,) * lead].reshape(width).contiguous(), 0
    tail = () if width == 1 else (width,)
    return x.expand(batch + tail).contiguous(), width


def _launch(name, a, b, batch, k, b_width):
    out = torch.empty(batch + (k,), dtype=torch.float64, device=a.device)
    n = out.numel() // k
    if n == 0:
        return out
    (a, sa), (b, sb) = _operand(a, batch, k), _operand(b, batch, b_width)
    blocks = max(1, -(-n // EXPANSION_THREADS))
    err = getattr(_lib(), f"expansion_launch_k{k}")(
        a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), n,
        _OPS[name], blocks,
        torch.cuda.current_stream(out.device).cuda_stream)
    _status(name, err)
    LAUNCHES[name] += 1
    return out


def _on_cuda(name, *tensors):
    """Check dtype and device agreement; True for CUDA tensors, False
    for CPU ones, and raise for any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: expansion tensors must be float64")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _binary(name, a, b, plain):
    if not _on_cuda(name, a, b):
        return plain(a, b)
    k = a.shape[-1]
    if b.shape[-1] != k:
        raise ValueError(f"{name}: word counts {k} != {b.shape[-1]}")
    check_words(name, k)
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return _launch(name, a, b, batch, k, k)


def _with_float(name, a, x, plain):
    x = core._scalar_operand(a, x)
    if not _on_cuda(name, a, x):
        return plain(a, x)
    k = a.shape[-1]
    check_words(name, k)
    return _launch(name, a, x, a.shape[:-1], k, 1)


def exp_add(a, b):
    """a + b (float64 expansions, broadcasting over the batch axes)."""
    return _binary("exp_add", a, b, core.add_plain)


def exp_mul(a, b):
    """a * b, truncated (float64 expansions, broadcasting)."""
    return _binary("exp_mul", a, b, core.mul_plain)


def exp_div(a, b):
    """a / b by long division (float64 expansions, broadcasting)."""
    return _binary("exp_div", a, b, core.div_plain)


def exp_add_f64(a, x):
    """a + x for a float64 tensor x over a's batch axes."""
    return _with_float("exp_add_f64", a, x, core.add_f64_plain)


def exp_mul_f64(a, x):
    """a * x for a float64 tensor x over a's batch axes."""
    return _with_float("exp_mul_f64", a, x, core.mul_f64_plain)


# ---------------------------------------------------------------------------
# The column loops: a whole Cholesky panel, a whole substitution per launch
# ---------------------------------------------------------------------------

def cholesky_panel_plain(c):
    """Plain PyTorch version of ``exp_cholesky_panel``: the column loop
    of a Cholesky panel c (BB, R, W, K), R >= W, whose first W rows are
    the pivot block (the JAX package's ``col_step``; with R == W the
    unblocked right-looking Cholesky).  Per column t: the pivot's
    sqrt_rsqrt, the column below it times the pivot's rsqrt, and the
    rank-1 update added under the mask of columns > t.  The pivot
    block's upper triangle comes out +0: the blocked Cholesky reads
    only the lower one.  A non-PD input gives NaNs."""
    BB, R, W, k = c.shape
    rows = torch.arange(R, device=c.device)
    cidx = torch.arange(W, device=c.device)
    C = c.clone()
    for t in range(W):
        d, dinv = core.sqrt_rsqrt(C[:, t, t])
        col = core.mul(C[:, :, t], dinv[:, None, :])
        col = torch.where((rows > t)[:, None], col,
                          torch.where((rows == t)[:, None], d[:, None, :],
                                      0.0))
        C[:, :, t] = col
        upd = core.mul(col[:, :, None, :], col[:, None, :W, :])
        C = core.add(C, torch.where((cidx > t)[None, :, None], -upd, 0.0))
    upper = (rows[:W, None] < cidx[None, :])[:, :, None]
    C[:, :W] = torch.where(upper, 0.0, C[:, :W])
    return C


def solve_unblocked_plain(l, b, inv_d, transpose: bool = False):
    """Plain PyTorch version of ``exp_solve_unblocked``: X = L^-1 B (or
    L^-T B) by substitution, l (BB, n, n, K), b (BB, n, m, K), inv_d
    (BB, n, K), one row a step: the row's products with the rows found
    so far (the masked ones +0), their tree sum, subtracted from B's
    row, times the diagonal reciprocal."""
    n = b.shape[1]
    rows = torch.arange(n, device=b.device)
    x = torch.zeros_like(b)
    for t in range(n):
        i = n - 1 - t if transpose else t
        if transpose:
            li = torch.where((rows > i)[:, None], l[:, :, i, :], 0.0)
        else:
            li = torch.where((rows < i)[:, None], l[:, i, :, :], 0.0)
        acc = core.sum_(core.mul(li[:, :, None, :], x), axis=1)
        s = core.sub(b[:, i], acc)
        x[:, i] = core.mul(s, inv_d[:, i, None, :])
    return x


def chol_row_tile(W: int) -> int:
    """Rows below the pivot block a Cholesky block takes: at most
    CHOL_ROW_TILE, and W + tile <= CHOL_MAX_ROWS (one update thread a
    row)."""
    return max(1, min(CHOL_ROW_TILE, CHOL_MAX_ROWS - W))


def exp_cholesky_panel(c):
    """The column loop of a Cholesky panel c (BB, R, W, K) in one launch
    (``cholesky_panel_plain`` on the CPU): one block per batch element
    and tile of chol_row_tile(W) rows below the pivot block; on the card
    W < CHOL_MAX_ROWS (the port's panels are 32 wide, its unblocked
    factors at most 64)."""
    if not _on_cuda("exp_cholesky_panel", c):
        return cholesky_panel_plain(c)
    BB, R, W, k = c.shape
    if R < W:
        raise ValueError(f"exp_cholesky_panel: {R} rows < {W} columns")
    if R > W and W >= CHOL_MAX_ROWS or W > CHOL_MAX_ROWS:
        raise ValueError(f"exp_cholesky_panel: {W} columns exceed the "
                         f"kernel's {CHOL_MAX_ROWS} rows a block")
    check_words("exp_cholesky_panel", k)
    c = c.contiguous()
    out = torch.empty_like(c)
    if out.numel() == 0:
        return out
    rt = chol_row_tile(W)
    tiles = max(1, -(-(R - W) // rt))
    # the private pivot blocks of every block but a panel's first
    scratch = torch.empty(((tiles - 1) * BB, W, W, k), dtype=c.dtype,
                          device=c.device)
    err = getattr(_lib(), f"expansion_chol_k{k}")(
        c.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if tiles > 1 else None, BB, R, W, tiles, rt,
        torch.cuda.current_stream(c.device).cuda_stream)
    _status("exp_cholesky_panel", err)
    LAUNCHES["exp_cholesky_panel"] += 1
    return out


def solve_lanes(bb: int, n: int, m: int) -> int:
    """Lanes G of a solve's group (one right-hand-side column; a power of
    two, n <= 2G <= 64): one leaf of the row's tree a lane (G >= n, G <=
    32) while the columns are few, so that a row costs one product;
    else two a lane (G >= n / 2), twice the columns a warp."""
    one = 1 << max(0, (n - 1).bit_length())
    two = 1 << max(0, (-(-n // 2) - 1).bit_length())
    if one <= 32 and bb * m <= SOLVE_LATENCY_GROUPS:
        return one
    return max(two, 1)


def exp_solve_unblocked(l, b, inv_d, transpose: bool = False):
    """X = L^-1 B (or L^-T B) by substitution in one launch
    (``solve_unblocked_plain`` on the CPU): l (BB, n, n, K) lower, b
    (BB, n, m, K), inv_d (BB, n, K) the diagonal's reciprocals; on the
    card n <= 64 (the port's unblocked solves and panels)."""
    if not _on_cuda("exp_solve_unblocked", l, b, inv_d):
        return solve_unblocked_plain(l, b, inv_d, transpose)
    BB, n, m, k = b.shape
    if l.shape != (BB, n, n, k) or inv_d.shape != (BB, n, k):
        raise ValueError(f"exp_solve_unblocked: shapes {tuple(l.shape)}, "
                         f"{tuple(b.shape)}, {tuple(inv_d.shape)}")
    if n > 64:
        raise ValueError(f"exp_solve_unblocked: {n} rows exceed the "
                         f"kernel's 64")
    check_words("exp_solve_unblocked", k)
    lanes = solve_lanes(BB, n, m)
    l, b, inv_d = l.contiguous(), b.contiguous(), inv_d.contiguous()
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    err = getattr(_lib(), f"expansion_solve_k{k}")(
        l.data_ptr(), b.data_ptr(), inv_d.data_ptr(), out.data_ptr(), BB, n,
        m, lanes, int(transpose),
        torch.cuda.current_stream(b.device).cuda_stream)
    _status("exp_solve_unblocked", err)
    LAUNCHES["exp_solve_unblocked"] += 1
    return out
