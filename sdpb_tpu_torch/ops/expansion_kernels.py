"""Float64-expansion elementwise CUDA kernels for Hopper, the build and
the loader.

``exp_add``, ``exp_mul``, ``exp_div``, ``exp_add_f64`` and
``exp_mul_f64`` run one expansion operation per launch, one value per
thread (``csrc/expansion_elementwise.cu`` over ``csrc/expansion.cuh``),
where the JAX package leaves the expansion arithmetic of
``sdpb_tpu/mp/core.py`` to XLA fusions.  Their plain PyTorch versions
are ``mp/core.py``'s ``add_plain`` ... ``mul_f64_plain``.

The unit is compiled once for every word count K in 1..MAX_WORDS
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

SOURCES = ("expansion.cuh", "expansion_elementwise.cu")
UNIT = "expansion_elementwise.cu"
# csrc/expansion.cuh kMaxWords: K = 20 holds --precision 1060.
MAX_WORDS = 20
# csrc/expansion_elementwise.cu kThreads: threads a block, one value each.
EXPANSION_THREADS = 128

LAUNCHES = {"exp_add": 0, "exp_mul": 0, "exp_div": 0, "exp_add_f64": 0,
            "exp_mul_f64": 0}
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
    """Compile the unit for every K into ``csrc/build/`` unless a
    library built from the same sources and flags exists: one
    ``nvcc -c`` per K, all started together, then one link.  Returns
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
    for k in range(1, MAX_WORDS + 1):
        obj = BUILD_DIR / f"expansion_k{k}.{pid}.o"
        extra = [f"-DEXP_K={k}"] + (["-DEXP_CLASS_ENTRIES"] if k == 1
                                    else [])
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-c", "-o",
               str(obj), str(CSRC / UNIT)]
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
                               r"stack frame", ln)]
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
        fn = getattr(lib, f"expansion_launch_k{k}")
        fn.argtypes = [vp, cl, vp, cl, vp, cl, ci, ci, vp]
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
