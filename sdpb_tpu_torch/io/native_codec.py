"""ctypes binding of the port's native decimal codec (``csrc/codec.cpp``):
exact conversion between decimal strings and K-word float64 expansions
on the host.

The library is built at first use with the host C++ compiler (``c++``
or ``g++``, ``CXX_FLAGS``) into ``csrc/build/``, its file name keyed by
a digest of the source and flags.  When no compiler or library is at
hand every entry point returns None, and ``mp/decimal.py`` takes its
mpmath path, which gives the same words.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = CSRC / "codec.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libport_codec_{digest.hexdigest()[:16]}.so"


def _compiler():
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    return None


def build(force: bool = False) -> dict:
    """Compile the codec unless a library of the same source and flags
    exists (``force`` rebuilds it).  Returns {"seconds", "library"};
    raises RuntimeError when it cannot be built."""
    lib = library_path()
    t0 = time.time()
    if force or not lib.exists():
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("no host C++ compiler (c++ or g++) to build "
                               "the decimal codec")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, lib)
    return {"seconds": time.time() - t0, "library": str(lib)}


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build()["library"])
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.port_dec2words.restype = ctypes.c_int
    lib.port_dec2words.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                   ctypes.c_int, dbl]
    lib.port_dec2words_batch.restype = ctypes.c_long
    lib.port_dec2words_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_int, dbl]
    lib.port_words2dec.restype = ctypes.c_int
    lib.port_words2dec.argtypes = [dbl, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_long]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def dec2words(s: str, k: int):
    """One decimal string -> (k,) float64 words, or None without the
    library; ValueError when ``s`` is not a decimal."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(k, dtype=np.float64)
    b = s.encode()
    rc = lib.port_dec2words(
        b, len(b), k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise ValueError(f"native codec could not parse {s!r}")
    return out


def dec2words_batch(strings, k: int):
    """Sequence of decimal strings -> (n, k) float64 words, or None
    without the library; ValueError naming the first bad element."""
    lib = _load()
    if lib is None:
        return None
    enc = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
    n = len(enc)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, b in enumerate(enc):
        offsets[i + 1] = offsets[i] + len(b)
    out = np.zeros((n, k), dtype=np.float64)
    rc = lib.port_dec2words_batch(
        b"".join(enc), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != n:
        idx = -int(rc) - 1
        raise ValueError(
            f"native codec could not parse element {idx}: {strings[idx]!r}")
    return out


def words2dec(words, digits: int = 0):
    """(k,) float64 words -> decimal string, or None without the library
    or for a non-finite value.  ``digits <= 0`` gives the full round
    trip (from the words' exponent span)."""
    lib = _load()
    if lib is None:
        return None
    w = np.ascontiguousarray(words, dtype=np.float64)
    nz = w[w != 0]
    if nz.size:
        _, e_hi = np.frexp(np.max(np.abs(nz)))
        _, e_lo = np.frexp(np.min(np.abs(nz)))
        span_digits = int((int(e_hi) - int(e_lo) + 54) * 0.30103) + 4
    else:
        span_digits = 4
    cap = max(digits, span_digits) + 64
    out = ctypes.create_string_buffer(cap)
    rc = lib.port_words2dec(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), w.shape[-1],
        digits, out, cap)
    if rc < 0:
        return None
    return out.value.decode()
