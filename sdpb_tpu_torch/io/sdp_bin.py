"""Binary block_data codec (the reference's DEFAULT block format); the
port's copy of sdpb_tpu/io/sdp_bin.py, reader and writer.

The reference writes `block_data_<i>.bin` as a Boost binary archive
(`src/pmp2sdp/write_block_data.cxx` write_block_data_bin) and reads it
in `src/sdp_solve/SDP/set_bases_blocks.cxx`-adjacent loaders
(`read_block_data.cxx:17-20`).  Stream contents, in order:

  [archive header] [mpfr_prec_t precision]
  [El::Matrix<BigFloat> constraint_matrix  (B, schur x N)]
  [std::vector<BigFloat> constraint_constants  (c)]
  [El::Matrix<BigFloat> bilinear_bases[0]] [bilinear_bases[1]]

Serialization traits (from `src/sdpb_util/boost_serialization.hxx`):
BOOST_CLASS_VERSION(El::BigFloat, 1) -- a leading is_zero byte per
value; BOOST_CLASS_TRACKING(..., track_never); El::Matrix saved as
Height/Width/LDim (El::Int) + COLUMN-MAJOR BigFloat array; BigFloat
payload is Elemental's BigFloat::Serialize: sequentially memcpy'd
_mpfr_prec (mpfr_prec_t), _mpfr_sign (mpfr_sign_t), _mpfr_exp
(mpfr_exp_t) and ceil(prec/64) little-endian 64-bit limbs.

Boost non-portable binary archive bookkeeping (modern layout, library
version > 7 -- every Boost the reference builds against):

- header: [size_t signature length]["serialization::archive"]
  [library_version_type, 2 raw bytes (uint_least16_t)]
- on a class's FIRST by-value occurrence: [tracking_type, 1 byte]
  [version_type, 4 raw bytes (uint_least32_t)].  NO class id:
  `basic_binary_oarchive::save_override(class_id_optional_type&)` is
  an explicit no-op ("binary files don't include the optional
  information"); class_id_type bytes appear only for pointer/exported
  types, which this stream has none of.  Subsequent occurrences carry
  no bookkeeping (track_never / not serialized through pointers).
- std::vector<T>: [collection_size_type, 8 raw bytes (size_t)]
  [item_version_type, 4 raw bytes (uint_least32_t)] + elements.
- boost::serialization::make_array over El::byte uses the binary
  save_array optimization: raw bytes, no count, no bookkeeping.

All of these strong typedefs are BOOST_CLASS_IMPLEMENTATION(...,
primitive_type), so the modern archive writes them with
save_binary(&t, sizeof(T)) at their native widths (basic_archive.hpp;
the 2-byte/1-byte compatibility encodings exist only behind
library_version <= 7 branches in basic_binary_iarchive.hpp, which no
published SDPB build produces).

Byte-level layout constants are collected in `Layout` below.  They
correspond to Boost >= 1.66 non-portable binary archives on LP64
little-endian Linux with Elemental's default 32-bit El::Int -- the
configuration of every published SDPB build.  The reference ships no
binary fixtures (`test/data` is JSON-only), so cross-implementation
bytes cannot be golden-diffed in this container; the reader therefore
VALIDATES every piece of archive bookkeeping it consumes (tracking
flags, class versions, item versions, mpfr invariants) and fails with
a precise offset diagnostic on any mismatch.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

_SIGNATURE = b"serialization::archive"


@dataclasses.dataclass(frozen=True)
class Layout:
    size_t: int = 8            # std::size_t (string lengths, counts)
    el_int: int = 4            # El::Int (Elemental default: 32-bit)
    prec_t: int = 8            # mpfr_prec_t (long)
    sign_t: int = 4            # mpfr_sign_t (int)
    exp_t: int = 8             # mpfr_exp_t (long)
    limb: int = 8              # mp_limb_t
    lib_version: int = 2       # library_version_type (uint_least16_t)
    version: int = 4           # version_type (uint_least32_t)
    item_version: int = 4      # item_version_type (uint_least32_t)
    # Lowest library version whose layout matches what we emit (the
    # encoding is identical for every version > 7, so emitting the
    # floor keeps files readable by SDPB builds linked against any
    # Boost from ~1.66 on -- binary_iarchive rejects versions NEWER
    # than the reading library's BOOST_ARCHIVE_VERSION).
    archive_version: int = 17


LAYOUT = Layout()


# ---------------------------------------------------------------------------
# Exact conversions: big-int mantissa <-> K-word f64 expansions
# ---------------------------------------------------------------------------

def words_to_int_exp(words) -> tuple[int, int]:
    """Exact dyadic value of an f64-word expansion as (M, E) with
    value = M * 2^E, M integer (possibly 0)."""
    total_m, total_e = 0, 0
    first = True
    for w in np.asarray(words, dtype=np.float64):
        w = float(w)
        if w == 0.0:
            continue
        m, e = np.frexp(w)          # w = m * 2^e, 0.5 <= |m| < 1
        mi = int(m * (1 << 53))
        ei = int(e) - 53
        if first:
            total_m, total_e = mi, ei
            first = False
            continue
        if ei < total_e:
            total_m = (total_m << (total_e - ei)) + mi
            total_e = ei
        else:
            total_m += mi << (ei - total_e)
    return total_m, total_e


def _round_shift(m: int, shift: int) -> int:
    """m / 2^shift, round half to even (shift >= 0)."""
    if shift <= 0:
        return m << -shift
    neg = m < 0
    if neg:
        m = -m
    q, r = m >> shift, m & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    if r > half or (r == half and (q & 1)):
        q += 1
    return -q if neg else q


def int_exp_to_words(M: int, E: int, k: int) -> np.ndarray:
    """value = M * 2^E -> K-word f64 expansion (greedy nearest-f64
    extraction; exact while bits remain, rounds below word K)."""
    import math

    out = np.zeros(k, dtype=np.float64)
    for i in range(k):
        if M == 0:
            break
        neg = M < 0
        a = -M if neg else M
        b = a.bit_length()
        if b <= 53:
            out[i] = math.ldexp(float(-a if neg else a), E)
            return out              # exact, done
        sh = b - 53
        top = _round_shift(a, sh)
        if top.bit_length() > 53:   # rounding carried up
            top >>= 1
            sh += 1
        t = -top if neg else top
        out[i] = math.ldexp(float(t), E + sh)
        M = M - (t << sh)           # exact remainder
    return out


# ---------------------------------------------------------------------------
# Archive reader
# ---------------------------------------------------------------------------

class BinReader:
    def __init__(self, buf: bytes, lay: Layout = LAYOUT):
        self.b = buf
        self.o = 0
        self.lay = lay
        self.classes_seen = 0
        self.class_versions: dict[str, int] = {}
        self.prec: int | None = None

    def _err(self, msg):
        raise ValueError(f"sdp .bin parse error at byte {self.o}: {msg}")

    def take(self, n: int) -> bytes:
        if self.o + n > len(self.b):
            self._err(f"need {n} bytes, have {len(self.b) - self.o}")
        out = self.b[self.o:self.o + n]
        self.o += n
        return out

    def u(self, n: int, signed=False) -> int:
        return int.from_bytes(self.take(n), "little", signed=signed)

    def header(self):
        n = self.u(self.lay.size_t)
        if n != len(_SIGNATURE):
            self._err(f"bad signature length {n}")
        if self.take(n) != _SIGNATURE:
            self._err("bad archive signature")
        ver = self.u(self.lay.lib_version)
        # the modern bookkeeping layout this reader implements holds
        # for library versions > 7 (Boost >= ~1.45); anything older
        # cannot have been produced by a published SDPB build
        if not 7 < ver < 40:
            self._err(f"unsupported boost archive library version {ver}")
        self.ver = ver

    def class_info(self, key: str, expect_version=None):
        """Consume first-occurrence class bookkeeping (tracking byte +
        4-byte class version -- class ids are NOT written by binary
        archives); no-op on later occurrences."""
        if key in self.class_versions:
            return
        tracking = self.u(1)
        if tracking not in (0, 1):
            self._err(f"bad tracking byte {tracking} for {key}")
        if tracking:
            self._err(f"{key} unexpectedly tracked (reference uses "
                      "track_never / by-value serialization)")
        ver = self.u(self.lay.version)
        if ver > 10:
            self._err(f"implausible class version {ver} for {key}")
        if expect_version is not None and ver != expect_version:
            self._err(f"{key} class version {ver}, expected "
                      f"{expect_version}")
        self.classes_seen += 1
        self.class_versions[key] = ver

    # -- BigFloat ---------------------------------------------------------
    def _nlimbs(self) -> int:
        return -(-self.prec // (8 * self.lay.limb))

    def bigfloat(self) -> tuple[int, int]:
        """-> (M, E) with value M * 2^E."""
        self.class_info("El::BigFloat")
        if self.class_versions["El::BigFloat"] >= 1:
            if self.u(1):
                return 0, 0
        prec = self.u(self.lay.prec_t)
        if prec != self.prec:
            self._err(f"BigFloat precision {prec} != stream precision "
                      f"{self.prec}")
        sign = self.u(self.lay.sign_t, signed=True)
        exp = self.u(self.lay.exp_t, signed=True)
        n = self._nlimbs()
        M = int.from_bytes(self.take(n * self.lay.limb), "little")
        if sign not in (1, -1):
            self._err(f"bad mpfr sign {sign}")
        return (M if sign > 0 else -M), exp - 64 * n

    def matrix(self, k: int) -> np.ndarray:
        """El::Matrix<BigFloat> -> (height, width, K) f64 words."""
        self.class_info("El::Matrix")
        h = self.u(self.lay.el_int, signed=True)
        w = self.u(self.lay.el_int, signed=True)
        ld = self.u(self.lay.el_int, signed=True)
        if not (0 <= h <= 10**7 and 0 <= w <= 10**7 and ld >= h):
            self._err(f"implausible matrix dims h={h} w={w} ld={ld}")
        out = np.zeros((h, w, k))
        for col in range(w):            # column-major buffer
            for row in range(ld):
                if row < h:
                    M, E = self.bigfloat()
                    out[row, col] = int_exp_to_words(M, E, k)
                else:
                    self.bigfloat()     # LDim padding rows
        return out

    def vector(self, k: int) -> np.ndarray:
        """std::vector<BigFloat> -> (n, K).  Layout: class bookkeeping
        (first occurrence), collection_size_type count (size_t),
        item_version_type (4 bytes), then the elements -- the first of
        which consumes El::BigFloat's own class bookkeeping if no
        BigFloat appeared earlier (e.g. after an empty matrix)."""
        self.class_info("std::vector")
        count = self.u(self.lay.size_t)
        if count > 10**9:
            self._err(f"implausible vector count {count}")
        iv = self.u(self.lay.item_version)
        if iv > 10:
            self._err(f"implausible item_version {iv}")
        out = np.zeros((count, k))
        for i in range(count):
            M, E = self.bigfloat()
            out[i] = int_exp_to_words(M, E, k)
        return out


def read_block_data_bin(buf: bytes, k: int, lay: Layout = LAYOUT):
    """Parse one block_data_<i>.bin -> dict with f64-word arrays
    (B (schur,N,K), c (schur,K), bilinear_bases_even/odd (h,pts,K))."""
    r = BinReader(buf, lay)
    r.header()
    r.prec = r.u(lay.prec_t)
    if not 2 <= r.prec <= 1 << 20:
        r._err(f"implausible precision {r.prec}")
    B = r.matrix(k)
    c = r.vector(k)
    even = r.matrix(k)
    odd = r.matrix(k)
    if r.o != len(r.b):
        r._err(f"{len(r.b) - r.o} trailing bytes")
    return {"B": B, "c": c, "bilinear_bases_even": even,
            "bilinear_bases_odd": odd, "precision": r.prec}


# ---------------------------------------------------------------------------
# Archive writer
# ---------------------------------------------------------------------------

class BinWriter:
    def __init__(self, precision: int, lay: Layout = LAYOUT):
        self.lay = lay
        self.prec = int(precision)
        self.parts: list[bytes] = []
        self.classes_seen = 0
        self.class_versions: dict[str, int] = {}

    def u(self, v: int, n: int, signed=False):
        self.parts.append(int(v).to_bytes(n, "little", signed=signed))

    def header(self):
        self.u(len(_SIGNATURE), self.lay.size_t)
        self.parts.append(_SIGNATURE)
        self.u(self.lay.archive_version, self.lay.lib_version)
        self.u(self.prec, self.lay.prec_t)

    def class_info(self, key: str, version: int):
        """First-occurrence bookkeeping: tracking byte + 4-byte class
        version.  NO class id -- binary archives' save_override for
        class_id_optional_type is a no-op."""
        if key in self.class_versions:
            return
        self.u(0, 1)                       # tracking: never
        self.u(version, self.lay.version)
        self.classes_seen += 1
        self.class_versions[key] = version

    def bigfloat(self, words):
        self.bigfloat_int_exp(*words_to_int_exp(words))

    def bigfloat_int_exp(self, M: int, E: int):
        self.class_info("El::BigFloat", 1)
        if M == 0:
            self.u(1, 1)                   # is_zero
            return
        self.u(0, 1)
        n = -(-self.prec // (8 * self.lay.limb))
        neg = M < 0
        a = -M if neg else M
        b = a.bit_length()
        exp = E + b
        a = _round_shift(a, b - 64 * n)    # mantissa into n limbs (top-aligned)
        if a.bit_length() > 64 * n:        # rounding carried
            a >>= 1
            exp += 1
        # mpfr invariant: bits below prec are zero
        drop = 64 * n - self.prec
        if drop:
            a = _round_shift(a, drop)
            if a.bit_length() > self.prec:
                a >>= 1
                exp += 1
            a <<= drop
        self.u(self.prec, self.lay.prec_t)
        self.u(-1 if neg else 1, self.lay.sign_t, signed=True)
        self.u(exp, self.lay.exp_t, signed=True)
        self.parts.append(a.to_bytes(n * self.lay.limb, "little"))

    def matrix(self, arr):
        self.class_info("El::Matrix", 0)
        h, w = arr.shape[0], arr.shape[1]
        self.u(h, self.lay.el_int, signed=True)
        self.u(w, self.lay.el_int, signed=True)
        self.u(h, self.lay.el_int, signed=True)   # LDim = Height
        for col in range(w):
            for row in range(h):
                self.bigfloat(arr[row, col])

    def vector(self, arr):
        self.class_info("std::vector", 0)
        self.u(arr.shape[0], self.lay.size_t)
        self.u(1, self.lay.item_version)   # item_version = BigFloat version
        for i in range(arr.shape[0]):
            self.bigfloat(arr[i])

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


def write_block_data_bin(B, c, even, odd, precision: int,
                         lay: Layout = LAYOUT) -> bytes:
    """f64-word arrays -> block_data_<i>.bin bytes (field order as in
    `write_block_data.cxx` write_block_data_bin)."""
    w = BinWriter(precision, lay)
    w.header()
    w.matrix(np.asarray(B))
    w.vector(np.asarray(c))
    w.matrix(np.asarray(even))
    w.matrix(np.asarray(odd))
    return w.tobytes()


def mpf_int_exp(v) -> tuple[int, int]:
    """Exact (M, E) of an mpmath mpf (value = M * 2^E)."""
    sign, man, exp, _bc = v._mpf_
    if man == 0:
        return 0, 0
    return (-man if sign else man), exp


def write_block_data_bin_mpf(B, c, even, odd, precision: int, ctx,
                             lay: Layout = LAYOUT) -> bytes:
    """mpmath-valued nested lists -> block_data_<i>.bin bytes.  Exact:
    mpf mantissa/exponent go straight into the mpfr limb encoding."""
    w = BinWriter(precision, lay)
    w.header()

    def big(v):
        w.bigfloat_int_exp(*mpf_int_exp(ctx.mpf(v)))

    def matrix(rows):
        w.class_info("El::Matrix", 0)
        h = len(rows)
        wd = len(rows[0]) if h else 0
        for n in (h, wd, h):
            w.u(n, lay.el_int, signed=True)
        for col in range(wd):
            for row in range(h):
                big(rows[row][col])

    matrix(B)
    w.class_info("std::vector", 0)
    w.u(len(c), lay.size_t)
    w.u(1, lay.item_version)
    for v in c:
        big(v)
    matrix(even)
    matrix(odd)
    return w.tobytes()
