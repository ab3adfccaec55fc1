"""The port's native decimal codec (sdpb_tpu_torch/csrc/codec.cpp via
io/native_codec.py) against sdpb_tpu's codec, the port's mpmath path
and an exact Fraction oracle, on the CPU.

The words must agree bit for bit with all three; where sdpb_tpu's
codec is not built, with the oracle and the mpmath path only (as
tests/test_native_codec.py skips).  Then mp/decimal.py: routed through
the codec, and bit-equal to its mpmath path with the codec taken away.
"""

import numpy as np
import pytest

from sdpb_tpu.io import native_codec as jnc
from sdpb_tpu.mp import decimal as jdec
from sdpb_tpu_torch.io import native_codec as nc
from sdpb_tpu_torch.mp import decimal as tdec

from test_native_codec import _random_cases, exact_words  # noqa: E402

pytestmark = pytest.mark.skipif(not nc.available(),
                                reason="no host C++ compiler")


def _mpmath_words(s, k):
    """The port's mpmath path of from_decimal."""
    return tdec.from_mpf(tdec._ctx(k).mpf(s.strip()), k)


def _bits(w):
    return np.asarray(w, dtype=np.float64).tobytes()


# The mpmath path parses at 53K + 40 bits, so above K = 8 it is not
# exact where the greedy words span more bits than that: of the 412
# cases it differs from the exact oracle in 5 at K = 15, 46 at K = 20
# and 6 at K = 54 (MPMATH_INEXACT_CASES; at K = 54 the same value, with
# underflowed words placed differently).  Both word sums then lie
# within the half ulp of their K-th word of the value, at most 2^-53K
# relative: the bound held there.
MPMATH_EXACT_K = 8
MPMATH_INEXACT_CASES = {15: 5, 20: 46, 54: 6}


@pytest.mark.parametrize("k", [2, 4, 8, 15, 20, 54])
def test_words_bit_for_bit(k):
    """The codec's words equal sdpb_tpu's codec's bit for bit (zeros'
    signs included) and the exact oracle's (which gives -0.0 where a
    negative remainder underflows, the codec +0.0); the mpmath path's
    equal them up to K = 8 and lie within 2^-53K relative above."""
    cases = _random_cases(400)
    got = nc.dec2words_batch(cases, k)
    jax = jnc.dec2words_batch(cases, k) if jnc.available() else None
    ctx = tdec._ctx(k + 2)
    inexact = 0
    for i, s in enumerate(cases):
        assert np.array_equal(got[i], exact_words(s, k)), s
        if jax is not None:
            assert _bits(got[i]) == _bits(jax[i]), s
        slow = _mpmath_words(s, k)
        if k <= MPMATH_EXACT_K:
            assert np.array_equal(got[i], slow), s
        elif not np.array_equal(got[i], slow):
            inexact += 1
            a, b = tdec.to_mpf(got[i], ctx), tdec.to_mpf(slow, ctx)
            assert abs(a - b) <= abs(a) * ctx.ldexp(1, -53 * k), s
    assert inexact == MPMATH_INEXACT_CASES.get(k, 0)


def test_batch_equals_singles():
    cases = _random_cases(50, seed=3)
    batch = nc.dec2words_batch(cases, 6)
    for i, s in enumerate(cases):
        assert np.array_equal(nc.dec2words(s, 6), batch[i])


@pytest.mark.parametrize("k", [2, 4, 8, 20])
def test_words2dec_round_trip_and_text_equal_to_sdpb_tpu(k):
    cases = _random_cases(300, emin=-150, emax=60, seed=1)
    words = nc.dec2words_batch(cases, k)
    for i in range(len(cases)):
        d = nc.words2dec(words[i])
        assert np.array_equal(nc.dec2words(d, k), words[i]), (cases[i], d)
        if jnc.available():
            assert d == jnc.words2dec(words[i])
        assert nc.words2dec(words[i], 12) == (
            jnc.words2dec(words[i], 12) if jnc.available() else
            nc.words2dec(words[i], 12))


def test_bad_input_raises():
    with pytest.raises(ValueError):
        nc.dec2words("not-a-number", 4)
    with pytest.raises(ValueError, match="element 1"):
        nc.dec2words_batch(["1.5", "1.5.5", "2"], 4)
    assert nc.words2dec(np.array([np.nan, 0.0])) is None


def test_library_is_the_ports_own():
    path = nc.library_path()
    assert path.parent == nc.BUILD_DIR and path.exists()
    assert path.name.startswith("libport_codec_")
    assert "libsdpb_tpu" not in path.name


def test_mp_decimal_goes_through_the_codec(monkeypatch):
    calls = []
    for name in ("dec2words", "dec2words_batch", "words2dec"):
        fn = getattr(nc, name)
        monkeypatch.setattr(nc, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    w = tdec.from_decimal("0.1", 5)
    tdec.array_from_decimal([["1", "2"]], 5)
    tdec.to_decimal(w)
    assert calls == ["dec2words", "dec2words_batch", "words2dec"]


def test_mp_decimal_equal_without_the_codec(monkeypatch):
    """The codec and the mpmath path give the same words; the strings
    differ in form only (the codec writes 1.5e0, mpmath 1.5) and parse
    to the same words."""
    cases = _random_cases(50, seed=7)
    k = 5
    native = tdec.array_from_decimal(cases, k)
    singles = np.stack([tdec.from_decimal(s, k) for s in cases])
    texts = [tdec.to_decimal(native[i]) for i in range(len(cases))]
    monkeypatch.setattr(nc, "available", lambda: False)
    fallback = tdec.array_from_decimal(cases, k)
    assert np.array_equal(native, fallback)
    assert np.array_equal(singles, fallback)
    for i, text in enumerate(texts):
        assert np.array_equal(tdec.from_decimal(text, k), native[i])
        assert np.array_equal(tdec.from_decimal(tdec.to_decimal(native[i]),
                                                k), native[i])


@pytest.mark.skipif(not jnc.available(), reason="sdpb_tpu's codec not built")
def test_to_decimal_text_equal_to_sdpb_tpu():
    """The files both packages write hold the same text: each package's
    to_decimal on the same float64 words."""
    words = nc.dec2words_batch(_random_cases(100, seed=11), 4)
    for w in words:
        assert tdec.to_decimal(w) == jdec.to_decimal(w)
    assert tdec.to_decimal(np.zeros(3)) == jdec.to_decimal(np.zeros(3))


def test_no_compiler_falls_back_to_mpmath(monkeypatch, tmp_path):
    monkeypatch.setattr(nc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nc, "_compiler", lambda: None)
    monkeypatch.setattr(nc, "_lib", None)
    monkeypatch.setattr(nc, "_tried", False)
    assert not nc.available()
    assert nc.dec2words("1.5", 3) is None
    assert nc.words2dec(np.ones(2)) is None
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        nc.build()
    assert np.array_equal(tdec.from_decimal("0.1", 3),
                          exact_words("0.1", 3))
    assert tdec.to_decimal(np.array([1.5, 0.0])) == "1.5"
