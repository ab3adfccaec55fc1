// The port's native decimal codec: exact decimal-string <-> K-word
// float64 conversion on the host.
//
// Every on-disk number of the reference's formats is a full-precision
// decimal string (GMP stream IO in `src/sdp_solve/SDP/read_block_data/`
// and `src/pmp2sdp/write_block_data.cxx`); the port's solver-side values
// are K-word float64 expansions, from which the limb format is made
// exactly (sdpb_tpu_torch/mp/decimal.py).  The mpmath path of that module
// converts ~1k numbers/s; this library ~1M numbers/s.
//
// All arithmetic is exact big-integer arithmetic on uint64 limbs; the
// only rounding is the final round-to-nearest-even of each extracted
// 53-bit word, which reproduces the greedy splitting of
// `mp/decimal.py::from_mpf` bit for bit (tests/test_torch_native_codec.py
// holds it to an exact Fraction oracle and to the mpmath path).
//
// Built by sdpb_tpu_torch/io/native_codec.py at first use with the host
// C++ compiler (-O3 -fPIC -shared -std=c++17) into csrc/build/.
//
// C ABI (ctypes):
//   int port_dec2words(const char* s, long len, int k, double* out);
//   long port_dec2words_batch(const char* buf, const long* offsets,
//                             long n, int k, double* out);
//   int port_words2dec(const double* w, int k, int digits,
//                      char* out, long cap);

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <vector>
#include <algorithm>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

// Little-endian bignum on 64-bit limbs.
struct Big {
  std::vector<u64> d;

  bool is_zero() const {
    for (u64 v : d) if (v) return false;
    return true;
  }
  void trim() {
    while (!d.empty() && d.back() == 0) d.pop_back();
  }
  int bits() const {
    for (int i = (int)d.size() - 1; i >= 0; --i)
      if (d[i]) return 64 * i + 64 - __builtin_clzll(d[i]);
    return 0;
  }
  // this = this * m + add  (m, add fit in u64)
  void mul_small_add(u64 m, u64 add) {
    u128 carry = add;
    for (auto& limb : d) {
      u128 p = (u128)limb * m + carry;
      limb = (u64)p;
      carry = p >> 64;
    }
    while (carry) {
      d.push_back((u64)carry);
      carry >>= 64;
    }
  }
  // this /= m, returns remainder
  u64 div_small(u64 m) {
    u128 rem = 0;
    for (int i = (int)d.size() - 1; i >= 0; --i) {
      u128 cur = (rem << 64) | d[i];
      d[i] = (u64)(cur / m);
      rem = cur % m;
    }
    trim();
    return (u64)rem;
  }
  void shl(int n) {
    if (is_zero() || n == 0) return;
    int limbs = n / 64, rem = n % 64;
    int old = (int)d.size();
    d.resize(old + limbs + (rem ? 1 : 0), 0);
    // two-pass: shift whole limbs, then bits
    if (limbs) {
      for (int i = old - 1; i >= 0; --i) d[i + limbs] = d[i];
      for (int i = 0; i < limbs; ++i) d[i] = 0;
    }
    if (rem) {
      u64 carry = 0;
      for (size_t i = limbs; i < d.size(); ++i) {
        u64 nc = d[i] >> (64 - rem);
        d[i] = (d[i] << rem) | carry;
        carry = nc;
      }
    }
    trim();
  }
  void shr(int n) {
    if (n == 0) return;
    int limbs = n / 64, rem = n % 64;
    if (limbs >= (int)d.size()) { d.clear(); return; }
    if (limbs) d.erase(d.begin(), d.begin() + limbs);
    if (rem) {
      for (size_t i = 0; i < d.size(); ++i) {
        u64 hi = (i + 1 < d.size()) ? d[i + 1] << (64 - rem) : 0;
        d[i] = (d[i] >> rem) | hi;
      }
    }
    trim();
  }
  // bit i (0 = LSB)
  int bit(int i) const {
    int l = i / 64, r = i % 64;
    if (l >= (int)d.size()) return 0;
    return (d[l] >> r) & 1;
  }
  // true if any bit below position i is set
  bool any_below(int i) const {
    int l = i / 64, r = i % 64;
    for (int j = 0; j < l && j < (int)d.size(); ++j)
      if (d[j]) return true;
    if (l < (int)d.size() && r > 0 && (d[l] & ((~0ull) >> (64 - r))))
      return true;
    return false;
  }
  // top nbits bits as integer (requires bits() >= nbits)
  u64 top_bits(int nbits) const {
    int b = bits();
    Big t = *this;
    t.shr(b - nbits);
    return t.d.empty() ? 0 : t.d[0];
  }
  // compare
  int cmp(const Big& o) const {
    size_t n = std::max(d.size(), o.d.size());
    for (int i = (int)n - 1; i >= 0; --i) {
      u64 a = i < (int)d.size() ? d[i] : 0;
      u64 b = i < (int)o.d.size() ? o.d[i] : 0;
      if (a != b) return a < b ? -1 : 1;
    }
    return 0;
  }
};

// exact subtraction with borrow done properly
void big_sub(Big& a, const Big& b) {
  // requires a >= b
  u128 borrow = 0;
  for (size_t i = 0; i < a.d.size(); ++i) {
    u128 bv = (i < b.d.size() ? b.d[i] : 0);
    u128 av = a.d[i];
    u128 rhs = bv + borrow;
    if (av >= rhs) {
      a.d[i] = (u64)(av - rhs);
      borrow = 0;
    } else {
      a.d[i] = (u64)((((u128)1 << 64) + av) - rhs);
      borrow = 1;
    }
  }
  a.trim();
}

// multiply by 5^e using chunks of 5^27 (< 2^63)
void mul_pow5(Big& m, long e) {
  static const u64 P5[28] = {
      1ull,
      5ull, 25ull, 125ull, 625ull, 3125ull, 15625ull, 78125ull,
      390625ull, 1953125ull, 9765625ull, 48828125ull, 244140625ull,
      1220703125ull, 6103515625ull, 30517578125ull, 152587890625ull,
      762939453125ull, 3814697265625ull, 19073486328125ull,
      95367431640625ull, 476837158203125ull, 2384185791015625ull,
      11920928955078125ull, 59604644775390625ull, 298023223876953125ull,
      1490116119384765625ull, 7450580596923828125ull};
  while (e >= 27) {
    m.mul_small_add(P5[27], 0);
    e -= 27;
  }
  if (e > 0) m.mul_small_add(P5[e], 0);
}

// divide by 5^e (truncating)
void div_pow5(Big& m, long e) {
  static const u64 P5_27 = 7450580596923828125ull;
  static const u64 P5[28] = {
      1ull,
      5ull, 25ull, 125ull, 625ull, 3125ull, 15625ull, 78125ull,
      390625ull, 1953125ull, 9765625ull, 48828125ull, 244140625ull,
      1220703125ull, 6103515625ull, 30517578125ull, 152587890625ull,
      762939453125ull, 3814697265625ull, 19073486328125ull,
      95367431640625ull, 476837158203125ull, 2384185791015625ull,
      11920928955078125ull, 59604644775390625ull, 298023223876953125ull,
      1490116119384765625ull, 7450580596923828125ull};
  while (e >= 27) {
    m.div_small(P5_27);
    e -= 27;
  }
  if (e > 0) m.div_small(P5[e]);
}

// Round the value M * 2^E to the nearest double (ties to even).
// Returns the double; M is not modified.
double round_to_double(const Big& M, long E) {
  int b = M.bits();
  if (b == 0) return 0.0;
  // want top 53 bits
  long msb_pos = E + b - 1;  // exponent of the leading bit
  if (msb_pos > 1023) return HUGE_VAL;
  if (msb_pos == -1075) {
    // in [2^-1075, 2^-1074): round-to-nearest-even gives the minimum
    // subnormal iff the value exceeds the midpoint 2^-1075
    return M.any_below(b - 1) ? 0x1p-1074 : 0.0;
  }
  if (msb_pos < -1074) return 0.0;
  int take = 53;
  // subnormal range: fewer mantissa bits available
  if (msb_pos < -1022) take = 53 + (int)(msb_pos + 1022);
  if (take <= 0) return 0.0;
  u64 mant;
  bool round_up = false;
  if (b <= take) {
    mant = M.top_bits(b) << (take - b);
  } else {
    mant = M.top_bits(take);
    int below = b - take;           // first dropped bit index + 1
    int guard = M.bit(below - 1);
    bool sticky = M.any_below(below - 1);
    if (guard && (sticky || (mant & 1))) round_up = true;
  }
  if (round_up) {
    mant += 1;
    if (mant >> take) {  // carry out: mantissa overflow
      mant >>= 1;
      msb_pos += 1;
      if (msb_pos > 1023) return HUGE_VAL;
    }
  }
  // value = mant * 2^(msb_pos - take + 1)
  return std::ldexp((double)mant, (int)(msb_pos - take + 1));
}

// Exact signed value V = sign * M * 2^E; subtract double w (|w| has
// 53-bit mantissa) exactly.  Updates (sign, M, E).
void subtract_double(int& sign, Big& M, long& E, double w) {
  if (w == 0.0) return;
  int wsign = w < 0 ? -1 : 1;
  double aw = std::fabs(w);
  int exp2;
  double fr = std::frexp(aw, &exp2);      // aw = fr * 2^exp2, fr in [0.5,1)
  u64 wm = (u64)std::ldexp(fr, 53);        // 53-bit integer
  long wE = exp2 - 53;
  // align exponents
  long newE = std::min(E, wE);
  Big Wb;
  Wb.d.push_back(wm);
  Wb.shl((int)(wE - newE));
  M.shl((int)(E - newE));
  E = newE;
  if (sign == wsign) {
    // |V| - |w| (w came from rounding V's top, so result may flip sign)
    if (M.cmp(Wb) >= 0) {
      big_sub(M, Wb);
    } else {
      big_sub(Wb, M);
      M = Wb;
      sign = -sign;
    }
  } else {
    // |V| + |w|
    // addition: reuse sub-style loop
    u128 carry = 0;
    size_t n = std::max(M.d.size(), Wb.d.size());
    M.d.resize(n + 1, 0);
    for (size_t i = 0; i < n; ++i) {
      u128 s = (u128)M.d[i] + (i < Wb.d.size() ? Wb.d[i] : 0) + carry;
      M.d[i] = (u64)s;
      carry = s >> 64;
    }
    M.d[n] = (u64)carry;
    M.trim();
  }
  if (M.is_zero()) sign = 1;
}

// Parse decimal into sign, digit bignum, decimal exponent.
// Accepts [+-]ddd[.ddd][eE[+-]dd], leading/trailing spaces.
bool parse_decimal(const char* s, long len, int& sign, Big& M, long& e10) {
  long i = 0;
  while (i < len && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n')) ++i;
  sign = 1;
  if (i < len && (s[i] == '+' || s[i] == '-')) {
    if (s[i] == '-') sign = -1;
    ++i;
  }
  M.d.clear();
  M.d.push_back(0);
  long frac_digits = 0;
  bool seen_dot = false, any_digit = false;
  u64 chunk = 0;
  int chunk_len = 0;
  auto flush = [&]() {
    static const u64 POW10[10] = {1ull, 10ull, 100ull, 1000ull, 10000ull,
                                  100000ull, 1000000ull, 10000000ull,
                                  100000000ull, 1000000000ull};
    if (chunk_len) M.mul_small_add(POW10[chunk_len], chunk);
    chunk = 0;
    chunk_len = 0;
  };
  for (; i < len; ++i) {
    char c = s[i];
    if (c >= '0' && c <= '9') {
      any_digit = true;
      chunk = chunk * 10 + (c - '0');
      if (++chunk_len == 9) flush();
      if (seen_dot) ++frac_digits;
    } else if (c == '.') {
      if (seen_dot) return false;
      seen_dot = true;
    } else if (c == 'e' || c == 'E') {
      break;
    } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      break;
    } else {
      return false;
    }
  }
  flush();
  if (!any_digit) return false;
  long exp_part = 0;
  if (i < len && (s[i] == 'e' || s[i] == 'E')) {
    ++i;
    int esign = 1;
    if (i < len && (s[i] == '+' || s[i] == '-')) {
      if (s[i] == '-') esign = -1;
      ++i;
    }
    bool any = false;
    for (; i < len; ++i) {
      if (s[i] >= '0' && s[i] <= '9') {
        exp_part = exp_part * 10 + (s[i] - '0');
        any = true;
      } else if (s[i] == ' ' || s[i] == '\t' || s[i] == '\n'
                 || s[i] == '\r') {
        break;
      } else {
        return false;
      }
    }
    if (!any) return false;
    exp_part *= esign;
  }
  e10 = exp_part - frac_digits;
  M.trim();
  return true;
}

}  // namespace

extern "C" {

// Convert one decimal string to k float64 words (greedy extraction,
// round-to-nearest-even per word).  Returns 0 on success.
int port_dec2words(const char* s, long len, int k, double* out) {
  int sign;
  Big M;
  long e10;
  if (!parse_decimal(s, len, sign, M, e10)) return 1;
  for (int i = 0; i < k; ++i) out[i] = 0.0;
  if (M.is_zero()) return 0;

  long E;  // value = sign * M * 2^E  (after 10^e10 folded in)
  int guard_bits = 64 * ((53 * k + 128) / 64);
  if (e10 >= 0) {
    mul_pow5(M, e10);
    E = e10;
  } else {
    // M * 10^e10 = M * 2^e10 / 5^|e10|
    // scale up so truncation error is far below k words
    long need = guard_bits + (long)(2.33 * (double)(-e10)) + 64;
    M.shl((int)need);
    div_pow5(M, -e10);
    E = e10 - need;
  }

  for (int i = 0; i < k; ++i) {
    double w = round_to_double(M, E) * sign;
    out[i] = w;
    if (w == 0.0 || !std::isfinite(w)) break;
    subtract_double(sign, M, E, w);
    if (M.is_zero()) break;
  }
  return 0;
}

// Batch conversion: strings concatenated in buf, offsets has n+1
// entries.  Returns number converted, or -1-index of first failure.
long port_dec2words_batch(const char* buf, const long* offsets, long n,
                          int k, double* out) {
  for (long i = 0; i < n; ++i) {
    int rc = port_dec2words(buf + offsets[i], offsets[i + 1] - offsets[i],
                            k, out + (long)i * k);
    if (rc != 0) return -1 - i;
  }
  return n;
}

// Convert k words to a decimal string with `digits` significant digits
// (round-half-up on the last digit), scientific notation with
// stripped trailing zeros ("-1.23e-10").  Returns length, or -1 if
// cap too small / non-finite input.
int port_words2dec(const double* w, int k, int digits, char* out,
                   long cap) {
  // exact sum: find min exponent
  int sign = 1;
  Big M;
  long E = 0;
  bool started = false;
  for (int i = 0; i < k; ++i) {
    double v = w[i];
    if (v == 0.0) continue;
    if (!std::isfinite(v)) return -1;
    if (!started) {
      int exp2;
      double fr = std::frexp(std::fabs(v), &exp2);
      M.d.assign(1, (u64)std::ldexp(fr, 53));
      E = exp2 - 53;
      sign = v < 0 ? -1 : 1;
      started = true;
    } else {
      // subtract_double adds when signs differ; to ADD v, subtract -v
      subtract_double(sign, M, E, -v);
    }
  }
  if (!started || M.is_zero()) {
    if (cap < 2) return -1;
    out[0] = '0';
    out[1] = 0;
    return 1;
  }

  // digits <= 0: choose enough digits to round-trip the exact sum.
  // The span of the expansion is exactly bits(M) (M holds every bit
  // down to the last word's ulp), and an n-bit value round-trips in
  // ceil(n*log10(2)) + 2 decimal digits.
  if (digits <= 0)
    digits = (int)std::ceil(M.bits() * 0.30102999566398119521) + 2;

  // decimal exponent estimate: log10(M * 2^E)
  int b = M.bits();
  double log10v = (b - 1 + (double)E) * 0.30102999566398119521 + 0.0;
  long d10 = (long)std::floor(log10v);
  // target integer D = round(|v| * 10^(digits-1-d10)); may need fixup
  auto compute_D = [&](long dec_shift, Big& D) -> void {
    // D = M * 2^E * 10^dec_shift, rounded to nearest int
    D = M;
    long e2 = E;
    if (dec_shift >= 0) {
      mul_pow5(D, dec_shift);
      e2 += dec_shift;
    } else {
      long need = (long)(2.33 * (double)(-dec_shift)) + 64;
      D.shl((int)need);
      div_pow5(D, -dec_shift);
      e2 += dec_shift - need;
    }
    if (e2 >= 0) {
      D.shl((int)e2);
    } else {
      // round at the 2^-e2 boundary
      int cut = (int)(-e2);
      int r = (cut <= D.bits()) ? D.bit(cut - 1) : 0;
      D.shr(cut);
      if (r) D.mul_small_add(1, 1);
    }
  };

  Big D;
  compute_D(digits - 1 - d10, D);
  // fixup: D should have exactly `digits` decimal digits
  // count digits of D
  auto count_digits = [](Big x) -> long {
    long c = 0;
    while (!x.is_zero()) {
      x.div_small(10);
      ++c;
    }
    return c;
  };
  long nd = count_digits(D);
  while (nd > digits) {
    ++d10;
    compute_D(digits - 1 - d10, D);
    nd = count_digits(D);
  }
  while (nd < digits && nd > 0) {
    --d10;
    compute_D(digits - 1 - d10, D);
    nd = count_digits(D);
  }

  // extract digits (LSB first)
  std::vector<char> ds;
  Big tmp = D;
  while (!tmp.is_zero()) {
    ds.push_back((char)('0' + tmp.div_small(10)));
  }
  if (ds.empty()) ds.push_back('0');
  std::reverse(ds.begin(), ds.end());
  // strip trailing zeros
  long keep = (long)ds.size();
  while (keep > 1 && ds[keep - 1] == '0') --keep;

  // format: [-]d[.ddd]e<exp>
  char expbuf[32];
  std::snprintf(expbuf, sizeof(expbuf), "%ld", d10);
  long need = (sign < 0 ? 1 : 0) + 1 + (keep > 1 ? 1 + (keep - 1) : 0) + 1
              + (long)std::strlen(expbuf) + 1;
  if (cap < need) return -1;
  long p = 0;
  if (sign < 0) out[p++] = '-';
  out[p++] = ds[0];
  if (keep > 1) {
    out[p++] = '.';
    for (long i = 1; i < keep; ++i) out[p++] = ds[i];
  }
  out[p++] = 'e';
  for (const char* c = expbuf; *c; ++c) out[p++] = *c;
  out[p] = 0;
  return (int)p;
}

}  // extern "C"
