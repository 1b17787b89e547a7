// Native host-side exact CRT data plane.
//
// The TPU device data plane is pure uint32 RNS; the plaintext boundary
// (CKKS exact decode, BFV decode, noise measurement) needs exact big-int
// CRT reconstruction over all N coefficients. The reference gets this
// from Go's math/big (e.g. lattigo DecodeInt; noise checks at
// mkrlwe/mkrlwe_test.go:92-155); the round-1 build used python ints,
// which costs seconds per decode at logN=15. This module is the native
// equivalent: fixed-width multiprecision over 32-bit words with 64-bit
// accumulation, compiled with g++ and loaded via ctypes
// (mkhe_tpu/native/__init__.py). No external dependencies.
//
// Layout: little-endian 32-bit word arrays. W = word count of Q.
// Per-modulus CRT constants C_i = (Q/q_i) * ((Q/q_i)^-1 mod q_i) mod Q
// are precomputed in Python and passed in as W-word arrays.
// Capacity: W <= 63 (logQ <= ~2000 bits), far above the framework's
// largest parameter sets (logQP ~ 900).

#include <cstdint>
#include <cstring>

namespace {

using u32 = uint32_t;
using u64 = uint64_t;

constexpr int MAXW = 64;

// acc[0..w] += x * c[0..w-1], lazy 64-bit words (each call adds < 2^33
// per word; safe for any realistic limb count L)
inline void mul_add_scalar(u64 *acc, const u32 *c, u32 x, int w) {
  u64 carry = 0;
  for (int k = 0; k < w; ++k) {
    u64 p = (u64)x * c[k];
    acc[k] += (p & 0xffffffffu) + carry;
    carry = p >> 32;
  }
  acc[w] += carry;
}

// lazy 64-bit words (w1 of them) -> canonical 32-bit words (w1+1, with
// the final carry in out[w1])
inline void normalize(const u64 *acc, u32 *out, int w1) {
  u64 carry = 0;
  for (int k = 0; k < w1; ++k) {
    u64 v = acc[k] + carry;  // acc[k] < L*2^33 + ..., carry < 2^32: ok
    out[k] = (u32)v;
    carry = v >> 32;
  }
  out[w1] = (u32)carry;
}

inline int cmp_words(const u32 *a, const u32 *b, int w) {
  for (int k = w - 1; k >= 0; --k)
    if (a[k] != b[k]) return a[k] < b[k] ? -1 : 1;
  return 0;
}

// a -= b (requires a >= b)
inline void sub_words(u32 *a, const u32 *b, int w) {
  u64 borrow = 0;
  for (int k = 0; k < w; ++k) {
    u64 d = (u64)a[k] - b[k] - borrow;
    a[k] = (u32)d;
    borrow = (d >> 63) & 1;
  }
}

// val (w+1 words, any value with val/Q < 2^64) := val mod Q (w words,
// Q[w-1] != 0); returns floor(val/Q). Single-word quotient estimates
// from the top 64 bits against Q[w-1]+1 — always an UNDERestimate
// (since Q < (Q[w-1]+1) * 2^(32(w-1))), so the subtraction never
// underflows and the loop converges geometrically; the tail finishes
// with conditional subtracts.
inline u64 div_mod(u32 *val, const u32 *Q, int w) {
  u64 quot = 0;
  while (true) {
    u64 top = ((u64)val[w] << 32) | val[w - 1];
    u64 qhat = top / ((u64)Q[w - 1] + 1);
    if (qhat == 0) break;
    if (qhat > 0xffffffffu) qhat = 0xffffffffu;
    // val -= qhat * Q
    u64 borrow = 0, mul_carry = 0;
    for (int k = 0; k < w; ++k) {
      u64 p = qhat * Q[k] + mul_carry;  // < 2^64 (qhat, Q[k] < 2^32)
      mul_carry = p >> 32;
      u64 d = (u64)val[k] - (u32)p - borrow;
      val[k] = (u32)d;
      borrow = (d >> 63) & 1;
    }
    val[w] = (u32)((u64)val[w] - mul_carry - borrow);
    quot += qhat;
  }
  while (val[w] != 0 || cmp_words(val, Q, w) >= 0) {
    u64 borrow = 0;
    for (int k = 0; k < w; ++k) {
      u64 d = (u64)val[k] - Q[k] - borrow;
      val[k] = (u32)d;
      borrow = (d >> 63) & 1;
    }
    val[w] = (u32)((u64)val[w] - borrow);
    quot += 1;
  }
  return quot;
}

// val (nw words) := val mod Q — schoolbook sliding-window reduction for
// values wider than w+1 words (Σ x_i * C_i can reach L * 2^32 * Q)
inline void mod_only(u32 *val, int nw, const u32 *Q, int w) {
  for (int off = nw - 1 - w; off >= 0; --off) {
    while (true) {
      u64 top = ((u64)val[off + w] << 32) | val[off + w - 1];
      u64 qhat = top / ((u64)Q[w - 1] + 1);
      if (qhat == 0) break;
      if (qhat > 0xffffffffu) qhat = 0xffffffffu;
      u64 borrow = 0, mul_carry = 0;
      for (int k = 0; k < w; ++k) {
        u64 p = qhat * Q[k] + mul_carry;
        mul_carry = p >> 32;
        u64 d = (u64)val[off + k] - (u32)p - borrow;
        val[off + k] = (u32)d;
        borrow = (d >> 63) & 1;
      }
      val[off + w] = (u32)((u64)val[off + w] - mul_carry - borrow);
    }
    // window top word is now 0; finish the window with cond-subtracts
    while (val[off + w] != 0 || cmp_words(val + off, Q, w) >= 0) {
      u64 borrow = 0;
      for (int k = 0; k < w; ++k) {
        u64 d = (u64)val[off + k] - Q[k] - borrow;
        val[off + k] = (u32)d;
        borrow = (d >> 63) & 1;
      }
      val[off + w] = (u32)((u64)val[off + w] - borrow);
    }
  }
}

// CRT-reconstruct coefficient j into val (w+2 words; result < Q in the
// low w words)
inline void reconstruct(const u32 *limbs, int L, int64_t N, int64_t j,
                        const u32 *consts, const u32 *Q, int w, u32 *val) {
  u64 acc[MAXW + 1];
  std::memset(acc, 0, sizeof(u64) * (w + 1));
  for (int i = 0; i < L; ++i)
    mul_add_scalar(acc, consts + (int64_t)i * w, limbs[i * N + j], w);
  normalize(acc, val, w + 1);  // w+2 canonical words
  mod_only(val, w + 2, Q, w);
}

inline double words_to_double(const u32 *a, int w) {
  long double x = 0.0L;
  for (int k = w - 1; k >= 0; --k) x = x * 4294967296.0L + a[k];
  return (double)x;
}

}  // namespace

extern "C" {

// CKKS exact decode: reconstruct, center into (-Q/2, Q/2], cast double.
//   limbs (L, N) u32 row-major; consts (L, W); Q, halfQ (W,); out (N,) f64
void crt_center_double(const u32 *limbs, int32_t L, int64_t N,
                       const u32 *consts, const u32 *Q, const u32 *halfQ,
                       int32_t W, double *out) {
  u32 val[MAXW + 1];
  u32 tmp[MAXW];
  for (int64_t j = 0; j < N; ++j) {
    reconstruct(limbs, L, N, j, consts, Q, W, val);
    if (cmp_words(val, halfQ, W) > 0) {
      std::memcpy(tmp, Q, sizeof(u32) * W);
      sub_words(tmp, val, W);
      out[j] = -words_to_double(tmp, W);
    } else {
      out[j] = words_to_double(val, W);
    }
  }
}

// BFV decode scaling: out_j = round(t * c_j / Q) mod t, exact.
void bfv_decode_scale(const u32 *limbs, int32_t L, int64_t N,
                      const u32 *consts, const u32 *Q, const u32 *halfQ,
                      int32_t W, u32 t, u32 *out) {
  u32 val[MAXW + 1];
  for (int64_t j = 0; j < N; ++j) {
    reconstruct(limbs, L, N, j, consts, Q, W, val);  // c_j in [0, Q)
    // z = t*c + Q/2 over W+1 words (t < 2^32 so z/Q < 2^33: div_mod ok)
    u64 carry = 0;
    for (int k = 0; k < W; ++k) {
      u64 p = (u64)t * val[k] + carry + halfQ[k];
      val[k] = (u32)p;
      carry = p >> 32;
    }
    val[W] = (u32)carry;  // t*Q + Q/2 < 2^(32(W+1)) for t < 2^32
    u64 m = div_mod(val, Q, W);
    out[j] = (u32)(m % t);
  }
}

// Noise measurement: max bit length of |centered c_j| over all j
// (analog of the reference's log2OfInnerSum, mkrlwe_test.go:92-155).
int32_t crt_max_bits(const u32 *limbs, int32_t L, int64_t N,
                     const u32 *consts, const u32 *Q, const u32 *halfQ,
                     int32_t W) {
  u32 val[MAXW + 1];
  u32 mag[MAXW];
  int best = 0;
  for (int64_t j = 0; j < N; ++j) {
    reconstruct(limbs, L, N, j, consts, Q, W, val);
    if (cmp_words(val, halfQ, W) > 0) {
      std::memcpy(mag, Q, sizeof(u32) * W);
      sub_words(mag, val, W);
    } else {
      std::memcpy(mag, val, sizeof(u32) * W);
    }
    for (int k = W - 1; k >= 0; --k) {
      if (mag[k]) {
        int bits = 32 * k + (32 - __builtin_clz(mag[k]));
        if (bits > best) best = bits;
        break;
      }
    }
  }
  return best;
}

}  // extern "C"
