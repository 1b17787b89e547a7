// The forward DIF machinery of the split decimation for Hopper (sm_90a),
// shared by ntt_variant.cu (the NTT cost probe) and ntt_split.cu (the split
// forward NTT's head): twist by psi^j, then DIF stages on the stage-packed
// wpack table, as register radix passes from the top bit down (ntt.cu's
// design: 2^kLogVals values a thread, up to 5 stages a pass in registers,
// padded conflict-free shared memory between passes, packed 8-byte twiddles
// w | w_sh << 32 in natural order, lazy Shoup products below 2q).
//
// A pass over bits [lo, lo + R) of every polynomial of a block reads HBM
// (with the twist) when it is the first, and writes HBM (canonical) when it
// is the last; else it reads and writes the block's shared memory, where
// coefficient i of the block lies at word padded(i) = i + i / 32. The split
// kernel ends its head passes in shared memory (passes<..., kOut = false>)
// and runs its tail on them there.
//
// Twiddles. DIF takes its twiddle by the low bits of j (j mod h), so in a
// pass at lo >= 5 every lane of a warp needs its own twiddles: loaded as
// they are, that is 2^J 8-byte loads in stage J (31 a pass for 32 values),
// and at logN 15 the pass at bit 10 reads each of the 31,744 entries of
// stages 10..14 once a polynomial from L2 (half again the polynomial's
// own HBM bytes), which no L1 reuse hides. Instead (`stage`) a lane
// splits its twiddle W_B^(low << lo | jl) into W_J^low, an entry of the
// small stage-J table that every thread of the limb shares (a broadcast
// from L1, 16-byte pairs), and its root W_B^jl, one load a stage: 5 lane
// loads a pass instead of 31, and 5 x 1,024 distinct entries at bit 10
// instead of 31,744. Both factors come from the table with their Shoup
// quotients, so the price is a second lazy product where low > 0 (49 more
// products for 80 butterflies a pass) and nothing is generated.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dif {

constexpr int kLogVals = 5;      // a thread holds 2^5 coefficients
constexpr int kMaxPassBits = 5;  // stages of one register pass

struct Args {
  const int64_t* x;
  int64_t* out;
  const uint64_t* twist;  // (L, N): twist | twist_shoup << 32
  const uint64_t* wpack;  // (L, N): wpack | wpack_shoup << 32
  const int64_t* q;
  int n_polys, L, log_polys, limb_major;
};

// a - m if a >= m else a, for a < 2m < 2^32.
__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t m) {
  return min(a, a - m);
}

// a * w mod q in [0, 2q) for any a < 2^32, w < q, wsh = floor(w 2^32 / q).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint64_t w,
                                               uint32_t q) {
  return a * static_cast<uint32_t>(w) -
         __umulhi(a, static_cast<uint32_t>(w >> 32)) * q;
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// 0 for every value the kernel holds (all below 4q < 2^32 - 4), which the
// compiler cannot prove.
__device__ __forceinline__ uint32_t never(uint32_t x) {
  return x == 0xFFFFFFFFu;
}

// Global loads that the compiler issues as written: the kept stages load
// twiddles they do not all use, and no load may be folded into the select
// that keeps one.
__device__ __forceinline__ uint64_t ld_kept(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.global.nc.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ ulonglong2 ld_kept2(const uint64_t* p) {
  ulonglong2 v;
  asm volatile("ld.global.nc.v2.u64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y)
               : "l"(p));
  return v;
}

// Index in the block's coefficient array of the value a thread keeps in
// register (g, c) during a pass over bits [lo, lo + r) (ntt.cu::value_index).
__device__ __forceinline__ int value_index(int thread, int threads, int g,
                                           int c, int lo, int r) {
  const int o = g * threads + thread;
  return ((o >> lo) << (lo + r)) | (c << lo) | (o & ((1 << lo) - 1));
}

// Offset of register c's word from its group's padded base in a pass over
// bits [lo, lo + R) (ntt.cu::offset): kMode 0 (lo = 0) c; 1 (lo >= 5) c *
// stride; 2 the general form.
template <int kMode>
__device__ __forceinline__ int offset(int c, int lo, int stride) {
  if (kMode == 0) return c;
  if (kMode == 1) return c * stride;
  const int t = c << lo;
  return t + (t >> 5);
}

// The polynomial of block-local coefficient e, in the launch's block order.
struct Poly {
  size_t base;  // index of its coefficient 0 in x and out
  int limb;
  bool valid;   // the last block may be short
};

template <int kLogN>
__device__ __forceinline__ Poly poly_of(const Args& a, int e) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) << a.log_polys) + (e >> kLogN);
  int64_t p = r;
  if (a.limb_major) {
    const int64_t b = a.n_polys / a.L;
    p = (r % b) * a.L + r / b;
  }
  return Poly{static_cast<size_t>(p) << kLogN, static_cast<int>(p % a.L),
              r < a.n_polys};
}

// Stage bit B = kLo + J of a register pass over bits [kLo, kLo + R): the
// butterflies (c0, c0 + 2^J) of the 2^R values; the bottom of (c0, c1) is
// position j = j0 | c1 << kLo of its polynomial and takes the twiddle
// W_B^(j mod h) = t[(c0 mod 2^J) << kLo | jl] of the stage's table
// t = wpack + N - 2h (h = 2^B, W_B = t[1] a primitive 2h-th root),
// jl = j0 mod 2^kLo, low = c0 mod 2^J. How a lane obtains it:
// - kLo = 0: t[low], shared by every thread, in 16-byte pairs;
// - kLo in 1..4: t[low << kLo | jl], a lane's own;
// - kLo >= 5: W_B^(low << kLo | jl) = W_J^low W_B^jl, since
//   W_B^(2^kLo) = W_J. W_J^low is entry low of stage J's table, the same
//   for every thread of the limb (a broadcast, in 16-byte pairs, from L1);
//   W_B^jl = t[jl] is the lane's root, one load a stage. The bottom is
//   (d W_J^low) W_B^jl, two lazy Shoup products (one at low = 0), each
//   with a quotient from the table, so nothing is generated.
// With kX off each value is its own partner.
template <int kLogN, int kLo, int R, int J, bool kX, bool kMul>
__device__ __forceinline__ void stage(uint32_t (&v)[1 << R],
                                      const uint64_t* tw, int jl, uint32_t q,
                                      uint32_t q2, uint32_t z) {
  constexpr int B = kLo + J;
  constexpr bool kW = kMul && B > 0;
  constexpr bool kGen = kW && kLo >= 5;
  constexpr bool kShared = kW && (kLo == 0 || kGen) && J > 0;
  const uint64_t* t = tw + ((1 << kLogN) - (2 << B)) + jl;
  const uint64_t* ts = tw + ((1 << kLogN) - (2 << J));  // W_J^low
  const uint64_t r = kGen ? __ldg(t) : 0;
  ulonglong2 w2;
#pragma unroll
  for (int low = 0; low < (1 << J); ++low) {
    uint64_t w = 0;
    if (kShared) {
      if (low % 2 == 0)
        w2 = __ldg(reinterpret_cast<const ulonglong2*>(ts + low));
      w = low % 2 ? w2.y : w2.x;
    } else if (kW && !kGen) {
      w = __ldg(t + (low << kLo));
    }
#pragma unroll
    for (int hi = 0; hi < (1 << (R - 1 - J)); ++hi) {
      const int c0 = (hi << (J + 1)) | low;
      const int c1 = c0 | (1 << J);
      const uint32_t x = v[c0], y = v[c1];
      const uint32_t d = (kX ? x : y ^ z) - y + q2;
      v[c0] = csub(x + (kX ? y : x ^ z), q2);
      if (kGen)
        v[c1] = shoup_lazy(low == 0 ? d : shoup_lazy(d, w, q), r, q);
      else
        v[c1] = kW ? shoup_lazy(d, w, q) : csub(d, q2);
    }
  }
}

template <int kLogN, int kLo, int R, int J, bool kX, bool kMul>
__device__ __forceinline__ void stages(uint32_t (&v)[1 << R],
                                       const uint64_t* tw, int jl, uint32_t q,
                                       uint32_t q2, uint32_t z) {
  if constexpr (J >= 0) {
    stage<kLogN, kLo, R, J, kX, kMul>(v, tw, jl, q, q2, z);
    stages<kLogN, kLo, R, J - 1, kX, kMul>(v, tw, jl, q, q2, z);
  }
}

// Exchange off, stage J of a later pass over bits [kLo, kLo + P) of the full
// row (stage bit B = kLo + J, below the first pass): bit B of every register's
// position is bit B of j0, so the whole group is top or bottom, and a bottom
// takes the one twiddle W_B^(j0 mod h) (`stage`). The stage obtains the
// twiddles that the full row's group obtains, in the same pattern: at kLo = 0
// stage J's 2^J shared entries (16-byte pairs); at kLo >= 5 the lane's root
// W_B^jl and stage J's 2^J shared entries W_J^low; in between the 2^J
// entries t[low << kLo | jl]; it keeps the entry of low = j0 >> kLo mod 2^J
// (at kLo >= 5 the bottom is (d W_J^low) W_B^jl, two products also at
// low = 0, where W_J^0 = 1). Each pair of values computes both sums and one
// product, and keeps the product where bit B of j0 is set, the sums where it
// is clear: no branch. The loads' address waits for the last stage's v[0]
// (`never`), so that the compiler does not load every stage's twiddles at
// once and spill the values.
template <int kLogN, int kLo, int J, int R, bool kMul>
__device__ __forceinline__ void kept_stages(uint32_t (&v)[1 << R],
                                            const uint64_t* tw, int j0,
                                            uint32_t q, uint32_t q2,
                                            uint32_t z) {
  if constexpr (J >= 0) {
    constexpr int B = kLo + J;
    constexpr bool kW = kMul && B > 0;
    constexpr bool kGen = kW && kLo >= 5;
    constexpr int C = 1 << R;
    const int dep = never(v[0]);
    const uint64_t* t = tw + ((1 << kLogN) - (2 << B)) +
                        (j0 & ((1 << kLo) - 1)) + dep;
    const uint64_t* ts = tw + ((1 << kLogN) - (2 << J)) + dep;
    const int want = (j0 >> kLo) & ((1 << J) - 1);
    const uint64_t r = kGen ? ld_kept(t) : 0;
    uint64_t w = 0;
    if (kW && (kLo == 0 || kGen) && J > 0) {  // shared: 16-byte pairs
#pragma unroll
      for (int low = 0; low < (1 << J); low += 2) {
        const ulonglong2 w2 = ld_kept2(ts + low);
        w = low == want ? w2.x : low + 1 == want ? w2.y : w;
      }
    } else if (kW && !kGen) {
#pragma unroll
      for (int low = 0; low < (1 << J); ++low) {
        const uint64_t wl = ld_kept(t + (low << kLo));
        w = low == want ? wl : w;
      }
    }
    const bool bottom = (j0 >> B) & 1;
#pragma unroll
    for (int c = 0; c < C / 2; ++c) {
      const uint32_t x = v[c], y = v[c + C / 2];
      const uint32_t d = (x ^ z) - x + q2;
      uint32_t b;
      if (kGen)
        b = shoup_lazy(J > 0 ? shoup_lazy(d, w, q) : d, r, q);
      else
        b = kW ? shoup_lazy(d, w, q) : csub(d, q2);
      v[c] = bottom ? b : csub(x + (x ^ z), q2);
      v[c + C / 2] = bottom ? b : csub(y + (y ^ z), q2);
    }
    kept_stages<kLogN, kLo, J - 1, R, kMul>(v, tw, j0, q, q2, z);
  }
}

// Exchange off, after the first pass: the stages of the full row's later
// register passes (`passes`: 5 stages each, the rest in the last), kDone
// stages already run, on the values kept in the first pass's layout.
template <int kLogN, int kStages, int R, bool kMul, int kDone>
__device__ __forceinline__ void kept_passes(uint32_t (&v)[1 << R],
                                            const uint64_t* tw, int j0,
                                            uint32_t q, uint32_t q2,
                                            uint32_t z) {
  if constexpr (kDone < kStages) {
    constexpr int P = kStages - kDone < kMaxPassBits ? kStages - kDone
                                                     : kMaxPassBits;
    constexpr int kLo = kLogN - kDone - P;
    kept_stages<kLogN, kLo, P - 1, R, kMul>(v, tw, j0, q, q2, z);
    kept_passes<kLogN, kStages, R, kMul, kDone + P>(v, tw, j0, q, q2, z);
  }
}

// One register pass of R stages over bits [kLo, kLo + R) of every
// polynomial in the block: each of the thread's G = 2^kLV / 2^R groups
// of 2^R values is read, transformed and written in turn. kFirst reads HBM
// with the twist, else shared memory; kLast makes the values canonical and
// writes HBM (at kLo = 0 through the warp's own part of shared memory, in
// 16-byte stores), else shared memory. kEnd < kLo (exchange off, one pass
// only) also runs the stages kLo - 1 .. kEnd on the values in registers.
// A thread holds 2^kLV values (blockDim.x = block coefficients / 2^kLV).
template <int kLogN, int kLo, int R, bool kFirst, bool kLast, bool kX,
          bool kMul, int kEnd, int kLV = kLogVals>
__device__ __forceinline__ void run_pass(const Args& a, uint32_t* s) {
  static_assert(!kFirst || kLo >= 5, "HBM is read word by word");
  static_assert(kX || (kFirst && kLast), "without exchange, one pass");
  static_assert(kLV >= R, "a group is at most a thread's values");
  constexpr int G = (1 << kLV) >> R;
  constexpr int C = 1 << R;
  constexpr int kMode = kLo == 0 ? 0 : kLo >= 5 ? 1 : 2;
  constexpr int n = 1 << kLogN;
  constexpr int stride = (1 << kLo) + ((1 << kLo) >> 5);
  const int lane = threadIdx.x & 31;
  // `dep` is 0, but the compiler cannot know it: it ties each group's
  // loads to the previous group's results, so the groups run one after
  // another and only one group's values and twiddles are live.
  int dep = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int base = value_index(threadIdx.x, blockDim.x, g, 0, kLo, R) + dep;
    const Poly p = poly_of<kLogN>(a, base);
    const int j0 = base & (n - 1);  // the pass's bits [kLo, kLo + R) are 0
    const uint32_t q = static_cast<uint32_t>(__ldg(a.q + p.limb));
    const uint32_t q2 = 2 * q;
    const uint32_t z = never(q);
    const uint64_t* tw = a.wpack + (static_cast<size_t>(p.limb) << kLogN);
    const int pb = padded(base);
    uint32_t v[C];
    if (kFirst) {
      const uint64_t* t = a.twist + (static_cast<size_t>(p.limb) << kLogN);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 | (c << kLo);
        // the int64's low word holds the value
        const auto* xi = reinterpret_cast<const unsigned int*>(a.x + p.base + j);
        v[c] = p.valid ? shoup_lazy(__ldcs(xi), __ldg(t + j), q) : 0u;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = s[pb + offset<kMode>(c, kLo, stride)];
    }
    stages<kLogN, kLo, R, R - 1, kX, kMul>(v, tw, j0 & ((1 << kLo) - 1), q,
                                           q2, z);
    if constexpr (kEnd < kLo)
      kept_passes<kLogN, kLogN - kEnd, R, kMul, kLogN - kLo>(v, tw, j0, q, q2,
                                                             z);
    if (kLast) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = csub(v[c], q);
    }
    if (kLast && kMode != 0) {
      // an opaque copy of j0, as of pb below, for the store addresses
      int sj;
      asm volatile("mov.b32 %0, %1;" : "=r"(sj) : "r"(j0));
      int64_t* o = a.out + p.base + sj;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (p.valid)
          __stcs(reinterpret_cast<long long*>(o + (c << kLo)),
                 static_cast<long long>(v[c]));
    } else {
      // an opaque copy of pb makes the compiler work the store addresses
      // out again instead of keeping the loads' live through the stages
      int spb;
      asm volatile("mov.b32 %0, %1;" : "=r"(spb) : "r"(pb));
#pragma unroll
      for (int c = 0; c < C; ++c) s[spb + offset<kMode>(c, kLo, stride)] = v[c];
    }
    if (kLast && kMode == 0) {
      // the warp's 32 groups are neighbours, inside one polynomial
      const int wj = j0 - lane * C;
      const int wbase = base - lane * C;
      __syncwarp();
      if (p.valid) {
#pragma unroll
        for (int k = 0; k < C / 2; ++k) {
          const int e = 2 * (lane + 32 * k);
          __stcs(reinterpret_cast<longlong2*>(a.out + p.base + wj + e),
                 make_longlong2(s[padded(wbase + e)],
                                s[padded(wbase + e + 1)]));
        }
      }
    }
    dep = never(v[0]);
  }
}

// The register passes of the top kStages bits, from the top down: 5 stages
// each and the rest in the last, kDone stages already run, 2^kLV values a
// thread. kOut: the last pass writes HBM, canonical; else it leaves its
// values (below 2q) in shared memory, and the caller synchronises.
template <int kLogN, int kStages, bool kMul, int kDone, int kLV = kLogVals,
          bool kOut = true>
__device__ __forceinline__ void passes(const Args& a, uint32_t* s) {
  constexpr int R = kStages - kDone < kMaxPassBits ? kStages - kDone
                                                   : kMaxPassBits;
  constexpr int kLo = kLogN - kDone - R;
  constexpr bool kEnd = kDone + R == kStages;
  run_pass<kLogN, kLo, R, kDone == 0, kEnd && kOut, true, kMul, kLo, kLV>(
      a, s);
  if constexpr (!kEnd) {
    __syncthreads();
    passes<kLogN, kStages, kMul, kDone + R, kLV, kOut>(a, s);
  }
}

}  // namespace dif
