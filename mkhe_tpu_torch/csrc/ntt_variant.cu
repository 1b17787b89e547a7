// The NTT cost probe's transform for Hopper (sm_90a): a forward NTT whose
// stage count, exchange and twiddle multiplies can each be cut, to take the
// forward kernel's time apart.
//
// Replaces the TPU kernel benchmarks/ntt_probe.py::_variant_kernel (:35-63,
// launched :89). Computes what it computes, on (n_polys, N) int64 holding u32
// values, polynomial p on limb p % L:
//   a = x * psi^j (twist, lazy Shoup: any u32 -> [0, 2q));
//   for s = 1 .. stages, h = N >> s (DIF, Gentleman-Sande):
//     top = a[j] + partner, bottom = w[N - 2h + (j mod h)] (partner - a[j])
//     where j & h picks bottom; partner = a[j ^ h] with the exchange on, a[j]
//     itself with it off; without the multiply (or at h = 1) bottom is the
//     difference alone;
//   out = a mod q, canonical.
// Every intermediate stays below 2q, so the output is exact mod q and equal
// bit for bit to ops/ntt_cuda.py::ntt_variant_plain in every setting. With
// every stage it is the forward NTT (Ring.ntt); with logN - 7 stages it is
// the split's head (ntt_tail.cu::ntt_fwd_head_kernel).
//
// The decimation is the split's (twist, then DIF on the wpack table, whose
// twiddle depends on the low bits j mod h), not ntt.cu's merged-twist
// Cooley-Tukey on psi (high bits): their intermediate values differ, so cut
// stages, exchange or multiplies cannot be switches on ntt.cu's kernel. The
// machinery is ntt.cu's, so that the probe takes that design's cost apart:
// - Register radix passes from the top bit down: a thread holds 32 values,
//   runs up to 5 stages on them in registers, and the polynomial sits in
//   padded shared memory between passes (a block barrier each). The stages
//   run are the passes of `stages` bits (5 each, the rest last: 5 + 5 + 5 at
//   logN 15, 5 + 3 for 8 stages); HBM is read (with the twist) inside the
//   first pass and written (canonical) inside the last, with 16-byte
//   warp-staged stores in a pass at bit 0, as ntt.cu does.
// - Packed 8-byte twiddles w | w_sh << 32 (and twist | twist_sh << 32), in
//   natural order: a pass at lo >= 5 reads its stage's twiddles as
//   neighbouring words across a warp; the pass at bit 0 reads twiddles that
//   every thread shares (in 16-byte pairs), so no read order is needed.
// - The launch geometry of ntt.cu (ops/ntt_cuda.py::geometry: polynomials
//   per block, threads, shared memory), and the same 64-register cap.
// - Every loop bound is a compile-time constant: logN, the stages, the
//   exchange and the multiply are template parameters, and only the settings
//   the probe launches are built (ops/ntt_cuda.py::variant_settings).
// - Exchange off: each value updates from itself alone, so the values stay
//   in registers from the HBM read to the HBM write, with no shared memory
//   and no barrier, and only the exchange is gone: every stage loads as
//   many twiddles for a group of 32 values as the full row's pass does, in
//   the same pattern across a warp (`kept_stages`; at logN 14 the last pass,
//   two groups of 16 in the full row, loads one group's), and nothing
//   branches. The layout stays the first pass's, so a stage below it is
//   top or bottom for a whole group of 32, which takes one of the loaded
//   twiddles; a pair of values computes both sums and one product and keeps
//   what its side needs (one sum and two selects a pair more than a
//   butterfly). The partner is the value xor an opaque zero, in the sum and
//   in the difference: with a + a the compiler knows every sum is even, so
//   a later difference a - a + 2q is a constant, and it drops the loads and
//   products that only that difference needs.
// - Block order (`limb_major`): polynomial-major, or limb-major (block slot r
//   takes polynomial (r % B) * L + r / B, B = n_polys / L), so that
//   consecutive blocks share one limb's tables in L2; the output is the same.
//
// What bounds it on an H100: the bytes, as ntt.cu (16 per coefficient, plus
// the tables), by a small margin over the int32 operations (profile_ntt.
// kernel_bound, "ntt_variant").

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogVals = 5;      // a thread holds 2^5 coefficients
constexpr int kMaxPassBits = 5;  // stages of one register pass
constexpr int kMaxThreads = (1 << 15) >> kLogVals;

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
// position j = j0 | c1 << kLo of its polynomial and takes twiddle
// t[(c0 mod 2^J) << kLo | jl] of the stage's table t = wpack + N - 2h,
// jl = j0 mod 2^kLo. With kX off each value is its own partner.
template <int kLogN, int kLo, int R, int J, bool kX, bool kMul>
__device__ __forceinline__ void stage(uint32_t (&v)[1 << R],
                                      const uint64_t* tw, int jl, uint32_t q,
                                      uint32_t q2, uint32_t z) {
  constexpr int B = kLo + J;
  constexpr bool kW = kMul && B > 0;
  const uint64_t* t = tw + ((1 << kLogN) - (2 << B)) + jl;
  ulonglong2 w2;
#pragma unroll
  for (int low = 0; low < (1 << J); ++low) {
    uint64_t w = 0;
    if (kW && kLo == 0 && J > 0) {  // shared by every thread: 16-byte pairs
      if (low % 2 == 0)
        w2 = __ldg(reinterpret_cast<const ulonglong2*>(t + low));
      w = low % 2 ? w2.y : w2.x;
    } else if (kW) {
      w = __ldg(t + (low << kLo));
    }
#pragma unroll
    for (int hi = 0; hi < (1 << (R - 1 - J)); ++hi) {
      const int c0 = (hi << (J + 1)) | low;
      const int c1 = c0 | (1 << J);
      const uint32_t x = v[c0], y = v[c1];
      const uint32_t d = (kX ? x : y ^ z) - y + q2;
      v[c0] = csub(x + (kX ? y : x ^ z), q2);
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
// takes the one twiddle t[j0 mod h], t = wpack + N - 2h. The stage loads the
// 2^J twiddles that the full row's group loads, t[low << kLo | j0 mod 2^kLo]
// (in 16-byte pairs at kLo = 0), and keeps the one of low = j0 >> kLo mod
// 2^J. Each pair of values computes both sums and one product, and keeps the
// product where bit B of j0 is set, the sums where it is clear: no branch.
// The loads' address waits for the last stage's v[0] (`never`), so that the
// compiler does not load every stage's twiddles at once and spill the values.
template <int kLogN, int kLo, int J, int R, bool kMul>
__device__ __forceinline__ void kept_stages(uint32_t (&v)[1 << R],
                                            const uint64_t* tw, int j0,
                                            uint32_t q, uint32_t q2,
                                            uint32_t z) {
  if constexpr (J >= 0) {
    constexpr int B = kLo + J;
    constexpr bool kW = kMul && B > 0;
    constexpr int C = 1 << R;
    const uint64_t* t = tw + ((1 << kLogN) - (2 << B)) +
                        (j0 & ((1 << kLo) - 1)) + never(v[0]);
    const int want = (j0 >> kLo) & ((1 << J) - 1);
    uint64_t w = 0;
    if (kW && kLo == 0) {  // J > 0: shared by every thread, 16-byte pairs
#pragma unroll
      for (int low = 0; low < (1 << J); low += 2) {
        const ulonglong2 w2 = ld_kept2(t + low);
        w = low == want ? w2.x : low + 1 == want ? w2.y : w;
      }
    } else if (kW) {
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
      const uint32_t b = kW ? shoup_lazy(d, w, q) : csub(d, q2);
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
// polynomial in the block: each of the thread's G = 2^kLogVals / 2^R groups
// of 2^R values is read, transformed and written in turn. kFirst reads HBM
// with the twist, else shared memory; kLast makes the values canonical and
// writes HBM (at kLo = 0 through the warp's own part of shared memory, in
// 16-byte stores), else shared memory. kEnd < kLo (exchange off, one pass
// only) also runs the stages kLo - 1 .. kEnd on the values in registers.
template <int kLogN, int kLo, int R, bool kFirst, bool kLast, bool kX,
          bool kMul, int kEnd>
__device__ __forceinline__ void run_pass(const Args& a, uint32_t* s) {
  static_assert(!kFirst || kLo >= 5, "HBM is read word by word");
  static_assert(kX || (kFirst && kLast), "without exchange, one pass");
  constexpr int G = (1 << kLogVals) >> R;
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
// each and the rest in the last, kDone stages already run.
template <int kLogN, int kStages, bool kMul, int kDone>
__device__ __forceinline__ void passes(const Args& a, uint32_t* s) {
  constexpr int R = kStages - kDone < kMaxPassBits ? kStages - kDone
                                                   : kMaxPassBits;
  constexpr int kLo = kLogN - kDone - R;
  constexpr bool kLast = kDone + R == kStages;
  run_pass<kLogN, kLo, R, kDone == 0, kLast, true, kMul, kLo>(a, s);
  if constexpr (!kLast) {
    __syncthreads();
    passes<kLogN, kStages, kMul, kDone + R>(a, s);
  }
}

template <int kLogN, int kStages, bool kX, bool kMul>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt_variant_kernel(const Args a) {
  static_assert(1 <= kStages && kStages <= kLogN && kLogN - 5 >= 5,
                "the first pass reads HBM at lo >= 5");
  extern __shared__ uint32_t smem[];
  if constexpr (kX) {
    passes<kLogN, kStages, kMul, 0>(a, smem);
  } else {
    constexpr int R = kStages < kMaxPassBits ? kStages : kMaxPassBits;
    run_pass<kLogN, kLogN - R, R, true, true, false, kMul, kLogN - kStages>(
        a, smem);
  }
}

using Kernel = void (*)(const Args);

// The settings built at one logN (ops/ntt_cuda.py::variant_settings): every
// stage, 8 and 1 with everything on, logN - 7 (the split head's stages),
// and every stage without multiplies or without exchange.
template <int kLogN>
Kernel find(int stages, bool x, bool mul) {
  if (x && mul) {
    if (stages == kLogN) return ntt_variant_kernel<kLogN, kLogN, true, true>;
    if (stages == 8) return ntt_variant_kernel<kLogN, 8, true, true>;
    if (stages == 1) return ntt_variant_kernel<kLogN, 1, true, true>;
    if (stages == kLogN - 7)
      return ntt_variant_kernel<kLogN, kLogN - 7, true, true>;
  }
  if (stages == kLogN && x && !mul)
    return ntt_variant_kernel<kLogN, kLogN, true, false>;
  if (stages == kLogN && !x && mul)
    return ntt_variant_kernel<kLogN, kLogN, false, true>;
  return nullptr;
}

Kernel find(int logn, int stages, bool x, bool mul) {
  switch (logn) {
    case 10: return find<10>(stages, x, mul);
    case 14: return find<14>(stages, x, mul);
    case 15: return find<15>(stages, x, mul);
    default: return nullptr;
  }
}

// The launcher's geometry against what the kernel needs (ntt.cu's rule;
// shared memory only with the exchange on).
bool geometry_ok(const Args& a, int logn, bool x, int blocks, int threads,
                 int smem) {
  if (a.log_polys < 0 || a.L < 1 || a.n_polys < 1 || a.n_polys % a.L)
    return false;
  const int log_s = logn + a.log_polys;
  if (log_s > 15 || threads << kLogVals != 1 << log_s || threads % 32)
    return false;
  const int size = 1 << log_s;
  if (x && smem < static_cast<int>(sizeof(uint32_t)) * (size + size / 32))
    return false;
  return (static_cast<int64_t>(blocks) << a.log_polys) >= a.n_polys &&
         (static_cast<int64_t>(blocks - 1) << a.log_polys) < a.n_polys;
}

}  // namespace

// Plain C interface (loaded with ctypes). Every pointer is device memory;
// stream is a cudaStream_t. (stages, exchange, mul) must be a setting built
// at logn and the geometry (log_polys, blocks, threads, smem) that of
// ops/ntt_cuda.py::geometry, else cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch.
extern "C" int mkhe_ntt_variant(const void* x, void* out, const void* twist,
                                const void* wpack, const void* q, int n_polys,
                                int L, int logn, int stages, int exchange,
                                int mul, int limb_major, int log_polys,
                                int blocks, int threads, int smem,
                                void* stream) {
  const Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
               static_cast<const uint64_t*>(twist),
               static_cast<const uint64_t*>(wpack),
               static_cast<const int64_t*>(q), n_polys, L, log_polys,
               limb_major != 0};
  const Kernel k = find(logn, stages, exchange != 0, mul != 0);
  if (k == nullptr ||
      !geometry_ok(a, logn, exchange != 0, blocks, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KiB of dynamic shared memory the launch is refused unless the
  // kernel has opted in.
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
