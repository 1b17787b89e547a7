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
// the split's head (ntt_split.cu's head mode, on the same passes).
//
// The decimation is the split's (twist, then DIF on the wpack table, whose
// twiddle depends on the low bits j mod h), not ntt.cu's merged-twist
// Cooley-Tukey on psi (high bits): their intermediate values differ, so cut
// stages, exchange or multiplies cannot be switches on ntt.cu's kernel. The
// machinery is ntt.cu's, so that the probe takes that design's cost apart
// (it lives in ntt_dif.cuh, which ntt_split.cu's head shares):
// - Register radix passes from the top bit down: a thread holds 32 values,
//   runs up to 5 stages on them in registers, and the polynomial sits in
//   padded shared memory between passes (a block barrier each). The stages
//   run are the passes of `stages` bits (5 each, the rest last: 5 + 5 + 5 at
//   logN 15, 5 + 3 for 8 stages); HBM is read (with the twist) inside the
//   first pass and written (canonical) inside the last, with 16-byte
//   warp-staged stores in a pass at bit 0, as ntt.cu does.
// - Packed 8-byte twiddles w | w_sh << 32 (and twist | twist_sh << 32), in
//   natural order. The pass at bit 0 reads twiddles that every thread
//   shares (in 16-byte pairs). A pass at lo >= 5 reads one root W_B^jl a
//   stage for each lane, neighbouring words across a warp, and stage J's
//   shared entries W_J^low, and multiplies a bottom by both (ntt_dif.cuh,
//   "Twiddles"), where loading each lane's twiddles as they are would take
//   2^J loads a stage, 31 a pass.
// - The launch geometry of ntt.cu (ops/ntt_cuda.py::geometry: polynomials
//   per block, threads, shared memory), and the same 64-register cap.
// - Every loop bound is a compile-time constant: logN, the stages, the
//   exchange and the multiply are template parameters, and only the settings
//   the probe launches are built (ops/ntt_cuda.py::variant_settings).
// - Exchange off: each value updates from itself alone, so the values stay
//   in registers from the HBM read to the HBM write, with no shared memory
//   and no barrier, and only the exchange is gone: every stage loads as
//   many twiddles for a group of 32 values as the full row's pass does, in
//   the same pattern across a warp (`kept_stages`: the lane's root and the
//   shared entries at lo >= 5; at logN 14 the last pass, two groups of 16 in
//   the full row, loads one group's), and nothing branches. The layout stays the first pass's, so a stage below it is
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
// the table entries it reads, ntt_cuda.variant_twiddle_entries), by a
// margin over the int32 operations (profile_ntt.kernel_bound,
// "ntt_variant"). Loaded as they are, a lane's own twiddles held this
// transform at 36-45 % of that bound (the probe's twiddle share, 39-53 %,
// against an exchange share of 5-12 %, PERF.md); the root scheme trades
// 26 of a pass's 31 lane loads for 49 lazy products, which the operation
// bound has room for.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_dif.cuh"

namespace {

using namespace dif;

constexpr int kMaxThreads = (1 << 15) >> kLogVals;

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
