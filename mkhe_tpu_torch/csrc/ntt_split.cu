// The split negacyclic NTT's forward direction for Hopper (sm_90a): head,
// int8 tail, or both in one kernel that makes one HBM pass.
//
// Replaces two TPU kernels of mkhe_tpu/ops/ntt_pallas.py's MXU-tail form
// (config.pallas_ntt_mxu_tail): _fwd_kernel(head_only=True) (the stages of
// _fwd_stages, :47-104, through _fwd_kernel :126) and the int8 matrix
// products of _tail_apply (:266-312). The transform is "twist by psi^j,
// then DIF stages on the stage-packed wpack table" (ntt_pallas.py:9-17);
// in this decimation the 7 stages with half-block h < 128 act on every
// 128-lane row by one fixed 128x128 map M over Z_q (ops/ring.py::
// SplitTables). One template, ntt_split_kernel<kLogN, kHead, kTail>:
//
//   head + tail  the forward NTT (Ring.ntt with config.ntt_mxu_tail):
//                HBM is read once, with the twist, inside the head's first
//                pass; the head's logN - 7 stages run as ntt_dif.cuh's
//                register passes; the polynomial stays in shared memory;
//                the tail map runs there on every row; the output is
//                written once, canonical, in 16-byte stores.
//   tail only    out = x @ M on every row, any u32 input (the inverse map
//                before ntt_tail.cu's tailed inverse, or either map).
//   head only    twist and the head's stages, canonical (ntt_cuda.ntt_head).
//
// Every output equals its plain PyTorch version (ops/ntt_cuda.py) bit for
// bit; head + tail also equals ntt.cu's full forward kernel.
//
// The tail on the tensor cores: mma.sync m16n8k32 u8 x u8 -> s32. x (any
// u32) is 4 base-2^8 digit planes and M (< q < 2^30) 4 more; the 16 plane
// products add into 7 partial sums s_t (t = digit of x + digit of M), each
// below 4 * 128 * 255^2 < 2^25; sum_t s_t * (2^(8t+32) mod q) < 7 * 2^25 * q
// is taken in u64 and one Montgomery step and one conditional subtraction
// give the canonical x @ M mod q. (The JAX package's 5 s8 planes need 25
// products; the plain version keeps them, the result is the same.)
//
// What bounds it on an H100: the bytes. At 8 x 32 x 2^15 the fused mode
// moves 16 B a coefficient (134.2 MB) plus the packed twist and wpack (16.8
// MB) and each limb's M table (2.1 MB): 0.046 ms at 3.35 TB/s. Its int8
// products (16 x 2 x 128 operations a coefficient, 34.4 G) take 0.017 ms at
// the dense rate and its int32 work less than the bytes. What the design
// does about the two kernels it replaces (two HBM passes; M restaged byte by
// byte, transposed, for every polynomial; 2 blocks of 4 warps an SM; A
// fragments read from HBM as int64; scattered 8-byte stores):
// - One HBM pass: the head ends in shared memory (passes<..., kOut =
//   false>), and the tail reads its A fragments there.
// - M is stored once, per limb, in fragment order (ntt_cuda.tail_fragments:
//   plane, k-step, n-tile, lane, the lane's 8 bytes), so a block stages its
//   limb's 64 KiB with 16-byte cp.async copies issued at kernel entry,
//   overlapping the head, and each B fragment is one conflict-free 8-byte
//   shared load.
// - The A fragments come from the padded polynomial (word i + i / 32) with
//   the k index permuted: MMA k = 16 hf + 4 c + e (thread c of its group,
//   register half hf, byte e) takes column 16 hf + c + 4 e of the k-step,
//   and M's table the same row, so a warp's 32 loads hit 32 banks. Four
//   values' bytes are transposed into the 4 planes with byte permutes.
// - A block holds one polynomial: max(128, min(512, N / 32)) threads, 2^5
//   values a thread in the head (2^6 at logN 15, so 128 registers a thread
//   at one block an SM); a warp accumulates two 16 x 8 output tiles (56
//   accumulators) over the 4 k-steps, and writes each tile's values
//   straight from the D fragment, canonical, two neighbours in one 16-byte
//   store (every 32-byte sector whole).
// - Shared memory at logN 15: 4 (2^15 + 2^10) B of polynomial and 64 KiB of
//   M, 200,704 B of the 232,448 a block may have.
// Built for logN 8 .. 15 (Ring.ntt splits from N = 256) in the three modes.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_dif.cuh"

namespace {

using namespace dif;

constexpr int kLanes = 128;                 // lanes of one tail row
constexpr int kPlanes = 4;                  // base-2^8 digit planes
constexpr int kSums = 2 * kPlanes - 1;      // partial sums s_0 .. s_6
constexpr int kKSteps = kLanes / 32;        // k-steps of m16n8k32
constexpr int kColTiles = kLanes / 8;       // n-tiles of 8 columns
constexpr int kTilesPerItem = 2;            // n-tiles a warp holds at once
constexpr int kMatBytes = kPlanes * kKSteps * kColTiles * 32 * 8;  // 64 KiB
constexpr int kMaxThreads = 512;
constexpr int kMinLogN = 8;
constexpr int kMaxLogN = 15;
constexpr int kHeadMode = 1;  // mode bits of the C entry
constexpr int kTailMode = 2;

__host__ __device__ constexpr int split_threads(int logn) {
  return ((1 << logn) >> 5) < 128   ? 128
         : ((1 << logn) >> 5) > 512 ? 512
                                    : (1 << logn) >> 5;
}

__host__ __device__ constexpr int log2c(int v) {
  return v <= 1 ? 0 : 1 + log2c(v / 2);
}

// Dynamic shared memory of a launch: M's table (tail modes) first, then the
// polynomial, padded by one word per 32.
constexpr size_t split_smem(int logn, bool tail) {
  return (tail ? kMatBytes : 0) +
         sizeof(uint32_t) * ((1 << logn) + ((1 << logn) >> 5));
}

static_assert(split_smem(kMaxLogN, true) <= 232448,
              "a block may have 232,448 bytes of shared memory");

// D += A (16x32, row) * B (32x8, col), u8 x u8 -> s32.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p[d] = byte d of v0, v1, v2, v3 (in bytes 0, 1, 2, 3): a 4x4 byte
// transpose, the 4 digit planes of 4 values.
__device__ __forceinline__ void byte_planes(const uint32_t (&v)[4],
                                            uint32_t& p0, uint32_t& p1,
                                            uint32_t& p2, uint32_t& p3) {
  // lo01 = bytes v0b0 v1b0 v0b1 v1b1, hi01 = v0b2 v1b2 v0b3 v1b3
  const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
  p0 = __byte_perm(lo01, lo23, 0x5410);
  p1 = __byte_perm(lo01, lo23, 0x7632);
  p2 = __byte_perm(hi01, hi23, 0x5410);
  p3 = __byte_perm(hi01, hi23, 0x7632);
}

// out_row = x_row @ M for every 128-lane row of the block's polynomial:
// x in shared memory at s (padded, any u32), M's fragment table at m,
// canonical output to HBM at out. Work items are (16-row tile, pair of
// n-tiles), dealt to the warps in turn.
template <int kLogN>
__device__ __forceinline__ void tail_rows(const uint32_t* s,
                                          const uint32_t* m, int64_t* out,
                                          uint32_t q, const int64_t* pw) {
  constexpr int kRows = (1 << kLogN) / kLanes;
  constexpr int kGroups = kColTiles / kTilesPerItem;
  constexpr int kItems = (kRows + 15) / 16 * kGroups;
  constexpr int kWarps = split_threads(kLogN) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int c = lane & 3;   // thread in group
  // Montgomery constant -q^-1 mod 2^32 by Newton's iteration (q odd:
  // q * q = 1 mod 8, and each step doubles the correct low bits).
  uint32_t qinv = q;
#pragma unroll
  for (int it = 0; it < 4; ++it) qinv *= 2u - q * qinv;
  const uint32_t qneg_inv = 0u - qinv;
  uint32_t pw32[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) pw32[t] = static_cast<uint32_t>(pw[t]);

  for (int item = warp; item < kItems; item += kWarps) {
    const int r0 = item / kGroups * 16 + g;  // this lane's rows r0, r0 + 8
    const int nt0 = item % kGroups * kTilesPerItem;
    const bool ok[2] = {r0 < kRows, r0 + 8 < kRows};
    int acc[kTilesPerItem][kSums][4];
#pragma unroll
    for (int t = 0; t < kTilesPerItem; ++t)
#pragma unroll
      for (int u = 0; u < kSums; ++u)
        acc[t][u][0] = acc[t][u][1] = acc[t][u][2] = acc[t][u][3] = 0;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      // a[d][j]: plane d of register j = {row r0, row r0 + 8} x {hf 0, 1};
      // byte e of register j holds column 32 ks + 16 hf + c + 4 e.
      uint32_t a[kPlanes][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hi = j & 1;
        const int at = 132 * (r0 + 8 * hi) + 33 * ks + 16 * (j >> 1) + c;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = ok[hi] ? s[at + 4 * e] : 0u;
        byte_planes(v, a[0][j], a[1][j], a[2][j], a[3][j]);
      }
#pragma unroll
      for (int t = 0; t < kTilesPerItem; ++t) {
#pragma unroll
        for (int dm = 0; dm < kPlanes; ++dm) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              m + 2 * (((dm * kKSteps + ks) * kColTiles + nt0 + t) * 32 +
                       lane));
#pragma unroll
          for (int dx = 0; dx < kPlanes; ++dx)
            mma_u8(acc[t][dx + dm], a[dx], b.x, b.y);
        }
      }
    }
    // D fragment: d[2 hi + e] is row r0 + 8 hi, column 8 nt + 2 c + e.
#pragma unroll
    for (int t = 0; t < kTilesPerItem; ++t) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        uint32_t r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint64_t sum = 0;  // < 7 * 2^25 * q < 2^58
#pragma unroll
          for (int u = 0; u < kSums; ++u)
            sum += static_cast<uint64_t>(
                       static_cast<uint32_t>(acc[t][u][2 * hi + e])) *
                   pw32[u];
          const uint32_t mq = static_cast<uint32_t>(sum) * qneg_inv;
          r[e] = csub(static_cast<uint32_t>(
                          (sum + static_cast<uint64_t>(mq) * q) >> 32),
                      q);  // < 1.06 q before the subtraction
        }
        if (ok[hi])
          __stcs(reinterpret_cast<longlong2*>(
                     out + (r0 + 8 * hi) * kLanes + 8 * (nt0 + t) + 2 * c),
                 make_longlong2(r[0], r[1]));
      }
    }
  }
}

// One polynomial a block (blockIdx.x, on limb blockIdx.x % L).
template <int kLogN, bool kHead, bool kTail>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt_split_kernel(const Args a, const uint8_t* __restrict__ mat,
                 const int64_t* __restrict__ pw) {
  constexpr int n = 1 << kLogN;
  constexpr int kThreads = split_threads(kLogN);
  constexpr int kLV = kLogN - log2c(kThreads);  // head values a thread
  static_assert(kMinLogN <= kLogN && kLogN <= kMaxLogN, "logN 8 .. 15");
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem + (kTail ? kMatBytes : 0));
  const int limb = blockIdx.x % a.L;
  const size_t base = static_cast<size_t>(blockIdx.x) << kLogN;
  if constexpr (kTail) {
    // the limb's M table, 16 bytes a copy, in flight during the head
    const uint8_t* src = mat + static_cast<size_t>(limb) * kMatBytes;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    for (int i = 16 * threadIdx.x; i < kMatBytes; i += 16 * kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :
                   : "r"(dst + i), "l"(src + i));
    asm volatile("cp.async.commit_group;\n" ::);
  }
  if constexpr (kHead) {
    passes<kLogN, kLogN - 7, true, 0, kLV, !kTail>(a, s);
  } else {
    // tail only: x (the low words) into shared memory, 16 bytes a load
    const int64_t* x = a.x + base;
    for (int i = 2 * threadIdx.x; i < n; i += 2 * kThreads) {
      const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(x + i));
      s[padded(i)] = static_cast<uint32_t>(v.x);
      s[padded(i) + 1] = static_cast<uint32_t>(v.y);
    }
  }
  if constexpr (kTail) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    tail_rows<kLogN>(s, reinterpret_cast<const uint32_t*>(smem),
                     a.out + base, static_cast<uint32_t>(__ldg(a.q + limb)),
                     pw + limb * kSums);
  }
}

using Kernel = void (*)(const Args, const uint8_t*, const int64_t*);

template <int kLogN>
Kernel find(int mode) {
  switch (mode) {
    case kHeadMode: return ntt_split_kernel<kLogN, true, false>;
    case kTailMode: return ntt_split_kernel<kLogN, false, true>;
    case kHeadMode | kTailMode: return ntt_split_kernel<kLogN, true, true>;
    default: return nullptr;
  }
}

Kernel find(int logn, int mode) {
  switch (logn) {
    case 8: return find<8>(mode);
    case 9: return find<9>(mode);
    case 10: return find<10>(mode);
    case 11: return find<11>(mode);
    case 12: return find<12>(mode);
    case 13: return find<13>(mode);
    case 14: return find<14>(mode);
    case 15: return find<15>(mode);
    default: return nullptr;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Every pointer is device memory;
// stream is a cudaStream_t. mode: 1 head, 2 tail, 3 head + tail. The head
// reads twist and wpack ((L, N) packed, natural order), the tail mat
// ((L, 65536) bytes, ntt_cuda.tail_fragments, 16-byte aligned) and pw
// ((L, 7), 2^(8t+32) mod q); x is 16-byte aligned in the tail-only mode.
// A logN outside 8 .. 15, a mode outside 1 .. 3 or n_polys not a multiple
// of L gives cudaErrorInvalidValue. Returns cudaGetLastError() after the
// launch.
extern "C" int mkhe_ntt_split(const void* x, void* out, const void* twist,
                              const void* wpack, const void* mat,
                              const void* pw, const void* q, int n_polys,
                              int L, int logn, int mode, void* stream) {
  const Kernel k = find(logn, mode);
  if (k == nullptr || L < 1 || n_polys < 1 || n_polys % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(split_smem(logn, mode & kTailMode));
  // Above 48 KiB of dynamic shared memory the launch is refused unless the
  // kernel has opted in.
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
               static_cast<const uint64_t*>(twist),
               static_cast<const uint64_t*>(wpack),
               static_cast<const int64_t*>(q), n_polys, L, 0, 0};
  k<<<n_polys, split_threads(logn), smem,
      static_cast<cudaStream_t>(stream)>>>(a, static_cast<const uint8_t*>(mat),
                                           static_cast<const int64_t*>(pw));
  return static_cast<int>(cudaGetLastError());
}
