// The split negacyclic NTT for Hopper (sm_90a), both directions: the
// forward's head, the int8 tail map, the inverse's DIT stages, alone or
// fused into one kernel that makes one HBM pass.
//
// Replaces the TPU kernels of mkhe_tpu/ops/ntt_pallas.py's MXU-tail form
// (config.pallas_ntt_mxu_tail): _fwd_kernel(head_only=True) (the stages of
// _fwd_stages, :47-104, through _fwd_kernel :126), the int8 matrix products
// of _tail_apply (:266-312) and _inv_kernel(tail_done=True) (:138-225, the
// stages of :159-175 and :199-225). The transform is "twist by psi^j, then
// DIF stages on the stage-packed wpack table" (ntt_pallas.py:9-17); in this
// decimation the 7 stages with half-block h < 128 act on every 128-lane row
// by one fixed 128x128 map M over Z_q (ops/ring.py::SplitTables), and the
// inverse is that map's inverse M_inv, then DIT stages h = 128 .. N/2 on
// iwpack, then the untwist by psi^-j / N. Two templates, five modes (the
// mode bits of mkhe_ntt_split: 1 head, 2 tail, 4 inverse):
//
//   head + tail  (3) the forward NTT (Ring.ntt with config.ntt_mxu_tail):
//                HBM is read once, with the twist, inside the head's first
//                pass; the head's logN - 7 stages run as ntt_dif.cuh's
//                register passes; the polynomial stays in shared memory;
//                the tail map runs there on every row; the output is
//                written once, canonical, in 16-byte stores.
//   tail only    (2) out = x @ M on every row, any u32 input, either map.
//   head only    (1) twist and the head's stages, canonical (ntt_head).
//   tail + DIT   (6) the inverse NTT (Ring.intt with config.ntt_mxu_tail):
//                x read once in 16-byte loads into shared memory; the
//                tail map M_inv on the tensor cores, written back in place;
//                the DIT stages as register passes from bit 7 up; the
//                untwist and the one canonical HBM write in the last pass.
//   DIT only     (4) _inv_kernel(tail_done=True) alone (intt_tailed): x
//                reduced by Barrett on the way in, then as tail + DIT.
//
// Every output equals its plain PyTorch version (ops/ntt_cuda.py) bit for
// bit; head + tail also equals ntt.cu's full forward kernel, tail + DIT its
// full inverse.
//
// The tail on the tensor cores: mma.sync m16n8k32 u8 x u8 -> s32. x (any
// u32) is 4 base-2^8 digit planes and M (< q < 2^30) 4 more; the 16 plane
// products add into 7 partial sums s_t (t = digit of x + digit of M), each
// below 4 * 128 * 255^2 < 2^25; sum_t s_t * (2^(8t+32) mod q) < 7 * 2^25 * q
// is taken in u64 and one Montgomery step and one conditional subtraction
// give the canonical x @ M mod q. (The JAX package's 5 s8 planes need 25
// products; the plain version keeps them, the result is the same.)
//
// What bounds it on an H100: the bytes. At 8 x 32 x 2^15 a fused mode
// moves 16 B a coefficient (134.2 MB) plus its packed twist and wpack (or
// untwist and iwpack; 16.8 MB) and each limb's M table (2.1 MB): 0.046 ms
// at 3.35 TB/s. Its int8 products (16 x 2 x 128 operations a coefficient,
// 34.4 G) take 0.017 ms at the dense rate and its int32 work less than the
// bytes. What the design does about the kernels it replaced (two HBM
// passes; M restaged byte by byte, transposed, for every polynomial; 2
// blocks of 4 warps an SM; A fragments read from HBM as int64; scattered
// 8-byte stores; one butterfly a thread per stage with a block barrier
// each; twiddles as two int64 tables):
// - One HBM pass: the forward's head ends in shared memory (passes<...,
//   kOut = false>), and the tail reads its A fragments there; the
//   inverse's tail writes its output back in place, and the DIT passes
//   start from it.
// - M is stored once, per limb, in fragment order (ntt_cuda.tail_fragments:
//   plane, k-step, n-tile, lane, the lane's 8 bytes), so a block stages its
//   limb's 64 KiB with 16-byte cp.async copies issued at kernel entry,
//   overlapping the head (or the inverse's HBM read), and each B fragment
//   is one conflict-free 8-byte shared load.
// - The A fragments come from the padded polynomial (word i + i / 32) with
//   the k index permuted: MMA k = 16 hf + 4 c + e (thread c of its group,
//   register half hf, byte e) takes column 16 hf + c + 4 e of the k-step,
//   and M's table the same row, so a warp's 32 loads hit 32 banks. Four
//   values' bytes are transposed into the 4 planes with byte permutes.
// - A block holds one polynomial: max(128, min(512, N / 32)) threads, 2^5
//   values a thread in the head and the DIT passes (2^6 at logN 15, so 128
//   registers a thread at one block an SM). The forward's warp accumulates
//   two 16 x 8 output tiles (56 accumulators) over the 4 k-steps, and
//   writes each tile's values straight from the D fragment, canonical, two
//   neighbours in one 16-byte store (every 32-byte sector whole).
// - The inverse's tail in place (tail_rows_in_place): a warp holds its
//   16-row tile's A fragments for all 4 k-steps (64 registers), so it reads
//   them once, and only then writes, one n-tile (28 accumulators) at a
//   time. Where there are as many row tiles as warps or more, each warp owns
//   its rows and a __syncwarp orders its reads before its writes; where
//   there are fewer (logN < 15), kSplit warps share a row tile, each with
//   16 / kSplit n-tiles, and one block barrier stands between all reads
//   and all writes (ntt_cuda.tail_schedule; tests/test_torch_ntt_tail.py
//   checks it).
// - The DIT stages (dit_passes): register passes over bits [7, 7 + r) and
//   then 5 bits each (the head's passes in reverse), Harvey's lazy
//   Cooley-Tukey butterflies (values below 4q, canonical once, in the last
//   pass), padded conflict-free shared memory between passes; a lane reads
//   its own packed twiddle w | w_sh << 32 of iwpack (8 bytes; neighbouring
//   lanes on neighbouring words), and the last pass its packed untwist, and
//   writes HBM in coalesced 8-byte stores (a thread's values there are
//   2^lo >= 2^10 apart, so no 16-byte pairs).
// - Shared memory at logN 15: 4 (2^15 + 2^10) B of polynomial and 64 KiB of
//   M, 200,704 B of the 232,448 a block may have.
// Built for logN 8 .. 15 (Ring.ntt / intt split from N = 256) in the five
// modes.

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
constexpr int kTailLogLanes = 7;         // the DIT stages start at bit 7
constexpr int kHeadMode = 1;  // mode bits of the C entry
constexpr int kTailMode = 2;
constexpr int kInvMode = 4;

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

// What the tail's recombination needs of its limb: q, -q^-1 mod 2^32 (by
// Newton's iteration: q odd, so q * q = 1 mod 8, and each step doubles the
// correct low bits) and pw[t] = 2^(8t+32) mod q.
struct Recomb {
  uint32_t q, qneg_inv, pw[kSums];

  __device__ __forceinline__ Recomb(uint32_t q_, const int64_t* p) : q(q_) {
    uint32_t qinv = q;
#pragma unroll
    for (int it = 0; it < 4; ++it) qinv *= 2u - q * qinv;
    qneg_inv = 0u - qinv;
#pragma unroll
    for (int t = 0; t < kSums; ++t) pw[t] = static_cast<uint32_t>(p[t]);
  }

  // sum_u s_u pw[u] 2^-32 mod q, canonical, of the partial sums s_u =
  // acc[u][k]: below 7 * 2^25 * q < 2^58 in u64, then one Montgomery step
  // (below 1.06 q) and one conditional subtraction.
  __device__ __forceinline__ uint32_t operator()(const int (&acc)[kSums][4],
                                                 int k) const {
    uint64_t sum = 0;
#pragma unroll
    for (int u = 0; u < kSums; ++u)
      sum += static_cast<uint64_t>(static_cast<uint32_t>(acc[u][k])) * pw[u];
    const uint32_t mq = static_cast<uint32_t>(sum) * qneg_inv;
    return csub(
        static_cast<uint32_t>((sum + static_cast<uint64_t>(mq) * q) >> 32), q);
  }
};

// a[d][j]: plane d of A register j = {row r0, row r0 + 8} x {hf 0, 1} of
// k-step ks, read from the padded polynomial s (row r at word 132 r); byte
// e of register j holds column 32 ks + 16 hf + c + 4 e, and a row that is
// not ok reads as 0.
__device__ __forceinline__ void load_a(const uint32_t* s, int r0,
                                       const bool (&ok)[2], int ks, int c,
                                       uint32_t (&a)[kPlanes][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int hi = j & 1;
    const int at = 132 * (r0 + 8 * hi) + 33 * ks + 16 * (j >> 1) + c;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ok[hi] ? s[at + 4 * e] : 0u;
    byte_planes(v, a[0][j], a[1][j], a[2][j], a[3][j]);
  }
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
  const Recomb rec(q, pw);

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
      uint32_t a[kPlanes][4];
      load_a(s, r0, ok, ks, c, a);
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
        if (ok[hi])
          __stcs(reinterpret_cast<longlong2*>(
                     out + (r0 + 8 * hi) * kLanes + 8 * (nt0 + t) + 2 * c),
                 make_longlong2(rec(acc[t], 2 * hi), rec(acc[t], 2 * hi + 1)));
      }
    }
  }
}

// Start the cp.async copies of the limb's M table (16 bytes each) into
// the start of shared memory; the caller waits (cp.async.wait_all).
template <int kThreads>
__device__ __forceinline__ void stage_matrix(uint8_t* smem, const uint8_t* mat,
                                             int limb) {
  const uint8_t* src = mat + static_cast<size_t>(limb) * kMatBytes;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  for (int i = 16 * threadIdx.x; i < kMatBytes; i += 16 * kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(dst + i), "l"(src + i));
  asm volatile("cp.async.commit_group;\n" ::);
}

// x (the low words of n int64) into padded shared memory, 16 bytes a load;
// with kReduce each value by Barrett below 2q (bar = floor(2^32 / q)).
template <int kLogN, bool kReduce>
__device__ __forceinline__ void load_poly(const int64_t* x, uint32_t* s,
                                          uint32_t q, uint32_t bar) {
  constexpr int kThreads = split_threads(kLogN);
  for (int i = 2 * threadIdx.x; i < (1 << kLogN); i += 2 * kThreads) {
    const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(x + i));
    uint32_t v0 = static_cast<uint32_t>(v.x), v1 = static_cast<uint32_t>(v.y);
    if (kReduce) {
      v0 -= __umulhi(v0, bar) * q;
      v1 -= __umulhi(v1, bar) * q;
    }
    s[padded(i)] = v0;
    s[padded(i) + 1] = v1;
  }
}

// One polynomial a block (blockIdx.x, on limb blockIdx.x % L).
template <int kLogN, bool kHead, bool kTail>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt_split_kernel(const Args a, const uint8_t* __restrict__ mat,
                 const int64_t* __restrict__ pw, const int64_t* __restrict__) {
  constexpr int kThreads = split_threads(kLogN);
  constexpr int kLV = kLogN - log2c(kThreads);  // head values a thread
  static_assert(kMinLogN <= kLogN && kLogN <= kMaxLogN, "logN 8 .. 15");
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem + (kTail ? kMatBytes : 0));
  const int limb = blockIdx.x % a.L;
  const size_t base = static_cast<size_t>(blockIdx.x) << kLogN;
  // the limb's M table in flight during the head
  if constexpr (kTail) stage_matrix<kThreads>(smem, mat, limb);
  if constexpr (kHead)
    passes<kLogN, kLogN - kTailLogLanes, true, 0, kLV, !kTail>(a, s);
  else
    load_poly<kLogN, false>(a.x + base, s, 0u, 0u);
  if constexpr (kTail) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    tail_rows<kLogN>(s, reinterpret_cast<const uint32_t*>(smem),
                     a.out + base, static_cast<uint32_t>(__ldg(a.q + limb)),
                     pw + limb * kSums);
  }
}

// out_row = x_row @ M, in place, for every 128-lane row of the polynomial
// in shared memory at s (padded, any u32 in, canonical out), M's fragment
// table at m. A warp's item is a 16-row tile and kTiles of its n-tiles; it
// loads the tile's A fragments for all 4 k-steps, then writes. With kSplit
// = 1 every warp owns its row tiles (a __syncwarp between reads and
// writes); with kSplit > 1 (fewer row tiles than warps) kSplit warps share
// one, each warp has one item, and a block barrier stands between every
// read and every write (ops/ntt_cuda.py::tail_schedule is this rule).
template <int kLogN>
__device__ __forceinline__ void tail_rows_in_place(uint32_t* s,
                                                   const uint32_t* m,
                                                   uint32_t q,
                                                   const int64_t* pw) {
  constexpr int kRows = (1 << kLogN) / kLanes;
  constexpr int kRowTiles = (kRows + 15) / 16;
  constexpr int kWarps = split_threads(kLogN) / 32;
  constexpr int kSplit = kWarps > kRowTiles ? kWarps / kRowTiles : 1;
  constexpr int kTiles = kColTiles / kSplit;
  constexpr int kItems = kRowTiles * kSplit;
  static_assert(kSplit == 1 || kItems == kWarps,
                "warps that share a row tile have one item each");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int c = lane & 3;   // thread in group
  const Recomb rec(q, pw);

  for (int item = warp; item < kItems; item += kWarps) {
    const int r0 = item / kSplit * 16 + g;  // this lane's rows r0, r0 + 8
    const int nt0 = item % kSplit * kTiles;
    const bool ok[2] = {r0 < kRows, r0 + 8 < kRows};
    uint32_t a[kKSteps][kPlanes][4];  // every k-step's A fragments
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) load_a(s, r0, ok, ks, c, a[ks]);
    if constexpr (kSplit > 1)
      __syncthreads();
    else
      __syncwarp();
#pragma unroll 1
    for (int t = 0; t < kTiles; ++t) {
      const int nt = nt0 + t;
      int acc[kSums][4];
#pragma unroll
      for (int u = 0; u < kSums; ++u)
        acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int dm = 0; dm < kPlanes; ++dm) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              m + 2 * (((dm * kKSteps + ks) * kColTiles + nt) * 32 + lane));
#pragma unroll
          for (int dx = 0; dx < kPlanes; ++dx)
            mma_u8(acc[dx + dm], a[ks][dx], b.x, b.y);
        }
      }
      // D fragment: acc[u][2 hi + e] is row r0 + 8 hi, column 8 nt + 2 c + e
      const int col = 8 * nt + 2 * c;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ok[hi])
            s[132 * (r0 + 8 * hi) + col + (col >> 5) + e] =
                rec(acc, 2 * hi + e);
      }
    }
  }
}

// Cooley-Tukey (DIT) butterfly of the split inverse, w = iwpack[N - 2h +
// (j mod h)] packed with its Shoup quotient: x, y in [0, 4q) -> x + w y,
// x - w y in [0, 4q).
__device__ __forceinline__ void dit_bfly(uint32_t& x, uint32_t& y, uint64_t w,
                                         uint32_t q, uint32_t q2) {
  const uint32_t u = csub(x, q2);
  const uint32_t t = shoup_lazy(y, w, q);
  x = u + t;
  y = u - t + q2;
}

// Stages bit B = kLo + J, J = kJ .. R - 1, of a DIT register pass over
// bits [kLo, kLo + R): the butterflies (c0, c0 + 2^J) of the 2^R values;
// the top of (c0, c1) is position j = j0 | c0 << kLo of its polynomial and
// takes twiddle t[(c0 mod 2^J) << kLo | jl] of the stage's table t =
// iwpack + N - 2h, jl = j0 mod 2^kLo: each lane its own word.
template <int kLogN, int kLo, int R, int kJ>
__device__ __forceinline__ void dit_stages(uint32_t (&v)[1 << R],
                                           const uint64_t* tw, int jl,
                                           uint32_t q, uint32_t q2) {
  if constexpr (kJ < R) {
    constexpr int B = kLo + kJ;
    const uint64_t* t = tw + ((1 << kLogN) - (2 << B)) + jl;
#pragma unroll
    for (int low = 0; low < (1 << kJ); ++low) {
      const uint64_t w = __ldg(t + (low << kLo));
#pragma unroll
      for (int hi = 0; hi < (1 << (R - 1 - kJ)); ++hi) {
        const int c0 = (hi << (kJ + 1)) | low;
        dit_bfly(v[c0], v[c0 | (1 << kJ)], w, q, q2);
      }
    }
    dit_stages<kLogN, kLo, R, kJ + 1>(v, tw, jl, q, q2);
  }
}

// One DIT register pass of R stages over bits [kLo, kLo + R) (kLo >= 7) of
// the block's polynomial in shared memory: each of the thread's 2^kLV /
// 2^R groups is read, transformed and written in turn (`dep`, as in
// ntt_dif.cuh's run_pass). kLast untwists (a.twist: the packed untwist),
// makes the values canonical and writes HBM, each warp 32 neighbouring
// int64 a store.
template <int kLogN, int kLo, int R, bool kLast, int kLV>
__device__ __forceinline__ void dit_pass(const Args& a, uint32_t* s,
                                         int limb, size_t base) {
  constexpr int G = (1 << kLV) >> R;
  constexpr int C = 1 << R;
  constexpr int kThreads = split_threads(kLogN);
  constexpr int stride = (1 << kLo) + ((1 << kLo) >> 5);
  static_assert(kLV >= R && kLo >= 5, "a group in one thread, word stride");
  const uint32_t q = static_cast<uint32_t>(__ldg(a.q + limb));
  const uint32_t q2 = 2 * q;
  const uint64_t* tw = a.wpack + (static_cast<size_t>(limb) << kLogN);
  int dep = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j0 = value_index(threadIdx.x, kThreads, g, 0, kLo, R) + dep;
    const int pb = padded(j0);
    uint32_t v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = s[pb + c * stride];
    dit_stages<kLogN, kLo, R, 0>(v, tw, j0 & ((1 << kLo) - 1), q, q2);
    if constexpr (kLast) {
      // an opaque copy of j0: the untwist's loads and the stores work their
      // addresses out after the stages instead of keeping them live
      int sj;
      asm volatile("mov.b32 %0, %1;" : "=r"(sj) : "r"(j0));
      const uint64_t* ut =
          a.twist + (static_cast<size_t>(limb) << kLogN) + sj;
      int64_t* o = a.out + base + sj;
#pragma unroll
      for (int c = 0; c < C; ++c)
        __stcs(reinterpret_cast<long long*>(o + (c << kLo)),
               static_cast<long long>(
                   csub(shoup_lazy(v[c], __ldg(ut + (c << kLo)), q), q)));
    } else {
      int spb;
      asm volatile("mov.b32 %0, %1;" : "=r"(spb) : "r"(pb));
#pragma unroll
      for (int c = 0; c < C; ++c) s[spb + c * stride] = v[c];
    }
    dep = never(v[0]);
  }
}

// The DIT passes from bit kLo = 7 up: the first over (logN - 7) mod 5 bits
// where that is not 0, then 5 bits each (ops/ntt_cuda.py::
// split_inv_passes); a block barrier between passes.
template <int kLogN, int kLo, int kLV>
__device__ __forceinline__ void dit_passes(const Args& a, uint32_t* s,
                                           int limb, size_t base) {
  constexpr int kRest = (kLogN - kTailLogLanes) % kMaxPassBits;
  constexpr int R = kLo == kTailLogLanes && kRest ? kRest : kMaxPassBits;
  constexpr bool kLast = kLo + R == kLogN;
  dit_pass<kLogN, kLo, R, kLast, kLV>(a, s, limb, base);
  if constexpr (!kLast) {
    __syncthreads();
    dit_passes<kLogN, kLo + R, kLV>(a, s, limb, base);
  }
}

// The split inverse, one polynomial a block: with kTail x @ M_inv (any u32
// in) then the DIT stages; without, x reduced by Barrett then the DIT
// stages. a.twist is the packed untwist, a.wpack the packed iwpack.
template <int kLogN, bool kTail>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt_split_inv_kernel(const Args a, const uint8_t* __restrict__ mat,
                     const int64_t* __restrict__ pw,
                     const int64_t* __restrict__ bar) {
  constexpr int kThreads = split_threads(kLogN);
  constexpr int kLV = kLogN - log2c(kThreads);  // DIT values a thread
  static_assert(kMinLogN <= kLogN && kLogN <= kMaxLogN, "logN 8 .. 15");
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem + (kTail ? kMatBytes : 0));
  const int limb = blockIdx.x % a.L;
  const size_t base = static_cast<size_t>(blockIdx.x) << kLogN;
  const uint32_t q = static_cast<uint32_t>(__ldg(a.q + limb));
  // the limb's M_inv table in flight during the HBM read
  if constexpr (kTail) stage_matrix<kThreads>(smem, mat, limb);
  load_poly<kLogN, !kTail>(
      a.x + base, s, q, kTail ? 0u : static_cast<uint32_t>(__ldg(bar + limb)));
  if constexpr (kTail) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    tail_rows_in_place<kLogN>(s, reinterpret_cast<const uint32_t*>(smem), q,
                              pw + limb * kSums);
  }
  __syncthreads();
  dit_passes<kLogN, kTailLogLanes, kLV>(a, s, limb, base);
}

using Kernel = void (*)(const Args, const uint8_t*, const int64_t*,
                        const int64_t*);

template <int kLogN>
Kernel find(int mode) {
  switch (mode) {
    case kHeadMode: return ntt_split_kernel<kLogN, true, false>;
    case kTailMode: return ntt_split_kernel<kLogN, false, true>;
    case kHeadMode | kTailMode: return ntt_split_kernel<kLogN, true, true>;
    case kInvMode: return ntt_split_inv_kernel<kLogN, false>;
    case kInvMode | kTailMode: return ntt_split_inv_kernel<kLogN, true>;
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
// stream is a cudaStream_t. mode: 1 head, 2 tail, 3 head + tail (the
// forward), 4 DIT, 6 tail + DIT (the inverse). The head reads twist and
// wpack ((L, N) packed, natural order); the DIT stages read the packed
// untwist as twist and the packed iwpack as wpack, and, alone, bar
// ((L,), floor(2^32 / q)); the tail reads mat ((L, 65536) bytes,
// ntt_cuda.tail_fragments, 16-byte aligned) and pw ((L, 7), 2^(8t+32) mod
// q); x is 16-byte aligned in every mode but the head's. A logN outside
// 8 .. 15, another mode or n_polys not a multiple of L gives
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
extern "C" int mkhe_ntt_split(const void* x, void* out, const void* twist,
                              const void* wpack, const void* mat,
                              const void* pw, const void* q, const void* bar,
                              int n_polys, int L, int logn, int mode,
                              void* stream) {
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
                                           static_cast<const int64_t*>(pw),
                                           static_cast<const int64_t*>(bar));
  return static_cast<int>(cudaGetLastError());
}
