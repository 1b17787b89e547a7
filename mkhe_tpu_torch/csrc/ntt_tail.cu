// The split negacyclic NTT for Hopper (sm_90a): head, int8 tail, and the
// inverse that starts after the tail.
//
// Replaces the TPU kernels of mkhe_tpu/ops/ntt_pallas.py's MXU-tail form
// (config.pallas_ntt_mxu_tail): _fwd_kernel(head_only=True) (:80-104),
// _inv_kernel(tail_done=True) (:159-175, 199-225) and the XLA int8 matrix
// products of _tail_apply (:266-312). The transform is "twist by psi^j,
// then DIF stages with block-periodic twiddles" (ntt_pallas.py:9-17), not
// ntt.cu's merged-twist Cooley-Tukey: only in this decimation do the
// stages with half-block h < 128 act on every 128-lane block by the same
// fixed 128x128 map M over Z_q (tables: ops/ring.py::SplitTables).
//
//   ntt_fwd_head_kernel   twist, then DIF stages h = N/2 .. 128 (wpack).
//   ntt_tail_kernel       out_block = x_block @ M on every 128-lane block.
//   ntt_inv_tailed_kernel DIT stages h = 128 .. N/2 (iwpack), then untwist
//                         by psi^-j / N.
// forward = tail(head(x), tail_fwd); inverse = inv_tailed(tail(x, tail_inv)).
// Every output is canonical, equal bit for bit to the plain PyTorch
// versions in ops/ntt_cuda.py.
//
// Head and inverse: one block per polynomial in dynamic shared memory, as
// in ntt.cu, with exact Shoup twiddle multiplies; bound by integer
// multiplies and shared-memory traffic, 8 stages at N = 2^15 instead of 15.
//
// Tail: the product runs on the tensor cores as mma.sync m16n8k32
// s8 x s8 -> s32 (the counterpart of the TPU's MXU). x is split into 5
// base-2^7 digit planes (any u32 is exact in 35 bits), M is stored as 5
// such planes (int8, 0..127, so no sign trouble), and the 25 plane products
// are summed into 9 partial sums s_t, t = digit of x + digit of M, each
// < 5 * 128 * 127^2 < 2^24 (exact in s32). The recombination
// sum_t s_t * (2^(7t+32) mod q) < 2^56 is taken in u64 and reduced by one
// Montgomery step to the canonical x @ M mod q. One block per polynomial;
// the block stages its limb's 5 planes transposed (M^T, padded rows) in
// shared memory, and each warp takes 16-row tiles of the polynomial's
// N/128 blocks: the tile's A fragments (5 planes x 4 k-steps) stay in
// registers while the warp walks the 16 output tiles of 8 lanes. Per tile
// that is 1600 mma.sync and 20 KiB of shared-memory B-fragment reads; at
// N = 2^15 the kernel reads and writes 256 KiB of data per polynomial and
// 80 KiB of M from L2. No wgmma, TMA or multi-polynomial blocking yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;                 // lanes of one tail block
constexpr int kDigits = 5;                  // base-2^7 digit planes
constexpr int kDigitBits = 7;
constexpr int kSums = 2 * kDigits - 1;      // partial sums s_0 .. s_8
constexpr int kTailThreads = 128;           // 4 warps
constexpr int kRowBytes = kLanes + 16;      // padded M^T row: conflict-free
constexpr int kPlaneBytes = kLanes * kRowBytes;
constexpr size_t kTailSmem = static_cast<size_t>(kDigits) * kPlaneBytes;

__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t q) {
  return a >= q ? a - q : a;
}

// a * w mod q for any a < 2^32, w < q, wsh = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  uint32_t t = __umulhi(a, wsh);
  return csub(a * w - t * q, q);
}

// any a < 2^32 -> [0, q), bar = floor(2^32 / q).
__device__ __forceinline__ uint32_t barrett(uint32_t a, uint32_t q,
                                            uint32_t bar) {
  uint32_t r = a - __umulhi(a, bar) * q;
  return csub(csub(r, q), q);
}

__global__ void __launch_bounds__(1024)
ntt_fwd_head_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                    const int64_t* __restrict__ twist,
                    const int64_t* __restrict__ twist_sh,
                    const int64_t* __restrict__ wpack,
                    const int64_t* __restrict__ wpack_sh,
                    const int64_t* __restrict__ qv, int L, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const size_t row = static_cast<size_t>(limb) * n;
  const uint32_t q = static_cast<uint32_t>(qv[limb]);

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = shoup_mul(static_cast<uint32_t>(x[base + i]),
                     static_cast<uint32_t>(twist[row + i]),
                     static_cast<uint32_t>(twist_sh[row + i]), q);
  __syncthreads();
  // stage h: top T = s[2h b + l], bottom B = s[2h b + h + l];
  // T' = T + B, B' = (T - B) * wpack[N - 2h + l]
  for (int logh = logn - 1; logh >= 7; --logh) {
    const int h = 1 << logh;
    const int64_t* w = wpack + row + (n - 2 * h);
    const int64_t* wsh = wpack_sh + row + (n - 2 * h);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int l = k & (h - 1);
      const int iu = ((k >> logh) << (logh + 1)) + l;
      const int iv = iu + h;
      const uint32_t u = s[iu];
      const uint32_t v = s[iv];
      s[iu] = csub(u + v, q);
      s[iv] = shoup_mul(u + q - v, static_cast<uint32_t>(w[l]),
                        static_cast<uint32_t>(wsh[l]), q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = static_cast<int64_t>(s[i]);
}

__global__ void __launch_bounds__(1024)
ntt_inv_tailed_kernel(const int64_t* __restrict__ x,
                      int64_t* __restrict__ out,
                      const int64_t* __restrict__ iwpack,
                      const int64_t* __restrict__ iwpack_sh,
                      const int64_t* __restrict__ untwist,
                      const int64_t* __restrict__ untwist_sh,
                      const int64_t* __restrict__ qv,
                      const int64_t* __restrict__ barv, int L, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const size_t row = static_cast<size_t>(limb) * n;
  const uint32_t q = static_cast<uint32_t>(qv[limb]);
  const uint32_t bar = static_cast<uint32_t>(barv[limb]);

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = barrett(static_cast<uint32_t>(x[base + i]), q, bar);
  __syncthreads();
  // stage h: v = B * iwpack[N - 2h + l]; T' = T + v, B' = T - v
  for (int logh = 7; logh < logn; ++logh) {
    const int h = 1 << logh;
    const int64_t* w = iwpack + row + (n - 2 * h);
    const int64_t* wsh = iwpack_sh + row + (n - 2 * h);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int l = k & (h - 1);
      const int iu = ((k >> logh) << (logh + 1)) + l;
      const int iv = iu + h;
      const uint32_t u = s[iu];
      const uint32_t v = shoup_mul(s[iv], static_cast<uint32_t>(w[l]),
                                   static_cast<uint32_t>(wsh[l]), q);
      s[iu] = csub(u + v, q);
      s[iv] = csub(u + q - v, q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = static_cast<int64_t>(
        shoup_mul(s[i], static_cast<uint32_t>(untwist[row + i]),
                  static_cast<uint32_t>(untwist_sh[row + i]), q));
}

// D += A (16x32, row) * B (32x8, col), s8 x s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Digit `d` (bits 7d .. 7d+6) of four values, packed low byte first.
__device__ __forceinline__ uint32_t digit_pack(const uint32_t (&v)[4],
                                               int d) {
  const int sh = kDigitBits * d;
  uint32_t r = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) r |= ((v[e] >> sh) & 0x7Fu) << (8 * e);
  return r;
}

__global__ void __launch_bounds__(kTailThreads)
ntt_tail_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                const int8_t* __restrict__ mat,
                const int64_t* __restrict__ powv,
                const int64_t* __restrict__ qv, int L, int logn) {
  extern __shared__ __align__(16) uint8_t mt[];  // [plane][j][i], M^T
  const int n = 1 << logn;
  const int rows = n / kLanes;  // 128-lane blocks of this polynomial
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t q = static_cast<uint32_t>(qv[limb]);

  // Stage M^T: mt[d][j][i] = M_d[i][j] (M_d row-major, out = x @ M),
  // reading four consecutive j of one row i per 32-bit load.
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(
      mat + static_cast<size_t>(limb) * kDigits * kLanes * kLanes);
  for (int e = threadIdx.x; e < kDigits * kLanes * kLanes / 4;
       e += blockDim.x) {
    const uint32_t w = m4[e];
    const int d = e / (kLanes * kLanes / 4);
    const int i = (e / (kLanes / 4)) % kLanes;
    const int j = (e % (kLanes / 4)) * 4;
    uint8_t* dst = mt + d * kPlaneBytes + j * kRowBytes + i;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[b * kRowBytes] = static_cast<uint8_t>(w >> (8 * b));
  }
  // Montgomery constant -q^-1 mod 2^32 by Newton's iteration (q odd:
  // q * q = 1 mod 8, and each step doubles the correct low bits).
  uint32_t qinv = q;
#pragma unroll
  for (int it = 0; it < 4; ++it) qinv *= 2u - q * qinv;
  const uint32_t qneg_inv = 0u - qinv;
  uint32_t pw[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t)
    pw[t] = static_cast<uint32_t>(powv[limb * kSums + t]);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int c = lane & 3;   // thread in group
  const int tiles = (rows + 15) / 16;
  for (int tile = warp; tile < tiles; tile += kTailThreads / 32) {
    const int r0 = tile * 16 + g;  // this lane's rows r0 and r0 + 8
    const bool ok0 = r0 < rows;
    const bool ok1 = r0 + 8 < rows;
    const int64_t* x0 = x + base + static_cast<size_t>(r0) * kLanes;
    const int64_t* x1 = x0 + 8 * kLanes;
    // A fragments of the 5 digit planes over the 4 k-steps of 32 lanes:
    // a[d][ks] = {row r0 cols c4.., row r0+8 cols c4.., row r0 cols
    // 16+c4.., row r0+8 cols 16+c4..}, c4 = 32 ks + 4 c.
    uint32_t a[kDigits][4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = ks * 32 + hf * 16 + c * 4;
        uint32_t v0[4], v1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v0[e] = ok0 ? static_cast<uint32_t>(x0[col + e]) : 0u;
          v1[e] = ok1 ? static_cast<uint32_t>(x1[col + e]) : 0u;
        }
#pragma unroll
        for (int d = 0; d < kDigits; ++d) {
          a[d][ks][2 * hf] = digit_pack(v0, d);
          a[d][ks][2 * hf + 1] = digit_pack(v1, d);
        }
      }
    }
    for (int nt = 0; nt < kLanes / 8; ++nt) {
      int acc[kSums][4];
#pragma unroll
      for (int t = 0; t < kSums; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
#pragma unroll
      for (int dm = 0; dm < kDigits; ++dm) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // B fragment: k rows 32 ks + 4c .. +3 and +16, column nt*8 + g
          const uint8_t* bp = mt + dm * kPlaneBytes +
                              (nt * 8 + g) * kRowBytes + ks * 32 + c * 4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
          for (int dx = 0; dx < kDigits; ++dx)
            mma_s8(acc[dx + dm], a[dx][ks], b0, b1);
        }
      }
      // D fragment: rows r0 (i < 2) and r0 + 8, cols nt*8 + 2c + (i & 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(i < 2 ? ok0 : ok1)) continue;
        uint64_t sum = 0;  // < 9 * 2^24 * 2^29
#pragma unroll
        for (int t = 0; t < kSums; ++t)
          sum += static_cast<uint64_t>(static_cast<uint32_t>(acc[t][i])) *
                 pw[t];
        const uint32_t mq = static_cast<uint32_t>(sum) * qneg_inv;
        const uint32_t r = static_cast<uint32_t>(
            (sum + static_cast<uint64_t>(mq) * q) >> 32);  // < 1.1 q
        const int rr = r0 + (i < 2 ? 0 : 8);
        out[base + static_cast<size_t>(rr) * kLanes + nt * 8 + 2 * c +
            (i & 1)] = static_cast<int64_t>(csub(r, q));
      }
    }
  }
}

template <typename Kernel>
cudaError_t prepare_stages(Kernel kernel, int logn, size_t* smem,
                           int* threads) {
  if (logn < 7 || logn > 15) return cudaErrorInvalidValue;
  const int n = 1 << logn;
  *smem = static_cast<size_t>(n) * sizeof(uint32_t);
  *threads = n / 2 < 1024 ? n / 2 : 1024;
  // Above 48 KiB of dynamic shared memory the launch is refused unless
  // the kernel has opted in.
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// Plain C interface (loaded with ctypes). Every pointer is device memory;
// stream is a cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int mkhe_ntt_fwd_head(const void* x, void* out, const void* twist,
                                 const void* twist_sh, const void* wpack,
                                 const void* wpack_sh, const void* q,
                                 int n_polys, int L, int logn,
                                 void* stream) {
  size_t smem;
  int threads;
  cudaError_t err = prepare_stages(ntt_fwd_head_kernel, logn, &smem,
                                   &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_head_kernel<<<n_polys, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const int64_t*>(twist),
      static_cast<const int64_t*>(twist_sh),
      static_cast<const int64_t*>(wpack),
      static_cast<const int64_t*>(wpack_sh), static_cast<const int64_t*>(q),
      L, logn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mkhe_ntt_tail(const void* x, void* out, const void* mat,
                             const void* pow, const void* q, int n_polys,
                             int L, int logn, void* stream) {
  if (logn < 7 || logn > 15) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTailSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_tail_kernel<<<n_polys, kTailThreads, kTailSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const int8_t*>(mat), static_cast<const int64_t*>(pow),
      static_cast<const int64_t*>(q), L, logn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mkhe_ntt_inv_tailed(const void* x, void* out,
                                   const void* iwpack, const void* iwpack_sh,
                                   const void* untwist,
                                   const void* untwist_sh, const void* q,
                                   const void* bar, int n_polys, int L,
                                   int logn, void* stream) {
  size_t smem;
  int threads;
  cudaError_t err = prepare_stages(ntt_inv_tailed_kernel, logn, &smem,
                                   &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_tailed_kernel<<<n_polys, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const int64_t*>(iwpack),
      static_cast<const int64_t*>(iwpack_sh),
      static_cast<const int64_t*>(untwist),
      static_cast<const int64_t*>(untwist_sh),
      static_cast<const int64_t*>(q), static_cast<const int64_t*>(bar), L,
      logn);
  return static_cast<int>(cudaGetLastError());
}
