// Key-switching element-wise kernels for Hopper (sm_90a): the exact RNS
// basis extension (mod_up, with a digit axis for the gadget decomposition),
// the ModDown, the Montgomery contraction of the key products, the CKKS
// rescale (the divide-and-round by the last moduli), and the KKLSS tensor
// terms in the NTT domain (tensor_kernel, at the end of the file).
//
// These have no Pallas counterpart. In the JAX package XLA fuses each of
// them into one element-wise pass of the jitted evaluator programs
// (mkhe_tpu/mkckks/evaluator.py:33-122):
//   basis_kernel<.., false>: mod_up, mkhe_tpu/ops/basis.py:93-154, and the
//     digits of decompose_digits (:202-230) in one launch;
//   basis_kernel<.., true>:  mod_down, basis.py:179-199 (mod_up's P -> Q
//     extension with the (xq - conv) * P^-1 epilogue);
//   mul_accum_kernel:        the 64-bit (hi, lo) accumulate and one
//     Montgomery reduction of the key contractions,
//     mkhe_tpu/mkrlwe/keyswitch.py:82-175 and ops/modmath.py:207-227;
//   rescale_kernel:          div_round_by_last_moduli, mkhe_tpu/ops/
//     basis.py, every dropped limb in one pass (see the kernel);
//   tensor_kernel:           the tensor terms of the mult,
//     mkhe_tpu/mkrlwe/keyswitch.py:274-289 (see the kernel).
// Each gives the canonical residue its plain PyTorch version gives
// (ops/basis_cuda.py); a canonical residue is unique, so any exact u32/u64
// arithmetic agrees bit for bit. The one inexact step, mod_up's float32
// correction v = floor(sum_i fl32(y_i) * inv_b_i), rounds every product and
// every sum once, left to right (__fmul_rn / __fadd_rn: nvcc would contract
// a*b+c into an FMA, and an off-by-one v moves the output by B).
//
// Layout: data int64 holding u32 values, N contiguous (stride 1); the other
// axes come as element strides. Moduli are below 2^29 (checked by the
// wrapper), so a product of two residues is below 2^58 and 64 of them fit a
// u64.
//
// What bounds them on an H100: the bytes. A mod_up digit of 2 limbs reads
// 16 B and writes 32 x 8 B per coefficient for ~15 integer instructions per
// output; a contraction term reads 16 B for one wide multiply-add. So the
// design is one thread per coefficient (mod_up, ModDown: per polynomial,
// digit and coefficient, looping over the output limbs; mul_accum: per
// output polynomial, limb and coefficient, looping over the terms), a warp
// on 32 neighbouring coefficients so every int64 load and store is one
// coalesced 256 B access, the basis tables in shared memory (read as
// broadcasts: every lane of a warp reads the same word), and, in the
// contraction, the output polynomials on the fastest grid axis so the
// blocks that share a broadcast operand (a key over the parties) run
// together and find it in L2. A digit of more than 8 limbs (BFV's 28)
// would make that thread a long chain of products: basis_wide spreads its
// output limbs over threads instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLimbs = 64;   // alpha (digit width) and Ld, at most
constexpr int kFold = 32;       // contraction terms between two folds

__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t q) {
  return a >= q ? a - q : a;
}

// t * 2^-32 mod q, canonical, for t < q * 2^32 (Montgomery REDC).
__device__ __forceinline__ uint32_t redc(uint64_t t, uint32_t q,
                                         uint32_t qinv_neg) {
  const uint32_t m = static_cast<uint32_t>(t) * qinv_neg;
  return csub(static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32),
              q);
}

// a mod q, canonical, for any u32 a (Barrett with bar = floor(2^32 / q):
// the quotient estimate is at most 2 short).
__device__ __forceinline__ uint32_t barrett(uint32_t a, uint32_t q,
                                            uint32_t bar) {
  return csub(csub(a - __umulhi(a, bar) * q, q), q);
}

// acc * 2^-32 mod q, canonical, for any u64 acc = hi * 2^32 + lo:
// hi mod q plus REDC(lo) (<= q), one conditional subtraction.
__device__ __forceinline__ uint32_t mont_wide(uint64_t acc, uint32_t q,
                                              uint32_t qinv_neg,
                                              uint32_t bar) {
  const uint32_t lo = static_cast<uint32_t>(acc);
  const uint32_t m = lo * qinv_neg;
  const uint32_t t = static_cast<uint32_t>(
      (static_cast<uint64_t>(lo) + static_cast<uint64_t>(m) * q) >> 32);
  return csub(barrett(static_cast<uint32_t>(acc >> 32), q, bar) + t, q);
}

// The same residue class as acc, below q * 2^32 <= 2^61: hi reduced mod q.
__device__ __forceinline__ uint64_t fold(uint64_t acc, uint32_t q,
                                         uint32_t bar) {
  return (static_cast<uint64_t>(barrett(static_cast<uint32_t>(acc >> 32), q,
                                        bar))
          << 32) | static_cast<uint32_t>(acc);
}

// Table words (ops/basis_cuda.py::pack_table), u32:
//   dst[4 j ..]:  d_j, -d_j^-1 mod 2^32, floor(2^32 / d_j), P^-1 mod d_j in
//                 Montgomery form (ModDown; 0 otherwise), for j < ld;
//   then digit k at 4 ld + k * ds, ds = 4 alpha + alpha ld + ld (alpha + 1):
//     src[4 i ..]: b_i, -b_i^-1 mod 2^32, (B_k / b_i)^-1 mod b_i (Montgomery),
//                  float32 bits of 1 / b_i, for i < alpha;
//     qhat[i ld + j]: B_k / b_i mod d_j (Montgomery);
//     vq[j (alpha + 1) + v]: v B_k mod d_j, v = 0 .. alpha.
// B_k is the product of digit k's limbs; the last digit may hold fewer than
// alpha (its unused words are 0).
struct BasisArgs {
  const int64_t* x;    // (P, >= ls limbs, N): strides sxp, sxl
  const int64_t* xq;   // ModDown: (P, ld, N): strides sqp, sql
  int64_t* out;        // (P, beta, ld, N) contiguous
  const uint32_t* table;
  int64_t sxp, sxl, sqp, sql;
  int ls, alpha, beta, ld, n, nblk;
};

// The wide digit: more than 8 limbs (kMax >= kWideMin; BFV's 28-limb
// Q <-> QMul conversions and its ModDown by QMul). One thread a coefficient
// would give only P N threads, each a chain of Ls x Ld dependent wide
// products over as many shared loads: latency, not bytes, would bound it.
// So a block owns kWideCoeffs coefficients of one polynomial and digit, in
// three phases split by barriers:
//   1. y_i = x_i (B/b_i)^-1 mod b_i for every (limb i, coefficient), spread
//      over the block's threads (a warp reads 32 neighbouring coefficients
//      of one limb), into ys[i][c] in shared memory;
//   2. v = floor(sum_i fl32(y_i) / b_i), one thread a coefficient, added
//      left to right (__fmul_rn / __fadd_rn, as the narrow body), into vs;
//   3. a warp per (group g of kWideGroup output limbs, 32 coefficients):
//      kWideGroup independent u64 sums over i of y_i (a conflict-free
//      load, lane = coefficient) times qhat[i][g's limbs] (two 16-byte
//      broadcast loads: qh rows hold each group in kWideStride words), then
//      mont_wide, the vq correction and, with kDown, the (xq - conv) P^-1
//      epilogue, stored int64 (32 neighbouring coefficients a store).
// Sums of at most 64 products of residues below 2^29 stay below 2^64.
constexpr int kWideMin = 16;     // kMax of the wide body
constexpr int kWideGroup = 7;    // output limbs a thread (BFV's 28 = 4 x 7)
constexpr int kWideStride = 8;   // words a group takes in a qh row
constexpr int kWideCoeffs = 64;  // coefficients a block

// Shared words of the wide body: dst (4 ld), src (4 alpha), qh (alpha rows
// of groups x kWideStride), vq (ld (alpha + 1)), ys (alpha x kWideCoeffs),
// vs (kWideCoeffs).
__host__ __device__ inline int wide_groups(int ld) {
  return (ld + kWideGroup - 1) / kWideGroup;
}

__host__ __device__ inline int wide_words(int alpha, int ld) {
  return 4 * ld + 4 * alpha + alpha * wide_groups(ld) * kWideStride +
         ld * (alpha + 1) + (alpha + 1) * kWideCoeffs;
}

template <int kMax, bool kDown>
__device__ __forceinline__ void basis_wide(const BasisArgs& a, uint32_t* sm) {
  const int k = blockIdx.y;
  const int64_t p = blockIdx.x / a.nblk;
  const int c0 = (blockIdx.x % a.nblk) * kWideCoeffs;
  const int ld = a.ld, alpha = a.alpha;
  const int lo = k * alpha;
  const int lsd = min(alpha, a.ls - lo);
  const int gs = wide_groups(ld) * kWideStride;
  uint32_t* dst = sm;
  uint32_t* src = dst + 4 * ld;
  uint32_t* qh = src + 4 * alpha;
  uint32_t* vq = qh + alpha * gs;
  uint32_t* ys = vq + ld * (alpha + 1);
  int* vs = reinterpret_cast<int*>(ys + alpha * kWideCoeffs);
  const uint32_t* tab = a.table + 4 * ld + k * (4 * alpha + alpha * ld +
                                                ld * (alpha + 1));
  for (int w = threadIdx.x; w < 4 * ld + 4 * alpha; w += kThreads)
    dst[w] = w < 4 * ld ? a.table[w] : tab[w - 4 * ld];
  for (int w = threadIdx.x; w < alpha * gs; w += kThreads) {
    const int i = w / gs, t = w % kWideStride;
    const int j = (w % gs) / kWideStride * kWideGroup + t;
    qh[w] = t < kWideGroup && j < ld ? tab[4 * alpha + i * ld + j] : 0;
  }
  for (int w = threadIdx.x; w < ld * (alpha + 1); w += kThreads)
    vq[w] = tab[4 * alpha + alpha * ld + w];

  // 1. the y_i: every load of the thread in flight before the first REDC
  constexpr int kRounds = kMax * kWideCoeffs / kThreads;
  uint32_t xv[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int w = r * kThreads + threadIdx.x;
    const int i = w / kWideCoeffs, c = c0 + w % kWideCoeffs;
    xv[r] = i < lsd && c < a.n ? static_cast<uint32_t>(
        a.x[p * a.sxp + (lo + i) * a.sxl + c]) : 0;
  }
  __syncthreads();   // the tables
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int w = r * kThreads + threadIdx.x;
    const int i = w / kWideCoeffs;
    if (i < lsd)
      ys[w] = redc(static_cast<uint64_t>(xv[r]) * src[4 * i + 2], src[4 * i],
                   src[4 * i + 1]);
  }
  __syncthreads();

  // 2. v, left to right
  if (threadIdx.x < kWideCoeffs) {
    float vf = 0.0f;
    for (int i = 0; i < lsd; ++i)
      vf = __fadd_rn(vf, __fmul_rn(
          __uint2float_rn(ys[i * kWideCoeffs + threadIdx.x]),
          __uint_as_float(src[4 * i + 3])));
    vs[threadIdx.x] = min(max(static_cast<int>(floorf(vf)), 0), lsd);
  }
  __syncthreads();

  // 3. a warp per (group, 32 coefficients)
  constexpr int kChunks = kWideCoeffs / 32;
  const int lane = threadIdx.x % 32;
  for (int item = threadIdx.x / 32; item < wide_groups(ld) * kChunks;
       item += kThreads / 32) {
    const int g = item / kChunks;
    const int cc = item % kChunks * 32 + lane;
    const uint32_t* row = qh + g * kWideStride;
    uint64_t acc[kWideGroup] = {};
#pragma unroll 4
    for (int i = 0; i < lsd; ++i) {
      const uint32_t y = ys[i * kWideCoeffs + cc];
      const uint4 q0 = *reinterpret_cast<const uint4*>(row + i * gs);
      const uint4 q1 = *reinterpret_cast<const uint4*>(row + i * gs + 4);
      const uint32_t qs[kWideGroup] = {q0.x, q0.y, q0.z, q0.w,
                                       q1.x, q1.y, q1.z};
#pragma unroll
      for (int t = 0; t < kWideGroup; ++t)
        acc[t] += static_cast<uint64_t>(y) * qs[t];
    }
    const int c = c0 + cc;
    if (c >= a.n) continue;
    const int v = vs[cc];
    int64_t* out = a.out + ((p * a.beta + k) * ld) * a.n + c;
#pragma unroll
    for (int t = 0; t < kWideGroup; ++t) {
      const int j = g * kWideGroup + t;
      if (j >= ld) break;
      const uint32_t q = dst[4 * j], qn = dst[4 * j + 1];
      const uint32_t bar = dst[4 * j + 2];
      uint32_t r = mont_wide(acc[t], q, qn, bar);
      r = csub(r + q - vq[j * (alpha + 1) + v], q);
      if (kDown) {
        const uint32_t xj = barrett(
            static_cast<uint32_t>(a.xq[p * a.sqp + j * a.sql + c]), q, bar);
        r = redc(static_cast<uint64_t>(csub(xj + q - r, q)) * dst[4 * j + 3],
                 q, qn);
      }
      out[static_cast<int64_t>(j) * a.n] = r;
    }
  }
}

// One thread per (polynomial p, digit k, coefficient c): y_i = x_i (B/b_i)^-1
// mod b_i over the digit's limbs, v = floor(sum fl32(y_i) / b_i) in [0, lsd],
// then for each output limb j: (sum_i y_i (B/b_i mod d_j) - v B) mod d_j;
// with kDown, out_j = (xq_j - that) P^-1 mod d_j. kMax >= the digit width.
// From kMax = kWideMin on, the wide body instead (basis_wide).
template <int kMax, bool kDown>
__global__ void __launch_bounds__(kThreads)
basis_kernel(const BasisArgs a) {
  extern __shared__ uint32_t sm[];
  if constexpr (kMax >= kWideMin) {
    basis_wide<kMax, kDown>(a, sm);
    return;
  }
  const int k = blockIdx.y;
  const int64_t p = blockIdx.x / a.nblk;
  const int c = (blockIdx.x % a.nblk) * kThreads + threadIdx.x;
  const int ds = 4 * a.alpha + a.alpha * a.ld + a.ld * (a.alpha + 1);
  const int dst_words = 4 * a.ld;
  const uint32_t* tab = a.table + dst_words + k * ds;
  for (int w = threadIdx.x; w < dst_words + ds; w += kThreads)
    sm[w] = w < dst_words ? a.table[w] : tab[w - dst_words];
  __syncthreads();
  if (c >= a.n) return;
  const uint32_t* dst = sm;
  const uint32_t* src = sm + dst_words;
  const uint32_t* qhat = src + 4 * a.alpha;
  const uint32_t* vq = qhat + a.alpha * a.ld;
  const int lo = k * a.alpha;
  const int lsd = min(a.alpha, a.ls - lo);

  uint32_t y[kMax];
  float vf = 0.0f;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    y[i] = 0;
    if (i < lsd) {
      const uint32_t xi = static_cast<uint32_t>(
          a.x[p * a.sxp + (lo + i) * a.sxl + c]);
      y[i] = redc(static_cast<uint64_t>(xi) * src[4 * i + 2], src[4 * i],
                  src[4 * i + 1]);
      vf = __fadd_rn(vf, __fmul_rn(__uint2float_rn(y[i]),
                                   __uint_as_float(src[4 * i + 3])));
    }
  }
  const int v = min(max(static_cast<int>(floorf(vf)), 0), lsd);

  int64_t* out = a.out + ((p * a.beta + k) * a.ld) * a.n + c;
  for (int j = 0; j < a.ld; ++j) {
    uint64_t acc = 0;
#pragma unroll
    for (int i = 0; i < kMax; ++i)
      if (i < lsd) acc += static_cast<uint64_t>(y[i]) * qhat[i * a.ld + j];
    const uint32_t q = dst[4 * j], qn = dst[4 * j + 1], bar = dst[4 * j + 2];
    uint32_t r = mont_wide(acc, q, qn, bar);
    r = csub(r + q - vq[j * (a.alpha + 1) + v], q);
    if (kDown) {
      const uint32_t xj = barrett(
          static_cast<uint32_t>(a.xq[p * a.sqp + j * a.sql + c]), q, bar);
      r = redc(static_cast<uint64_t>(csub(xj + q - r, q)) * dst[4 * j + 3], q,
               qn);
    }
    out[static_cast<int64_t>(j) * a.n] = r;
  }
}

template <int kMax, bool kDown>
int launch_basis(const BasisArgs& a, int64_t n_polys, void* stream) {
  if constexpr (kMax >= kWideMin) {   // kWideCoeffs coefficients a block
    BasisArgs w = a;
    w.nblk = (a.n + kWideCoeffs - 1) / kWideCoeffs;
    if (n_polys * w.nblk > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(sizeof(uint32_t)) *
                     wide_words(a.alpha, a.ld);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          basis_kernel<kMax, kDown>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>(n_polys * w.nblk), a.beta);
    basis_kernel<kMax, kDown><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(w);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(sizeof(uint32_t)) *
                   (4 * a.ld + 4 * a.alpha + a.alpha * a.ld +
                    a.ld * (a.alpha + 1));
  const dim3 grid(static_cast<unsigned>(n_polys * a.nblk), a.beta);
  basis_kernel<kMax, kDown><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDown>
int dispatch_basis(const BasisArgs& a, int64_t n_polys, void* stream) {
  if (a.alpha <= 2) return launch_basis<2, kDown>(a, n_polys, stream);
  if (a.alpha <= 4) return launch_basis<4, kDown>(a, n_polys, stream);
  if (a.alpha <= 8) return launch_basis<8, kDown>(a, n_polys, stream);
  if (a.alpha <= 16) return launch_basis<16, kDown>(a, n_polys, stream);
  if (a.alpha <= 32) return launch_basis<32, kDown>(a, n_polys, stream);
  return launch_basis<64, kDown>(a, n_polys, stream);
}

// The contraction out[o, l, c] = (sum_t a[t, o, l, c] b[t, o, l, c]) 2^-32
// mod q_l over two term axes (t0, t1) and three outer axes (o0, o1, o2),
// each operand with its own element strides (0: broadcast), N contiguous.
struct Contraction {
  int64_t nt[2], no[3];
  int64_t at[2], bt[2], ao[3], bo[3], al, bl;
};

// One thread per (o, l, c); blockIdx.x = o (fastest), y = coefficient
// block, z = limb. Operands canonical (< q < 2^29): a product is < 2^58,
// kFold of them on a folded sum (< 2^61) stay below 2^64.
__global__ void __launch_bounds__(kThreads)
mul_accum_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                 int64_t* __restrict__ out, const uint32_t* __restrict__ mods,
                 const Contraction s, int L, int n) {
  const int64_t o = blockIdx.x;
  const int l = blockIdx.z;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= n) return;
  const int64_t o2 = o % s.no[2], o01 = o / s.no[2];
  const int64_t o1 = o01 % s.no[1], o0 = o01 / s.no[1];
  const int64_t* pa = a + o0 * s.ao[0] + o1 * s.ao[1] + o2 * s.ao[2] +
                      l * s.al + c;
  const int64_t* pb = b + o0 * s.bo[0] + o1 * s.bo[1] + o2 * s.bo[2] +
                      l * s.bl + c;
  const uint32_t q = mods[4 * l], qn = mods[4 * l + 1], bar = mods[4 * l + 2];
  uint64_t acc = 0;
  int since = 0;
  for (int64_t t0 = 0; t0 < s.nt[0]; ++t0) {
    const int64_t* ra = pa + t0 * s.at[0];
    const int64_t* rb = pb + t0 * s.bt[0];
#pragma unroll 4
    for (int64_t t1 = 0; t1 < s.nt[1]; ++t1) {
      acc += static_cast<uint64_t>(static_cast<uint32_t>(ra[t1 * s.at[1]])) *
             static_cast<uint32_t>(rb[t1 * s.bt[1]]);
      if (++since == kFold) {
        acc = fold(acc, q, bar);
        since = 0;
      }
    }
  }
  out[(o * L + l) * n + c] = mont_wide(acc, q, qn, bar);
}

// The CKKS rescale: Lattigo's DivRoundByLastModulusMany, which XLA fuses
// into one loop from mkhe_tpu/ops/basis.py's div_round_by_last_moduli. For
// s = 0 .. nb-1 the top limb l = L-1-s of the current value is rounded,
// t_s = (x_l + floor(q_l / 2)) mod q_l, and every lower limb j becomes
// (x_j + floor(q_l / 2) - t_s) q_l^-1 mod q_j. Step s needs step s-1's
// result on limb L-1-s, so the chain is sequential over the dropped limbs.
//
// Bound: the bytes, one int64 read of every input limb and one int64 write
// of every output limb, (P L + P (L - nb)) N x 8 B; the arithmetic is ~12
// u32 instructions a step and output. So one thread owns a column
// (polynomial, coefficient): it loads its nb dropped limbs, runs their
// chain in registers (t_s), then streams the kept limbs, kBatch loads in
// flight, each read once, all nb steps applied, written once. A warp covers
// 32 neighbouring coefficients (coalesced 256 B accesses); the input comes
// by its polynomial and limb strides (a level-dropped view, no copy).
//
// Table words (ops/basis_cuda.py::rescale_table), u32, in shared memory:
//   limb[2 j ..]: q_j, floor(2^32 / q_j), for j < L;
//   step[3 (s L + j) ..]: q_j + floor(q_l / 2) mod q_j, q_l^-1 mod q_j and
//     its Shoup word floor(q_l^-1 2^32 / q_j), l = L-1-s, for j < l.
constexpr int kMaxDrop = 8;          // dropped limbs held in registers
constexpr int kMaxRescaleWords = 12288;   // the table in 48 KiB
constexpr int kBatch = 4;            // kept-limb loads in flight a thread

struct RescaleArgs {
  const int64_t* x;    // (P, L, N): strides sxp, sxl
  int64_t* out;        // (P, L - nb, N) contiguous
  const uint32_t* table;
  int64_t sxp, sxl;
  int L, nb, n, nblk;
};

// One step on a canonical v mod q: (v + floor(q_l / 2) - t) q_l^-1 mod q,
// t < 2^32 canonical mod q_l, w the step's three words for this q. The sum
// lies in [1, 3q) and the Shoup product of any u32 in [0, 2q).
__device__ __forceinline__ uint32_t rescale_step(uint32_t v, uint32_t t,
                                                 uint32_t q, uint32_t bar,
                                                 const uint32_t* w) {
  const uint32_t a = v + w[0] - barrett(t, q, bar);
  return csub(a * w[1] - __umulhi(a, w[2]) * q, q);
}

template <int kMax>
__global__ void __launch_bounds__(kThreads)
rescale_kernel(const RescaleArgs a) {
  extern __shared__ uint32_t sm[];
  const int L = a.L, nb = a.nb, kept = a.L - a.nb;
  for (int w = threadIdx.x; w < (2 + 3 * nb) * L; w += kThreads)
    sm[w] = a.table[w];
  __syncthreads();
  const int64_t p = blockIdx.x / a.nblk;
  const int c = (blockIdx.x % a.nblk) * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const uint32_t* limb = sm;
  const uint32_t* step = sm + 2 * L;
  const int64_t* x = a.x + p * a.sxp + c;

  // d[s]: dropped limb L-1-s, brought up to step s; t[s]: its rounding.
  uint32_t d[kMax], t[kMax];
#pragma unroll
  for (int s = 0; s < kMax; ++s)
    d[s] = s < nb ? static_cast<uint32_t>(x[(L - 1 - s) * a.sxl]) : 0;
#pragma unroll
  for (int s = 0; s < kMax; ++s) {
    t[s] = 0;
    if (s < nb) {
      const uint32_t ql = limb[2 * (L - 1 - s)];
      t[s] = csub(d[s] + (ql >> 1), ql);
#pragma unroll
      for (int r = s + 1; r < kMax; ++r) {
        const int j = L - 1 - r;
        if (r < nb)
          d[r] = rescale_step(d[r], t[s], limb[2 * j], limb[2 * j + 1],
                              step + 3 * (s * L + j));
      }
    }
  }

  int64_t* out = a.out + p * kept * a.n + c;
  for (int j0 = 0; j0 < kept; j0 += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      v[b] = j0 + b < kept ? static_cast<uint32_t>(x[(j0 + b) * a.sxl]) : 0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b;
      if (j < kept) {
        const uint32_t q = limb[2 * j], bar = limb[2 * j + 1];
#pragma unroll
        for (int s = 0; s < kMax; ++s)
          if (s < nb)
            v[b] = rescale_step(v[b], t[s], q, bar, step + 3 * (s * L + j));
        out[static_cast<int64_t>(j) * a.n] = v[b];
      }
    }
  }
}

template <int kMax>
int launch_rescale(const RescaleArgs& a, int64_t n_polys, void* stream) {
  const int smem = static_cast<int>(sizeof(uint32_t)) * (2 + 3 * a.nb) * a.L;
  rescale_kernel<kMax><<<static_cast<unsigned>(n_polys * a.nblk), kThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The KKLSS tensor terms of two NTT-domain ciphertexts (mkrlwe/keyswitch.py
// ::_tensor_ntt): out_0 = nt0_0 nt1_0 and, for each party j of the union,
// out_j = nt0_0 nt1_r1(j) + nt0_r0(j) nt1_0 mod q, a term left out where the
// party is absent from that operand (its row -1).
//
// It replaces no TPU kernel: in the JAX package XLA fuses the jnp tensor
// terms (mkhe_tpu/mkrlwe/keyswitch.py:274-289, :376-389; to_mont, mul_mont
// and add over the parties) into the jitted mult. The port ran them as ~60
// int64 torch launches a 4-party mult; this is them in one pass.
//
// Bound: the bytes. Each coefficient reads the 1 + k0 rows of nt0 and the
// 1 + k1 rows of nt1 once and writes the 1 + k outputs once, int64: 110 MB
// at 4 parties over 28 limbs of 2^15 (0.033 ms at 3.35 TB/s), 220 MB over
// BFV's 56 (0.066 ms), for two wide products and one reduction an output.
// So one thread owns a pair of neighbouring coefficients (16-byte loads and
// stores, a warp on 512 contiguous bytes of a row), keeps row 0 of both
// operands in registers for all 1 + k outputs and reads every party row
// once. Each output is one u64 sum of at most two products of canonical
// residues (< 2^59, q < 2^29), reduced once exactly: its Montgomery residue
// acc 2^-32 (mont_wide), times 2^64 mod q through one more REDC, gives acc
// mod q, the canonical residue the torch chain gives (unique, so bit for
// bit). The row map rides in the launch's parameters (__grid_constant__,
// read from the constant bank): no host-to-device copy, so a launch is
// captured into a CUDA graph as it is.
constexpr int kTensorOut = 32;   // outputs a launch's row map holds

struct TensorArgs {
  const int64_t* nt0;   // (rows0, PL, N) contiguous
  const int64_t* nt1;   // (rows1, PL, N) contiguous
  int64_t* out;         // (nout, PL, N) contiguous
  const uint32_t* mods;   // (L, 4) words (basis_cuda.limb_tables)
  int64_t m;            // PL N, the elements of a row
  int L, n, nblk, nout;
  int r0[kTensorOut], r1[kTensorOut];   // rows of nt0 / nt1; -1: no term
};

__device__ __forceinline__ uint64_t lo32(int64_t v) {
  return static_cast<uint32_t>(v);
}

// acc mod q, canonical, for any u64 acc: mont_wide's acc 2^-32 mod q,
// times 2^64 mod q, REDC'd (the product is below q^2 < q 2^32).
__device__ __forceinline__ uint32_t mod_wide(uint64_t acc, uint32_t q,
                                             uint32_t qn, uint32_t bar,
                                             uint32_t r2) {
  return redc(static_cast<uint64_t>(mont_wide(acc, q, qn, bar)) * r2, q, qn);
}

// One thread per (polynomial-limb row pl of the flattened [B,] L axes,
// coefficient pair c); blockIdx.x = pl * nblk + coefficient block.
__global__ void __launch_bounds__(kThreads)
tensor_kernel(const __grid_constant__ TensorArgs a) {
  const int64_t pl = blockIdx.x / a.nblk;
  const int c = ((blockIdx.x % a.nblk) * kThreads + threadIdx.x) * 2;
  if (c >= a.n) return;
  const int l = static_cast<int>(pl % a.L);
  const uint32_t q = a.mods[4 * l], qn = a.mods[4 * l + 1];
  const uint32_t bar = a.mods[4 * l + 2], r2 = a.mods[4 * l + 3];
  const int64_t e = pl * a.n + c;
  const longlong2 x0 = *reinterpret_cast<const longlong2*>(a.nt0 + e);
  const longlong2 y0 = *reinterpret_cast<const longlong2*>(a.nt1 + e);
  for (int j = 0; j < a.nout; ++j) {
    const int r0 = a.r0[j], r1 = a.r1[j];
    uint64_t s_lo = 0, s_hi = 0;
    if (r1 >= 0) {
      const longlong2 y = r1 == 0 ? y0
          : *reinterpret_cast<const longlong2*>(a.nt1 + r1 * a.m + e);
      s_lo = lo32(x0.x) * lo32(y.x);
      s_hi = lo32(x0.y) * lo32(y.y);
    }
    if (r0 >= 0) {   // a party row (out_0 takes nt1's row 0 alone)
      const longlong2 x =
          *reinterpret_cast<const longlong2*>(a.nt0 + r0 * a.m + e);
      s_lo += lo32(x.x) * lo32(y0.x);
      s_hi += lo32(x.y) * lo32(y0.y);
    }
    longlong2 o;
    o.x = mod_wide(s_lo, q, qn, bar, r2);
    o.y = mod_wide(s_hi, q, qn, bar, r2);
    *reinterpret_cast<longlong2*>(a.out + j * a.m + e) = o;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes, ops/basis_cuda.py). Every pointer
// is device memory; stream is a cudaStream_t. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernels do
// not take (the wrapper checks them first).

// mod_up / decompose (down = 0) and ModDown (down = 1): x (n_polys, ls, N)
// by its strides; xq (n_polys, ld, N) by its strides (ModDown, else null);
// out (n_polys, beta, ld, N) contiguous; table as above.
extern "C" int mkhe_basis(const void* x, long long sxp, long long sxl,
                          const void* xq, long long sqp, long long sql,
                          void* out, const void* table, long long n_polys,
                          int ls, int alpha, int beta, int ld, int n,
                          int down, void* stream) {
  const int nblk = (n + kThreads - 1) / kThreads;
  if (n_polys < 1 || n < 1 || ls < 1 || alpha < 1 || alpha > kMaxLimbs ||
      ld < 1 || ld > kMaxLimbs || beta < 1 || beta > 65535 ||
      (beta - 1) * alpha >= ls || n_polys * nblk > 0x7fffffffLL ||
      (down && (beta != 1 || xq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BasisArgs a{static_cast<const int64_t*>(x),
                    static_cast<const int64_t*>(xq),
                    static_cast<int64_t*>(out),
                    static_cast<const uint32_t*>(table),
                    sxp, sxl, sqp, sql, ls, alpha, beta, ld, n, nblk};
  return down ? dispatch_basis<true>(a, n_polys, stream)
              : dispatch_basis<false>(a, n_polys, stream);
}

// dims: nt0, nt1, no0, no1, no2, then a's strides at0, at1, ao0, ao1, ao2,
// al, then b's bt0, bt1, bo0, bo1, bo2, bl; out (no0 no1 no2, L, N)
// contiguous; mods (L, 4) u32: q, -q^-1 mod 2^32, floor(2^32 / q) and
// 2^64 mod q (read by the tensor kernel only).
extern "C" int mkhe_mul_accum(const void* a, const void* b, void* out,
                              const void* mods, const long long* dims,
                              int L, int n, void* stream) {
  Contraction s;
  s.nt[0] = dims[0];
  s.nt[1] = dims[1];
  for (int i = 0; i < 3; ++i) s.no[i] = dims[2 + i];
  for (int i = 0; i < 2; ++i) {
    s.at[i] = dims[5 + i];
    s.bt[i] = dims[11 + i];
  }
  for (int i = 0; i < 3; ++i) {
    s.ao[i] = dims[7 + i];
    s.bo[i] = dims[13 + i];
  }
  s.al = dims[10];
  s.bl = dims[16];
  const int64_t n_out = s.no[0] * s.no[1] * s.no[2];
  const int nblk = (n + kThreads - 1) / kThreads;
  if (n < 1 || L < 1 || L > 65535 || nblk > 65535 || n_out < 1 ||
      n_out > 0x7fffffffLL || s.nt[0] < 1 || s.nt[1] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_out), nblk, L);
  mul_accum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(mods), s, L,
      n);
  return static_cast<int>(cudaGetLastError());
}

// The rescale: x (n_polys, L, N) by its strides -> out (n_polys, L - nb, N)
// contiguous; table as above (rescale_kernel), (2 + 3 nb) L words.
extern "C" int mkhe_rescale(const void* x, long long sxp, long long sxl,
                            void* out, const void* table, long long n_polys,
                            int L, int nb, int n, void* stream) {
  const int nblk = (n + kThreads - 1) / kThreads;
  if (n_polys < 1 || n < 1 || nb < 1 || nb > kMaxDrop || L <= nb ||
      (2 + 3 * nb) * static_cast<long long>(L) > kMaxRescaleWords ||
      n_polys * nblk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const RescaleArgs a{static_cast<const int64_t*>(x),
                      static_cast<int64_t*>(out),
                      static_cast<const uint32_t*>(table), sxp, sxl, L, nb,
                      n, nblk};
  if (nb <= 1) return launch_rescale<1>(a, n_polys, stream);
  if (nb <= 2) return launch_rescale<2>(a, n_polys, stream);
  if (nb <= 4) return launch_rescale<4>(a, n_polys, stream);
  return launch_rescale<8>(a, n_polys, stream);
}

// The tensor terms: nt0 (rows0, n_pl, N), nt1 (rows1, n_pl, N) and out
// (nout, n_pl, N) contiguous and 16-byte aligned, N even; mods (L, 4) u32
// as above, limb l of row pl is pl mod L; rows: nout pairs (r0, r1).
// Outputs beyond one launch's row map take further launches, kTensorOut
// outputs each.
extern "C" int mkhe_tensor(const void* nt0, const void* nt1, void* out,
                           const void* mods, const int* rows, int nout,
                           long long n_pl, int L, int n, void* stream) {
  const int nblk = (n / 2 + kThreads - 1) / kThreads;
  if (nout < 1 || n_pl < 1 || L < 1 || n_pl % L || n < 2 || n % 2 ||
      n_pl * nblk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  TensorArgs a{static_cast<const int64_t*>(nt0),
               static_cast<const int64_t*>(nt1),
               nullptr, static_cast<const uint32_t*>(mods),
               n_pl * n, L, n, nblk, 0, {}, {}};
  for (int j0 = 0; j0 < nout; j0 += kTensorOut) {
    a.out = static_cast<int64_t*>(out) + j0 * a.m;
    a.nout = nout - j0 < kTensorOut ? nout - j0 : kTensorOut;
    for (int j = 0; j < a.nout; ++j) {
      a.r0[j] = rows[2 * (j0 + j)];
      a.r1[j] = rows[2 * (j0 + j) + 1];
      if (a.r0[j] < -1 || a.r1[j] < -1 || (a.r0[j] < 0 && a.r1[j] < 0))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    tensor_kernel<<<static_cast<unsigned>(n_pl * nblk), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
