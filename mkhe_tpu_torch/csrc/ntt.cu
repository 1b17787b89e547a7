// Forward and inverse negacyclic NTT for Hopper (sm_90a).
//
// Replaces the TPU kernels mkhe_tpu/ops/ntt_pallas.py::_fwd_kernel (:126,
// body _fwd_stages :47-123) and ::_inv_kernel (:138-225). Computes what
// they compute, which is what the JAX package's jnp path computes
// (mkhe_tpu/ops/ring.py:377-440):
//   forward: merged-twist Cooley-Tukey with the psi table, standard order
//            in, bit-reversed order out;
//   inverse: Gentleman-Sande with the ipsi table and a final multiply by
//            N^-1, bit-reversed order in, standard order out.
// Both take any u32 input (so the inverse takes the lazy < 8q inputs of the
// key-switch pipeline) and give canonical output, equal bit for bit to the
// plain PyTorch versions in ops/ntt_cuda.py: the transform is fixed mod q
// and a canonical residue is unique, so lazy intermediates cannot change it.
//
// Layout: data (n_polys, N) int64 holding u32 values, polynomial p on limb
// p % L; the packed twiddle table (L, N) int64 holds w | w_shoup << 32
// (ops/ring.py psi_pack / ipsi_pack); constants (L,) int64.
//
// What bounds it on an H100. At N = 2^15 a polynomial moves 512 KiB of
// int64 through HBM (256 KiB in, 256 KiB out) for 15 x 2^14 butterflies of
// ~7 integer instructions each: at 3.35 TB/s against 132 SMs x 64 INT32
// lanes the bytes bound it, by a small margin. What holds it back in
// practice (PERF.md): one 132 KiB block fills an SM at logN 15, so
// a block's passes overlap HBM only where its warps run out of step, and
// each stage waits on its twiddles' L2 latency, which 64 registers a
// thread cannot prefetch.
//
// Design (launch geometry in ops/ntt_cuda.py::geometry, checked here):
// - Register radix passes. A thread holds 32 coefficients and runs up to 5
//   stages on them in registers, so logN = 15 takes 3 passes (5 + 5 + 5)
//   and 2 block barriers instead of 15 stages with a barrier each. Every
//   loop bound is a compile-time constant (templates on the pass width
//   and the stage), so the 32 values never leave registers. The passes are
//   5 stages each and a last one with the rest (pass_bits); the forward
//   kernel runs them from the top bit down, the inverse from bit 0 up. A
//   thread with fewer than 5 bits in a pass holds several groups and runs
//   them one after another (`dep`).
// - Between passes the polynomial lives in shared memory, padded by one
//   word per 32 (index i at i + i / 32): with threads numbered g-major
//   (value_index) every pass's accesses are conflict-free
//   (tests/test_torch_ntt.py checks the banks of every warp), and a
//   register's address is a constant offset from its group's base.
// - HBM inside the passes, so that one warp's loads overlap another's
//   butterflies and no block barrier waits for all of HBM. The pass at
//   bit 0 (the inverse's first, the forward's last) gives each warp 32
//   neighbouring groups: the warp stages them through its own part of
//   shared memory with 16-byte accesses, neighbouring lanes on
//   neighbouring pairs, behind a __syncwarp. The forward's first pass and
//   the inverse's last read or write their values straight from or to
//   HBM, neighbouring threads on neighbouring words. The reads reduce by
//   Barrett on the way in.
// - Packed twiddles: one 8-byte load per twiddle (16 for a pair), each
//   loaded once per pass. The passes away from bit 0 read twiddles that a
//   whole warp shares; the pass at bit 0 reads N/2 + N/4 + ... distinct
//   ones, so the table stores them in the order that pass reads them
//   (ntt_cuda.twiddle_order): neighbouring threads read neighbouring words.
// - Harvey's lazy butterflies: values stay in [0, 4q) (forward) or [0, 2q)
//   (inverse), with one conditional subtraction per butterfly written as an
//   unsigned min, and are made canonical once, in the last pass. The
//   launcher refuses q >= 2^30, so 4q < 2^32.
// - More than one polynomial in flight per SM: a block holds 2^log_polys
//   polynomials (several below logN 13); at logN 14 a block of 512
//   threads takes 66 KiB and two share an SM; at logN 15 a block of 1024
//   threads and 132 KiB owns one. Splitting a polynomial over a 2-CTA
//   cluster (distributed shared memory, two polynomials per SM) measured
//   slower (PERF.md) and is not kept.
// No tensor cores: a 32-bit modular butterfly has no wgmma form.
//
// decompose_ntt_kernel: the gadget decomposition and the forward NTT of its
// digits in one launch (ops/basis.py::decompose_ntt). It replaces
// csrc/keyswitch.cu's basis_kernel<.., false> followed by ntt_kernel<true>,
// whose (P, beta, Ld, N) digit tensor had no other reader: the basis
// kernel wrote it to HBM and the NTT's first pass read it back, 2 x 1.41 GB
// in a 4-party PN15QP880 mult. Here the forward kernel's first pass computes
// each value it would have read: polynomial (p, k, j) of the output (digit
// k of party polynomial p on output limb j, j fastest, so the Ld blocks of
// one digit read the same <= 2 source limbs and find them in L2) takes
// the basis kernel's residue for its coefficients (`digit_values`: the
// words of ops/basis_cuda.py::pack_table, the same float32 v added left to
// right), writes it to the thread's own slots in shared memory and runs
// the pass from there. Every output limb goes through the formula, the
// digit's own limbs included, as in the basis kernel, so the output is bit
// for bit ring.ntt(basis_cuda.decompose(x)). What bounds it: the digits'
// int64 words written once and the source read once from HBM (the other
// Ld - 1 reads hit L2), but in practice the integer pipe: a digit value
// costs ~25 integer instructions (the v correction folded into the sum's
// one Montgomery reduction, left lazy below 3q) on top of the NTT's ~60.
// So it takes the main path's shape alone, digits of two limbs at logN 14
// or 15, with both fixed at compile time: the digit words stay in
// registers, and every pass's offsets and strides fold into the
// addresses; the first pass computes 8 values at a time, which keeps it at
// 64 registers with no spill. Every other shape keeps the basis kernel
// and ntt_kernel<true> (ops/basis.py::fuses).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogVals = 5;  // a thread holds 2^5 coefficients
constexpr int kMaxPassBits = 5;  // stages of one register pass
constexpr int kMaxThreads = (1 << 15) >> kLogVals;

constexpr int kChunk = 8;  // digit values a thread computes at once

struct Args {
  const int64_t* x;
  int64_t* out;
  const uint64_t* pack;  // (L, N): w | w_shoup << 32
  const int64_t* q;
  const int64_t* bar;
  const int64_t* ninv;     // inverse only
  const int64_t* ninv_sh;  // inverse only
  int n_polys, L, logn, log_polys;
  // decompose_ntt_kernel only: x is the source (P, >= ls limbs, N) by its
  // strides sxp, sxl (N contiguous), digits of two limbs (the last may
  // hold one), dig the digits' table words; out is (P, beta, L, N).
  const uint32_t* dig;
  int64_t sxp, sxl;
  int ls, beta;
};

// a - m if a >= m else a, for a < 2m < 2^32 (a - m wraps above a when
// a < m, so the unsigned min picks the right one).
__device__ __forceinline__ uint32_t csub(uint32_t a, uint32_t m) {
  return min(a, a - m);
}

// a * w mod q in [0, 2q) for any a < 2^32, w < q, wsh = floor(w 2^32 / q).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// Any a < 2^32 -> [0, 2q), bar = floor(2^32 / q).
__device__ __forceinline__ uint32_t barrett_lazy(uint32_t a, uint32_t q,
                                                 uint32_t bar) {
  return a - __umulhi(a, bar) * q;
}

// t 2^-32 mod q, canonical, for t < q 2^32 (Montgomery REDC; qn = -q^-1
// mod 2^32).
__device__ __forceinline__ uint32_t redc(uint64_t t, uint32_t q,
                                         uint32_t qn) {
  const uint32_t m = static_cast<uint32_t>(t) * qn;
  return csub(static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32),
              q);
}

// Cooley-Tukey: x, y in [0, 4q) -> x + w y, x - w y in [0, 4q).
__device__ __forceinline__ void ct_bfly(uint32_t& x, uint32_t& y,
                                        uint64_t w, uint32_t q,
                                        uint32_t q2) {
  const uint32_t a = csub(x, q2);
  const uint32_t t = shoup_lazy(y, static_cast<uint32_t>(w),
                                static_cast<uint32_t>(w >> 32), q);
  x = a + t;
  y = a - t + q2;
}

// Gentleman-Sande: x, y in [0, 2q) -> x + y, w (x - y) in [0, 2q).
__device__ __forceinline__ void gs_bfly(uint32_t& x, uint32_t& y,
                                        uint64_t w, uint32_t q,
                                        uint32_t q2) {
  const uint32_t s = x + y;
  const uint32_t d = x - y + q2;
  x = csub(s, q2);
  y = shoup_lazy(d, static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32),
                 q);
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// 0 for every value the kernels hold (all below 4q < 2^32 - 4), which the
// compiler cannot prove: adding it to an address makes a load wait for x
// without changing where it reads.
__device__ __forceinline__ int never(uint32_t x) {
  return x == 0xFFFFFFFFu;
}

// Index in the block's coefficient array of the value a thread keeps in
// register (g, c) during a pass over bits [lo, lo + r): the pass's bits
// come from c, every other bit from o = g * threads + thread (g-major, so
// that neighbouring threads hold neighbouring o).
__device__ __forceinline__ int value_index(int thread, int threads, int g,
                                           int c, int lo, int r) {
  const int o = g * threads + thread;
  return ((o >> lo) << (lo + r)) | (c << lo) | (o & ((1 << lo) - 1));
}

// Offset of register c's word from the padded base of its group in a pass
// over bits [lo, lo + R): padded(base | c << lo) = padded(base) + t +
// t / 32 with t = c << lo, since the bit fields do not overlap. kMode 0
// (lo = 0): c itself, a constant; 1 (lo >= 5): c * stride, stride =
// 2^lo + 2^(lo - 5); 2: the general form.
template <int kMode>
__device__ __forceinline__ int offset(int c, int lo, int stride) {
  if (kMode == 0) return c;
  if (kMode == 1) return c * stride;
  const int t = c << lo;
  return t + (t >> 5);
}

// Stage bit b = lo + J of a register pass over bits [lo, lo + R): the
// butterflies (c, c + 2^J) of the 2^R values, the ones with c >> (J + 1)
// == cc taking twiddle t[cc * step]. With step 1 the cnt twiddles are
// neighbours, read in 16-byte pairs when there are two or more; a pass at
// lo = 0 (kSpread) reads the table in its spread order (ntt_cuda.
// twiddle_order), where the twiddles of neighbouring threads are
// neighbours instead. Every bound is a compile-time constant, so the loops
// unroll and v stays in registers.
template <bool kFwd, int R, int J, bool kSpread>
__device__ __forceinline__ void stage(uint32_t (&v)[1 << R],
                                      const uint64_t* t, int step,
                                      uint32_t q, uint32_t q2) {
  constexpr int cnt = 1 << (R - 1 - J);
  ulonglong2 w2;
#pragma unroll
  for (int cc = 0; cc < cnt; ++cc) {
    uint64_t w;
    if (cnt == 1 || kSpread) {
      w = __ldg(t + cc * step);
    } else {  // cnt even and t 16-byte aligned
      if (cc % 2 == 0)
        w2 = __ldg(reinterpret_cast<const ulonglong2*>(t + cc));
      w = cc % 2 ? w2.y : w2.x;
    }
#pragma unroll
    for (int low = 0; low < (1 << J); ++low) {
      const int c0 = (cc << (J + 1)) | low;
      const int c1 = c0 | (1 << J);
      if (kFwd)
        ct_bfly(v[c0], v[c1], w, q, q2);
      else
        gs_bfly(v[c0], v[c1], w, q, q2);
    }
  }
}

// Stages S .. R - 1 of a pass (the forward from the top bit down, the
// inverse from bit lo up). The twiddles of bit b = lo + J for the group
// with high bits hi: tw[m + (hi << (R - 1 - J)) + cc], m = n >> (b + 1);
// in the spread order of a pass at lo = 0, tw[m + cc * (n >> R) + hi].
template <bool kFwd, int R, int S, bool kSpread>
__device__ __forceinline__ void stages(uint32_t (&v)[1 << R],
                                       const uint64_t* tw, int n, int hi,
                                       int lo, uint32_t q, uint32_t q2) {
  if constexpr (S < R) {
    constexpr int J = kFwd ? R - 1 - S : S;
    const uint64_t* m = tw + (n >> (lo + J + 1));
    if (kSpread)
      stage<kFwd, R, J, true>(v, m + hi, n >> R, q, q2);
    else
      stage<kFwd, R, J, false>(v, m + (hi << (R - 1 - J)), 1, q, q2);
    stages<kFwd, R, S + 1, kSpread>(v, tw, n, hi, lo, q, q2);
  }
}

// The block's polynomials in HBM: gbase is the index of their first
// coefficient, valid the number of coefficients of polynomials that exist
// (the last block may be short), limb0 the limb of the first.
struct Span {
  size_t gbase;
  int valid;
  int limb0;
};

// Limb of the block's coefficient e.
__device__ __forceinline__ int limb_of(const Args& a, const Span& sp, int e) {
  return a.log_polys ? (sp.limb0 + (e >> a.logn)) % a.L : sp.limb0;
}

// The gadget digit values of one group of a pass (decompose_ntt_kernel's
// first): the C coefficients base | c << lo of the block's polynomial (p,
// k, j), j = limb, digit k of party polynomial p on output limb j, each
// the residue csrc/keyswitch.cu::basis_kernel gives: y_i = x_i (B_k /
// b_i)^-1 mod b_i over the digit's lsd limbs (REDC, canonical), v =
// floor(fl32(y_0) fl32(1 / b_0) + fl32(y_1) fl32(1 / b_1)) in float32
// (v lies in [0, lsd]: each term is at most 1), then (sum_i y_i (B_k /
// b_i) - v B_k) mod d_j. Here that is one Montgomery reduction of sum_i
// y_i qhat_ij + v cv, qhat_ij = (B_k / b_i) 2^32 mod d_j and cv = -B_k
// 2^32 mod d_j = -b_0 qhat_0j mod d_j (one 64-bit remainder a group), left
// lazy in [0, 3q): the butterflies take values below 4q and the
// transform's canonical output is the same. Digits of kAlpha = 2 limbs
// (the last may hold one), the words in registers; written to the
// thread's own slots s[pb + offset(c)] (the pass reads them back, so no
// barrier), kChunk at a time: a chunk's loads and sums are what the
// registers hold. Table words (ops/basis_cuda.py::pack_table): 4 a dst
// limb (d_j, -d_j^-1 mod 2^32, floor(2^32 / d_j), 0), then digit k at 4 L
// + k ds: 4 a source limb (b_i, -b_i^-1 mod 2^32, (B_k / b_i)^-1 in
// Montgomery form, float32 bits of 1 / b_i), qhat_ij at 4 kAlpha + i L +
// j. A polynomial past the last reads 0.
constexpr int kAlpha = 2;

__device__ __forceinline__ uint32_t floor_v(float vf, int lsd) {
  // vf in [0, 2^23): rounding vf + 2^23 down leaves floor(vf) in the
  // mantissa
  return min(static_cast<uint32_t>(__float_as_int(__fadd_rd(vf, 8388608.0f)) -
                                   0x4B000000),
             static_cast<uint32_t>(lsd));
}

template <int kMode, int C>
__device__ __forceinline__ void digit_values(const Args& a, const Span& sp,
                                             uint32_t* s, int base, int pb,
                                             int lo, int stride, int j) {
  if (base >= sp.valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[pb + offset<kMode>(c, lo, stride)] = 0;
    return;
  }
  const int64_t pk = static_cast<int64_t>((sp.gbase + base) >> a.logn) / a.L;
  const int k = static_cast<int>(pk % a.beta);
  const int64_t p = pk / a.beta;
  const int first = k * kAlpha;
  const int lsd = min(kAlpha, a.ls - first);
  const uint32_t* src =
      a.dig + 4 * a.L + k * (4 * kAlpha + kAlpha * a.L + a.L * (kAlpha + 1));
  const uint32_t* qhat = src + 4 * kAlpha + j;
  const uint32_t q = __ldg(a.dig + 4 * j), qn = __ldg(a.dig + 4 * j + 1),
                 bar = __ldg(a.dig + 4 * j + 2);
  const uint32_t bm = static_cast<uint32_t>(
      static_cast<uint64_t>(__ldg(src)) * __ldg(qhat) % q);
  const uint32_t cv = bm ? q - bm : 0u;
  const int64_t* x = a.x + p * a.sxp + first * a.sxl +
                     (base & ((1 << a.logn) - 1));
  // a one-limb last digit reads its limb twice with a zero multiplier:
  // y_1 = 0 adds nothing to the sum or to v
  const int64_t* x1 = lsd > 1 ? x + a.sxl : x;
  const uint32_t b0 = __ldg(src), bn0 = __ldg(src + 1), w0 = __ldg(src + 2);
  const float ib0 = __uint_as_float(__ldg(src + 3));
  const uint32_t b1 = __ldg(src + 4), bn1 = __ldg(src + 5),
                 w1 = lsd > 1 ? __ldg(src + 6) : 0u;
  const float ib1 = __uint_as_float(__ldg(src + 7));
  const uint32_t h0 = __ldg(qhat), h1 = __ldg(qhat + a.L);
  constexpr int U = C < kChunk ? C : kChunk;
  static_assert(C % U == 0, "a group is whole chunks");
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += U) {
    uint32_t xa[U], xb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the int64's low word holds the value
      xa[u] = __ldg(reinterpret_cast<const unsigned int*>(
          x + ((c0 + u) << lo)));
      xb[u] = __ldg(reinterpret_cast<const unsigned int*>(
          x1 + ((c0 + u) << lo)));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t y0 = redc(static_cast<uint64_t>(xa[u]) * w0, b0, bn0);
      const uint32_t y1 = redc(static_cast<uint64_t>(xb[u]) * w1, b1, bn1);
      const float vf = __fadd_rn(__fmul_rn(__uint2float_rn(y0), ib0),
                                 __fmul_rn(__uint2float_rn(y1), ib1));
      // the sum's Montgomery reduction, lazy: [0, 2q) + [0, q]
      const uint64_t acc = static_cast<uint64_t>(y0) * h0 +
                           static_cast<uint64_t>(y1) * h1 +
                           static_cast<uint64_t>(floor_v(vf, lsd)) * cv;
      const uint32_t lw = static_cast<uint32_t>(acc);
      s[pb + offset<kMode>(c0 + u, lo, stride)] =
          barrett_lazy(static_cast<uint32_t>(acc >> 32), q, bar) +
          static_cast<uint32_t>(
              (static_cast<uint64_t>(lw) + static_cast<uint64_t>(lw * qn) * q)
              >> 32);
    }
  }
}

// One register pass of R stages over bits [lo, lo + R) of every
// polynomial in the block: each of the thread's G = 2^kLogVals / 2^R
// groups of 2^R values is read, transformed and written in turn, from and
// to shared memory unless kHbm says otherwise: bit 1 reads HBM (reducing
// by Barrett), bit 2 writes it; at lo = 0 (kMode 0) through the warp's
// own part of shared memory, else word by word; bit 4 computes the values
// as gadget digits first (digit_values). The last
// pass (kLast) makes the values canonical (and, in the inverse, multiplies
// by N^-1).
template <bool kFwd, int R, int kMode, bool kLast, int kHbm>
__device__ __forceinline__ void run_pass(const Args& a, const Span& sp,
                                         uint32_t* s, int lo) {
  constexpr int G = (1 << kLogVals) >> R;
  constexpr int C = 1 << R;
  const int n = 1 << a.logn;
  const int stride = (1 << lo) + ((1 << lo) >> 5);
  const int lane = threadIdx.x & 31;
  // `dep` is 0, but the compiler cannot know it: it ties each group's
  // loads to the previous group's results, so the groups run one after
  // another and only one group's values and twiddles are live.
  int dep = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int base = value_index(threadIdx.x, blockDim.x, g, 0, lo, R) + dep;
    // at lo = 0 the warp's 32 groups are neighbours from here on
    const int wbase = base - lane * C;
    const int limb = limb_of(a, sp, base);
    const uint32_t q = static_cast<uint32_t>(__ldg(a.q + limb));
    const uint32_t q2 = 2 * q;
    const int pb = padded(base);
    uint32_t v[C];
    if (kHbm & 4)
      digit_values<kMode, C>(a, sp, s, base, pb, lo, stride, limb);
    if ((kHbm & 1) && kMode == 0) {
#pragma unroll
      for (int k = 0; k < C / 2; ++k) {
        const int e = wbase + 2 * (lane + 32 * k);
        if (e < sp.valid) {
          const longlong2 xv =
              __ldcs(reinterpret_cast<const longlong2*>(a.x + sp.gbase + e));
          const int le = limb_of(a, sp, e);
          const uint32_t qe = static_cast<uint32_t>(__ldg(a.q + le));
          const uint32_t bar = static_cast<uint32_t>(__ldg(a.bar + le));
          s[padded(e)] = barrett_lazy(static_cast<uint32_t>(xv.x), qe, bar);
          s[padded(e + 1)] = barrett_lazy(static_cast<uint32_t>(xv.y), qe, bar);
        }
      }
      __syncwarp();
    }
    if ((kHbm & 1) && kMode != 0) {  // the int64's low word holds the value
      const uint32_t bar = static_cast<uint32_t>(__ldg(a.bar + limb));
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = base | (c << lo);
        const auto* xi =
            reinterpret_cast<const unsigned int*>(a.x + sp.gbase + i);
        v[c] = barrett_lazy(i < sp.valid ? __ldcs(xi) : 0u, q, bar);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = s[pb + offset<kMode>(c, lo, stride)];
    }
    const uint64_t* tw = a.pack + (static_cast<size_t>(limb) << a.logn);
    const int hi = (base & (n - 1)) >> (lo + R);
    stages<kFwd, R, 0, kMode == 0>(v, tw, n, hi, lo, q, q2);
    if (kLast) {
      if (kFwd) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = csub(csub(v[c], q2), q);
      } else {
        const uint32_t nv = static_cast<uint32_t>(__ldg(a.ninv + limb));
        const uint32_t nvsh = static_cast<uint32_t>(__ldg(a.ninv_sh + limb));
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[c] = csub(shoup_lazy(v[c], nv, nvsh, q), q);
      }
    }
    if ((kHbm & 2) && kMode != 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = base | (c << lo);
        if (i < sp.valid)
          __stcs(reinterpret_cast<long long*>(a.out + sp.gbase + i),
                 static_cast<long long>(v[c]));
      }
    } else {
      // an opaque copy of pb makes the compiler work the store addresses
      // out again instead of keeping the loads' live through the stages
      int spb;
      asm volatile("mov.b32 %0, %1;" : "=r"(spb) : "r"(pb));
#pragma unroll
      for (int c = 0; c < C; ++c) s[spb + offset<kMode>(c, lo, stride)] = v[c];
    }
    if ((kHbm & 2) && kMode == 0) {
      __syncwarp();
#pragma unroll
      for (int k = 0; k < C / 2; ++k) {
        const int e = wbase + 2 * (lane + 32 * k);
        if (e < sp.valid)
          __stcs(reinterpret_cast<longlong2*>(a.out + sp.gbase + e),
                 make_longlong2(s[padded(e)], s[padded(e + 1)]));
      }
    }
    dep = never(v[0]);
  }
}

// Stage bits of register pass k of npasses at logN: 5, and the rest in the
// last (ops/ntt_cuda.py::_passes, which the tests and the twiddle order
// use, is the same rule).
__device__ __forceinline__ int pass_bits(int logn, int k, int npasses) {
  return k < npasses - 1 ? kMaxPassBits : logn - kMaxPassBits * k;
}

// The block's polynomials.
__device__ __forceinline__ Span span_of(const Args& a) {
  const int size = 1 << (a.logn + a.log_polys);
  const int64_t first = static_cast<int64_t>(blockIdx.x) << a.log_polys;
  const int64_t left = (static_cast<int64_t>(a.n_polys) - first) << a.logn;
  return Span{static_cast<size_t>(first) << a.logn,
              static_cast<int>(left < size ? left : size),
              static_cast<int>(first % a.L)};
}

// The passes of pass_bits, each with the address form of its lo: the
// forward's passes at lo = logN - 5, logN - 10, ... (form 1 if lo >= 5,
// else 2) and its last at lo = 0; the inverse's first at lo = 0 and the
// others at multiples of 5. Instantiating only these keeps the build
// short.
template <bool kFwd>
__device__ __forceinline__ void first_or_middle(const Args& a,
                                                const Span& sp, uint32_t* s,
                                                int lo, bool first) {
  constexpr int R = kMaxPassBits;
  if (!kFwd && lo == 0)
    run_pass<kFwd, R, 0, false, 1>(a, sp, s, lo);
  else if (!kFwd)
    run_pass<kFwd, R, 1, false, 0>(a, sp, s, lo);
  else if (first && lo >= 5)
    run_pass<kFwd, R, 1, false, 1>(a, sp, s, lo);
  else if (first)
    run_pass<kFwd, R, 2, false, 1>(a, sp, s, lo);
  else if (lo >= 5)
    run_pass<kFwd, R, 1, false, 0>(a, sp, s, lo);
  else
    run_pass<kFwd, R, 2, false, 0>(a, sp, s, lo);
}

template <bool kFwd, int R>
__device__ __forceinline__ void last_r(const Args& a, const Span& sp,
                                       uint32_t* s, int lo, bool only) {
  if (only)
    run_pass<kFwd, R, 0, true, 3>(a, sp, s, lo);
  else if (kFwd)
    run_pass<kFwd, R, 0, true, 2>(a, sp, s, lo);
  else
    run_pass<kFwd, R, 1, true, 2>(a, sp, s, lo);
}

template <bool kFwd>
__device__ __forceinline__ void last(const Args& a, const Span& sp,
                                     uint32_t* s, int r, int lo, bool only) {
  switch (r) {
    case 1: last_r<kFwd, 1>(a, sp, s, lo, only); break;
    case 2: last_r<kFwd, 2>(a, sp, s, lo, only); break;
    case 3: last_r<kFwd, 3>(a, sp, s, lo, only); break;
    case 4: last_r<kFwd, 4>(a, sp, s, lo, only); break;
    default: last_r<kFwd, 5>(a, sp, s, lo, only); break;
  }
}

template <bool kFwd>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const Span sp = span_of(a);
  const int npasses = (a.logn + kMaxPassBits - 1) / kMaxPassBits;
  int lo = kFwd ? a.logn : 0;
  for (int k = 0; k < npasses; ++k) {
    const int r = pass_bits(a.logn, k, npasses);
    if (kFwd) lo -= r;
    if (k < npasses - 1) {
      first_or_middle<kFwd>(a, sp, smem, lo, k == 0);
      __syncthreads();
    } else {
      last<kFwd>(a, sp, smem, r, lo, npasses == 1);
    }
    if (!kFwd) lo += r;
  }
}


// The forward passes at a compile-time logN from pass K on (lo kLo before
// it), each in the address form first_or_middle and last give it: every
// lo is a constant, so the offsets and strides fold. The first computes
// its input as gadget digits of two limbs.
template <int kLogN, int K, int kLo>
__device__ __forceinline__ void fixed_passes(const Args& a, const Span& sp,
                                             uint32_t* s) {
  constexpr int kPasses = (kLogN + kMaxPassBits - 1) / kMaxPassBits;
  static_assert(kPasses > 1, "the first pass is not the last");
  if constexpr (K < kPasses - 1) {
    constexpr int lo = kLo - kMaxPassBits;
    run_pass<true, kMaxPassBits, lo >= 5 ? 1 : 2, false, K == 0 ? 4 : 0>(
        a, sp, s, lo);
    __syncthreads();
    fixed_passes<kLogN, K + 1, lo>(a, sp, s);
  } else {
    run_pass<true, kLo, 0, true, 2>(a, sp, s, 0);
  }
}

// The digits of the gadget decomposition in the NTT domain (see the
// file's note): the forward kernel with its first pass computing its
// input, for digits of two limbs at logN kLogN (14 or 15).
template <int kLogN>
__global__ void __launch_bounds__(kMaxThreads, 1)
decompose_ntt_kernel(const Args in) {
  extern __shared__ uint32_t smem[];
  Args a = in;
  a.logn = kLogN;
  fixed_passes<kLogN, 0, kLogN>(a, span_of(a), smem);
}

// The launcher's geometry against what the kernel needs.
bool geometry_ok(const Args& a, int blocks, int threads, int smem) {
  if (a.logn < 1 || a.logn > 15 || a.log_polys < 0 || a.L < 1 ||
      a.n_polys < 1)
    return false;
  const int log_s = a.logn + a.log_polys;
  if (log_s > 15 || threads << kLogVals != 1 << log_s || threads % 32)
    return false;
  const int size = 1 << log_s;
  if (smem < static_cast<int>(sizeof(uint32_t)) * (size + size / 32))
    return false;
  return (static_cast<int64_t>(blocks) << a.log_polys) >= a.n_polys &&
         (static_cast<int64_t>(blocks - 1) << a.log_polys) < a.n_polys;
}

int launch(void (*kernel)(Args), const Args& a, int blocks, int threads,
           int smem, void* stream) {
  if (!geometry_ok(a, blocks, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KiB of dynamic shared memory the launch is refused unless
  // the kernel has opted in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Every pointer is device memory;
// stream is a cudaStream_t. The launch geometry (log_polys, blocks,
// threads, smem) comes from ops/ntt_cuda.py::geometry; a geometry the
// kernel cannot run returns cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch.
extern "C" int mkhe_ntt_fwd(const void* x, void* out, const void* pack,
                            const void* q, const void* bar, int n_polys,
                            int L, int logn, int log_polys, int blocks,
                            int threads, int smem, void* stream) {
  const Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
               static_cast<const uint64_t*>(pack),
               static_cast<const int64_t*>(q),
               static_cast<const int64_t*>(bar), nullptr, nullptr,
               n_polys, L, logn, log_polys};
  return launch(ntt_kernel<true>, a, blocks, threads, smem, stream);
}

extern "C" int mkhe_ntt_inv(const void* x, void* out, const void* pack,
                            const void* q, const void* bar, const void* ninv,
                            const void* ninv_sh, int n_polys, int L, int logn,
                            int log_polys, int blocks, int threads, int smem,
                            void* stream) {
  const Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
               static_cast<const uint64_t*>(pack),
               static_cast<const int64_t*>(q),
               static_cast<const int64_t*>(bar),
               static_cast<const int64_t*>(ninv),
               static_cast<const int64_t*>(ninv_sh),
               n_polys, L, logn, log_polys};
  return launch(ntt_kernel<false>, a, blocks, threads, smem, stream);
}

// The gadget digits of x (P, >= ls limbs, N; element strides sxp, sxl, N
// contiguous), two source limbs a digit (beta digits, the last possibly
// one), each extended to the L limbs of the ring and transformed: out (P,
// beta, L, N) contiguous, n_polys = P beta L, logN 14 or 15. pack, q, bar
// are the ring's forward NTT tables (as mkhe_ntt_fwd), dig the digits'
// words (ops/basis_cuda.py::pack_table(src, ring moduli, 2)); the geometry
// is ops/ntt_cuda.py::geometry(logn, n_polys)'s.
extern "C" int mkhe_decompose_ntt(const void* x, long long sxp,
                                  long long sxl, void* out, const void* pack,
                                  const void* q, const void* bar,
                                  const void* dig, int ls, int alpha,
                                  int beta, int n_polys, int L, int logn,
                                  int log_polys, int blocks, int threads,
                                  int smem, void* stream) {
  if (alpha != kAlpha || beta < 1 || ls < 1 || (beta - 1) * alpha >= ls ||
      static_cast<long long>(beta) * alpha < ls || L < 1 ||
      n_polys % (static_cast<long long>(beta) * L) != 0 || dig == nullptr ||
      (logn != 14 && logn != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
         static_cast<const uint64_t*>(pack), static_cast<const int64_t*>(q),
         static_cast<const int64_t*>(bar), nullptr, nullptr,
         n_polys, L, logn, log_polys};
  a.dig = static_cast<const uint32_t*>(dig);
  a.sxp = sxp;
  a.sxl = sxl;
  a.ls = ls;
  a.beta = beta;
  void (*kernel)(Args) = decompose_ntt_kernel<14>;
  if (logn == 15) kernel = decompose_ntt_kernel<15>;
  return launch(kernel, a, blocks, threads, smem, stream);
}
