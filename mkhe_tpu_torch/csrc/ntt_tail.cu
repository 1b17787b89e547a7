// The split negacyclic NTT's inverse for Hopper (sm_90a): the DIT stages
// that follow the tail.
//
// Replaces the TPU kernel _inv_kernel(tail_done=True) of
// mkhe_tpu/ops/ntt_pallas.py's MXU-tail form (config.pallas_ntt_mxu_tail,
// :159-175, 199-225). The transform is "twist by psi^j, then DIF stages with
// block-periodic twiddles" (ntt_pallas.py:9-17), not ntt.cu's merged-twist
// Cooley-Tukey: only in this decimation do the stages with half-block
// h < 128 act on every 128-lane block by the same fixed 128x128 map M over
// Z_q (tables: ops/ntt_cuda.py::SplitTables). The forward direction and the
// tail are ntt_split.cu's.
//
//   ntt_inv_tailed_kernel DIT stages h = 128 .. N/2 (iwpack), then untwist
//                         by psi^-j / N.
// inverse = inv_tailed(tail(x, tail_inv)). The output is canonical, equal
// bit for bit to the plain PyTorch version in ops/ntt_cuda.py.
//
// One block per polynomial in dynamic shared memory, as in ntt.cu, with
// exact Shoup twiddle multiplies; bound by integer multiplies and
// shared-memory traffic, 8 stages at N = 2^15 instead of 15.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
