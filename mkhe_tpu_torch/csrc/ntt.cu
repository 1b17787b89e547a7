// Forward and inverse negacyclic NTT for Hopper (sm_90a).
//
// Replaces the TPU kernels mkhe_tpu/ops/ntt_pallas.py::_fwd_kernel and
// ::_inv_kernel. Computes exactly what they compute, which is what the
// JAX package's jnp path computes (mkhe_tpu/ops/ring.py:377-440):
//   forward: merged-twist Cooley-Tukey with the psi / psi_sh tables,
//            standard order in, bit-reversed order out;
//   inverse: Gentleman-Sande with ipsi / ipsi_sh and a final multiply by
//            N^-1, bit-reversed order in, standard order out.
// Both reduce their input first (Barrett), so the forward kernel takes any
// u32 and the inverse kernel takes the lazy < 8q inputs of the key-switch
// pipeline; outputs are canonical, equal bit for bit to the plain PyTorch
// versions in ops/ntt_cuda.py. Twiddle products are Shoup multiplies with
// an exact __umulhi quotient, so every intermediate stays canonical.
//
// Layout: data (n_polys, N) int64 holding u32 values, polynomial p on limb
// p % L; tables (L, N) and constants (L,) int64. One thread block per
// polynomial holds the whole polynomial in dynamic shared memory (N = 2^15
// u32 is 128 KiB, so logN <= 15), with up to 1024 threads doing N/2 / 1024
// butterflies each per stage and a __syncthreads() between stages.
// Twiddles are read from global memory, where L2 keeps them.
//
// What bounds it on an H100: integer multiplies (three 32-bit products per
// butterfly) and shared-memory traffic (each of the logN stages reads and
// writes the whole 128 KiB polynomial). With 128 KiB per block one block
// runs per SM. No wgmma, TMA or multi-limb blocking yet.

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

__device__ __forceinline__ void load_reduced(uint32_t* s, const int64_t* x,
                                             int n, uint32_t q,
                                             uint32_t bar) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = barrett(static_cast<uint32_t>(x[i]), q, bar);
}

__global__ void __launch_bounds__(1024)
ntt_fwd_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
               const int64_t* __restrict__ psi,
               const int64_t* __restrict__ psi_sh,
               const int64_t* __restrict__ qv,
               const int64_t* __restrict__ barv, int L, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t q = static_cast<uint32_t>(qv[limb]);
  const int64_t* w = psi + static_cast<size_t>(limb) * n;
  const int64_t* wsh = psi_sh + static_cast<size_t>(limb) * n;

  load_reduced(s, x + base, n, q, static_cast<uint32_t>(barv[limb]));
  __syncthreads();
  // stage with m groups of 2t: u = s[2it + j], v = s[2it + t + j],
  // twiddle psi[m + i]
  for (int m = 1, logt = logn - 1; m < n; m <<= 1, --logt) {
    const int tmask = (1 << logt) - 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> logt;
      const int iu = (i << (logt + 1)) + (k & tmask);
      const int iv = iu + (1 << logt);
      const uint32_t u = s[iu];
      const uint32_t vs = shoup_mul(s[iv], static_cast<uint32_t>(w[m + i]),
                                    static_cast<uint32_t>(wsh[m + i]), q);
      s[iu] = csub(u + vs, q);
      s[iv] = csub(u + q - vs, q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = static_cast<int64_t>(s[i]);
}

__global__ void __launch_bounds__(1024)
ntt_inv_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
               const int64_t* __restrict__ ipsi,
               const int64_t* __restrict__ ipsi_sh,
               const int64_t* __restrict__ qv,
               const int64_t* __restrict__ barv,
               const int64_t* __restrict__ ninv,
               const int64_t* __restrict__ ninv_sh, int L, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t q = static_cast<uint32_t>(qv[limb]);
  const int64_t* w = ipsi + static_cast<size_t>(limb) * n;
  const int64_t* wsh = ipsi_sh + static_cast<size_t>(limb) * n;

  load_reduced(s, x + base, n, q, static_cast<uint32_t>(barv[limb]));
  __syncthreads();
  // stage with h groups of 2t: u = s[2it + j], v = s[2it + t + j],
  // twiddle ipsi[h + i]
  for (int h = half, logt = 0; h >= 1; h >>= 1, ++logt) {
    const int tmask = (1 << logt) - 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> logt;
      const int iu = (i << (logt + 1)) + (k & tmask);
      const int iv = iu + (1 << logt);
      const uint32_t u = s[iu];
      const uint32_t v = s[iv];
      s[iu] = csub(u + v, q);
      s[iv] = shoup_mul(csub(u + q - v, q), static_cast<uint32_t>(w[h + i]),
                        static_cast<uint32_t>(wsh[h + i]), q);
    }
    __syncthreads();
  }
  const uint32_t nv = static_cast<uint32_t>(ninv[limb]);
  const uint32_t nvsh = static_cast<uint32_t>(ninv_sh[limb]);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = static_cast<int64_t>(shoup_mul(s[i], nv, nvsh, q));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int logn, size_t* smem, int* threads) {
  if (logn < 1 || logn > 15) return cudaErrorInvalidValue;
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
extern "C" int mkhe_ntt_fwd(const void* x, void* out, const void* psi,
                            const void* psi_sh, const void* q,
                            const void* bar, int n_polys, int L, int logn,
                            void* stream) {
  size_t smem;
  int threads;
  cudaError_t err = prepare(ntt_fwd_kernel, logn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_kernel<<<n_polys, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const int64_t*>(psi), static_cast<const int64_t*>(psi_sh),
      static_cast<const int64_t*>(q), static_cast<const int64_t*>(bar), L,
      logn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mkhe_ntt_inv(const void* x, void* out, const void* ipsi,
                            const void* ipsi_sh, const void* q,
                            const void* bar, const void* ninv,
                            const void* ninv_sh, int n_polys, int L,
                            int logn, void* stream) {
  size_t smem;
  int threads;
  cudaError_t err = prepare(ntt_inv_kernel, logn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_kernel<<<n_polys, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const int64_t*>(ipsi),
      static_cast<const int64_t*>(ipsi_sh), static_cast<const int64_t*>(q),
      static_cast<const int64_t*>(bar), static_cast<const int64_t*>(ninv),
      static_cast<const int64_t*>(ninv_sh), L, logn);
  return static_cast<int>(cudaGetLastError());
}
