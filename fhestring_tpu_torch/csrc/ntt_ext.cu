// One step's 64-bit external product by a two-prime negacyclic NTT,
// hand-written for Hopper (sm_90a).
//
// Replaces fhestring_tpu/crypto/kernels/ntt_ext.py: ntt_ext_u64 (a Pallas
// TPU kernel).  The Python wrapper and the plain PyTorch version are in
// fhestring_tpu_torch/crypto/kernels/ntt_ext.py.  Per batch item:
//
//   ext[col] = sum_r d[r] (x) key[r][col]   (negacyclic, mod 2^64)
//
// with d[r] the 23-bit digits given as 3 balanced int8 limbs (the output of
// rotate_decompose.cu) and key the step's bootstrap-key hats (the 8 byte
// limbs of each u64 key value, transformed mod 40961 and 61441; the layout
// blind_rotate64.cu reads).  It is one step of blind_rotate64.cu's exact
// mode without the accumulator update, built from the same device code
// (ntt64.cuh): 6 forward and 16 inverse transforms per prime, the centered
// two-prime CRT of each shift plane W_s, ext = sum_s W_s << 8s.  The TPU
// kernel's 3-prime grouping of the shift planes is not needed: each W_s is
// exact under the two primes (ntt64.cuh).
//
// Design.  One block of 1024 threads per batch item.  Shared memory at
// N = 2048: one work buffer of 16 polys (digit-limb hats, then products)
// u32 128 KB, the prime-40961 results u16 64 KB: 192 KB, so one block runs
// per SM.  The result goes straight to device memory.
//
// What bounds it.  As blind_rotate64.cu's exact mode per step: integer
// instructions on the CUDA cores (per prime 22 transforms of length N in
// passes of up to 3 stages, lazy Shoup butterflies; 2.8e6 instructions an
// item at the least); every block reads the step's 256 KB of key hats from
// L2.  A batch of up to 132 items takes one wave.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"

namespace {

using namespace ntt64;

constexpr int kThreads = 1024;
constexpr int kOut = Planes<false>::kOut;

// The item's digit limbs dl[la][item][r * n + t] as residues mod P at
// x[(r * 3 + la) * n + t].
template <uint32_t P>
__device__ void load_limbs(uint32_t* x, const int8_t* __restrict__ dl,
                           size_t item, size_t limb_stride, int n,
                           int log_n) {
  const int8_t* src = dl + item * kRows * n;
  for (int idx = threadIdx.x; idx < kLimbs * kRows * n; idx += blockDim.x) {
    const int la = idx / (kRows * n);
    const int rt = idx - la * kRows * n;  // r * n + t
    const int r = rt >> log_n;
    const int t = rt & (n - 1);
    x[(r * kLimbs + la) * n + t] =
        limb_residue<P>(src[la * limb_stride + rt]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
ntt_ext_kernel(const int8_t* __restrict__ dl,
               const uint16_t* __restrict__ khat,
               const uint2* __restrict__ tw, uint64_t* __restrict__ out,
               int batch, int n, int log_n) {
  extern __shared__ uint32_t x[];                                 // [kOut][n]
  uint16_t* res0 = reinterpret_cast<uint16_t*>(x + kOut * n);     // [kOut][n]

  const size_t item = blockIdx.x;
  const size_t limb_stride = static_cast<size_t>(batch) * kRows * n;
  const size_t prime_stride = static_cast<size_t>(kRows) * kKeyPolys * n;
  load_limbs<kP0>(x, dl, item, limb_stride, n, log_n);
  product_mod<kP0, false>(x, khat, tw, n, log_n);
  save_residues(res0, x, kOut * n);
  load_limbs<kP1>(x, dl, item, limb_stride, n, log_n);
  product_mod<kP1, false>(x, khat + prime_stride, tw + 2 * n, n, log_n);

  uint64_t* dst = out + item * kRows * n;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    dst[idx] = crt_sum<false>(res0, x, idx >> log_n, idx & (n - 1), n);
}

}  // namespace

// Once per device, before the first launch (and before any stream capture):
// loads the kernel and lets it use the shared memory of N = 2048.  Returns a
// cudaError_t.
extern "C" int fhe_ntt_ext_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      ntt_ext_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOut * 2048 * (4 + 2)));
}

// dl: int8 [3, batch, 2 * n] digit limbs (natural coefficient order);
// khat: u16 [2 primes, 2 digit rows, 16, n] (one step of the
// blind_rotate64 key); tw: u32 [2 primes, 2 (fwd, inv), n, 2 (twiddle, its
// Shoup quotient)] (ntt.kernel_twiddles); out: u64
// [batch, 2, n].  Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int fhe_ntt_ext(const void* dl, const void* khat, const void* tw,
                           void* out, int batch, int n, void* stream) {
  if (n < 64 || n > 2048 || (n & (n - 1)) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const size_t smem = static_cast<size_t>(kOut) * n * (4 + 2);
  if (batch == 0) return 0;
  ntt_ext_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dl), static_cast<const uint16_t*>(khat),
      static_cast<const uint2*>(tw), static_cast<uint64_t*>(out), batch, n,
      log_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
