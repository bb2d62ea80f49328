// Per-step prologue of the step-wise 64-bit blind rotation, hand-written
// for Hopper (sm_90a).
//
// Replaces fhestring_tpu/crypto/kernels/rotate_decompose.py:
// rotate_diff_decompose (a Pallas TPU kernel).  The Python wrapper and the
// plain PyTorch version are in
// fhestring_tpu_torch/crypto/kernels/rotate_decompose.py.  Per batch item b,
// row r and coefficient t, with a = amounts[b] in [0, 2N):
//
//   rot   = (acc * X^a)[r][t]        (negacyclic: acc[r][(t - a) mod N],
//                                     negated when (t - a) mod 2N >= N)
//   diff  = rot - acc[r][t]          (mod 2^64)
//   state = round(diff >> 41) mod 2^23, d = state - 2^23 * (state >= 2^22)
//   dl[la][b][r * N + t] = the 3 balanced int8 limbs of d
//
// the ell = 1 gadget decomposition of numpy_ref.decompose(., 23, 1), split
// as pbs.balanced_limbs_i32.  All arithmetic on the torus is in uint64_t, so
// the wrap mod 2^64 is defined.
//
// Design.  One thread per output coefficient: a gather with the negacyclic
// sign, the u64 difference, the rounding and the limb split in registers.
// The TPU kernel's 12-stage log-shear rotation exists because a TPU lane
// cannot gather; here each thread reads its source coefficient directly.
//
// What bounds it.  Device memory: 16 bytes read (the coefficient and its
// source, mostly from L1/L2) and 3 bytes written per coefficient; at
// B = 256 and N = 2048 that is 16 MB per step, some 5 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"  // the digit rule, shared with blind_rotate64.cu

namespace {

using namespace ntt64;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rotate_decompose_kernel(const uint64_t* __restrict__ acc,
                        const int32_t* __restrict__ amounts,
                        int8_t* __restrict__ dl, size_t total, int n,
                        int log_n) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const size_t row = idx >> log_n;                 // b * kRows + r
  const int t = static_cast<int>(idx & (n - 1));
  const int a = amounts[row / kRows];
  const int src = (t - a) & (2 * n - 1);
  const uint64_t from = acc[(row << log_n) + (src & (n - 1))];
  const uint64_t rot = src >= n ? 0ull - from : from;
  int limb[kLimbs];
  digit_limbs(exact_digit(rot - acc[idx]), limb);
#pragma unroll
  for (int la = 0; la < kLimbs; ++la)
    dl[la * total + idx] = static_cast<int8_t>(limb[la]);
}

}  // namespace

// acc: u64 [batch, 2, n]; amounts: int32 [batch] in [0, 2n); dl: int8
// [3, batch, 2 * n].  Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int fhe_rotate_decompose(const void* acc, const void* amounts,
                                    void* dl, int batch, int n,
                                    void* stream) {
  if (n < 64 || n > 2048 || (n & (n - 1)) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const size_t total = static_cast<size_t>(batch) * kRows * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  rotate_decompose_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(acc), static_cast<const int32_t*>(amounts),
      static_cast<int8_t*>(dl), total, n, log_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
