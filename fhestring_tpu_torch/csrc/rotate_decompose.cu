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
// Design.  One thread per 4 neighbouring output coefficients: two 16-byte
// loads of the accumulator, a gather of the 4 sources with the negacyclic
// sign (scalar loads: the source is unaligned by the amount), the u64
// differences, the rounding and the limb split in registers, and one packed
// 4-byte store per limb plane.  The TPU kernel's 12-stage log-shear
// rotation exists because a TPU lane cannot gather; here each thread reads
// its sources directly.
//
// What bounds it.  Device memory: 16 bytes read (the coefficient and its
// source, mostly from L1/L2) and 3 bytes written per coefficient; at
// B = 256 and N = 2048 that is 16 MB per step, some 5 us at 3.35 TB/s.  At
// a request's batches (5 to 66 items) the kernel is a microsecond or two on
// the card and its cost is the launch: the step loop of crypto/pbs.py
// replays its launches from a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"  // the digit rule, shared with blind_rotate64.cu

namespace {

using namespace ntt64;

constexpr int kThreads = 256;
constexpr int kPer = 4;  // coefficients per thread

__global__ void __launch_bounds__(kThreads)
rotate_decompose_kernel(const uint64_t* __restrict__ acc,
                        const int32_t* __restrict__ amounts,
                        int8_t* __restrict__ dl, size_t total, int n,
                        int log_n) {
  const size_t idx =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (idx >= total) return;
  const size_t row = idx >> log_n;                 // b * kRows + r
  const int t = static_cast<int>(idx & (n - 1));
  const int a = amounts[row / kRows];
  const uint64_t* base = acc + (row << log_n);
  const ulonglong2 h0 = *reinterpret_cast<const ulonglong2*>(acc + idx);
  const ulonglong2 h1 = *reinterpret_cast<const ulonglong2*>(acc + idx + 2);
  const uint64_t here[kPer] = {h0.x, h0.y, h1.x, h1.y};
  uint32_t packed[kLimbs] = {0, 0, 0};
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int src = (t + i - a) & (2 * n - 1);
    const uint64_t from = base[src & (n - 1)];
    const uint64_t rot = src >= n ? 0ull - from : from;
    int limb[kLimbs];
    digit_limbs(exact_digit(rot - here[i]), limb);
#pragma unroll
    for (int la = 0; la < kLimbs; ++la)
      packed[la] |= (static_cast<uint32_t>(limb[la]) & 255u) << (8 * i);
  }
#pragma unroll
  for (int la = 0; la < kLimbs; ++la)
    *reinterpret_cast<uint32_t*>(dl + la * total + idx) = packed[la];
}

}  // namespace

// Once per device, before the first launch (and before any stream capture):
// loads the kernel.  Returns a cudaError_t.
extern "C" int fhe_rotate_decompose_init() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, rotate_decompose_kernel));
}

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
  const size_t per_block = static_cast<size_t>(kThreads) * kPer;
  const unsigned blocks =
      static_cast<unsigned>((total + per_block - 1) / per_block);
  rotate_decompose_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(acc), static_cast<const int32_t*>(amounts),
      static_cast<int8_t*>(dl), total, n, log_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
