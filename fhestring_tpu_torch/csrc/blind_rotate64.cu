// Whole 64-bit-torus blind rotation, hand-written for Hopper (sm_90a).
//
// Replaces fhestring_tpu/crypto/kernels/blind_rotate_fused.py:
// blind_rotate_fused (a Pallas TPU kernel).  The Python wrapper and the
// plain PyTorch version are in
// fhestring_tpu_torch/crypto/kernels/blind_rotate64.py; it states what is
// computed.  Per batch item and per step j of the n-step rotation:
//
//   1. one signed 23-bit digit per coefficient of the k+1 = 2 rows (gadget
//      2^23 x 1): exact mode rotates the u64 accumulator by X^a_j, takes
//      diff = rotated - acc and rounds it to its top 23 bits; rounded mode
//      rotates the pre-rounded plane round(acc >> 41) mod 2^23 in Z_{2^23}
//      (it reads only the high 32-bit word).  Each digit is split into 3
//      balanced int8 limbs: 6 digit-limb polys (row r, limb la);
//   2. for each prime p in {40961, 61441}: forward negacyclic NTT of the 6
//      digit-limb polys; pointwise multiply-accumulate against this step's
//      key hats (the 8 balanced byte limbs lb of each u64 key value), one
//      product poly per output row and shift plane s = la + lb < 8; inverse
//      NTT of the product polys.  Approx mode keeps only s >= 3: 10 product
//      polys instead of 16, and the key's limb 0 is never read;
//   3. centered two-prime CRT of each plane W_s, and
//      acc += sum_s sign_extend64(W_s) << 8s (mod 2^64).
//
// Exactness.  |W_s| <= 3 (la, lb) pairs * R * N * 128 * 128 = 2.01e8 at
// R = 2 digit rows and N = 2048, below M/2 = 1.26e9 with
// M = 40961 * 61441 = 2,516,684,801, so the centered CRT returns W_s
// itself.  Residues are < 2^16, so every product of two residues is < 2^32
// and a sum of 6 reduced products is < 2^19: 32-bit arithmetic in the
// transforms.  The accumulator wraps mod 2^64 in uint64_t.
//
// Design.  The TPU kernel's sequential grid axis over the n steps is a
// loop inside the block: one block per batch item keeps its u64
// accumulator in shared memory for all n steps and writes it once.  Shared
// memory per block at N = 2048 (P = product polys, 16 exact, 10 approx):
// accumulator 32 KB, one work buffer of P polys (digit-limb hats, then
// products) 4 * P * N bytes, the prime-40961 results as u16 2 * P * N
// bytes: 224 KB exact (229,376 of the 232,448 bytes a block may use),
// 152 KB approx.  So one block runs per SM; the block takes 1024 threads
// to give the SM enough warps.  The key hats arrive with 1/N folded in, so
// the inverse transform needs no final scaling.
//
// What bounds it.  The butterflies: per step and prime 6 forward and 16
// (approx: 10) inverse transforms of length N, each N/2 * log2(N) modular
// butterflies on the CUDA cores, one __syncthreads per stage.  The key:
// every block re-reads this step's 256 KB (approx: 224 KB) of key hats
// from L2 or device memory on every step; blocks on the same step share it
// through L2.
//
// The transforms, the pointwise products and the CRT are in ntt64.cuh,
// shared with the one-step external product ntt_ext.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"

namespace {

using namespace ntt64;

constexpr int kThreads = 1024;

// round(v >> 41) mod 2^23 from the high word of v: (v >> 41) + bit 40.
__device__ __forceinline__ uint32_t round_top(uint64_t v) {
  const uint32_t hi = static_cast<uint32_t>(v >> 32);
  return ((hi >> 9) + ((hi >> 8) & 1u)) & kDigitMask;
}

// Digit limbs of step amount a as residues mod P: x[(r * 3 + la) * n + t].
// Exact: numpy_ref.decompose(acc * X^a - acc, 23, 1); rounded:
// numpy_ref.cmux_rounded's digit.  Limbs as pbs.balanced_limbs_i32.
template <uint32_t P, bool kRounded>
__device__ void load_digits(uint32_t* x, const uint64_t* acc, int a, int n,
                            int log_n) {
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x) {
    const int r = idx >> log_n;
    const int t = idx & (n - 1);
    const int src = (t - a) & (2 * n - 1);
    const uint64_t from = acc[r * n + (src & (n - 1))];
    int d;
    if (kRounded) {
      uint32_t rot = round_top(from);
      if (src >= n) rot = (0u - rot) & kDigitMask;
      d = centered_digit((rot - round_top(acc[idx])) & kDigitMask);
    } else {
      d = exact_digit((src >= n ? 0ull - from : from) - acc[idx]);
    }
    int limb[kLimbs];
    digit_limbs(d, limb);
#pragma unroll
    for (int la = 0; la < kLimbs; ++la)
      x[(r * kLimbs + la) * n + t] = limb_residue<P>(limb[la]);
  }
  __syncthreads();
}

// acc[r][t] += sum_s W_s << 8s, W_s rebuilt from its residues mod P0
// (res0) and mod P1 (x).
template <bool kApprox>
__device__ void crt_accumulate(uint64_t* acc, const uint16_t* res0,
                               const uint32_t* x, int n, int log_n) {
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    acc[idx] += crt_sum<kApprox>(res0, x, idx >> log_n, idx & (n - 1), n);
  __syncthreads();
}

template <uint32_t P, bool kRounded, bool kApprox>
__device__ void external_product_mod(uint32_t* x, const uint64_t* acc, int a,
                                     const uint16_t* __restrict__ key,
                                     const uint32_t* __restrict__ tw, int n,
                                     int log_n) {
  load_digits<P, kRounded>(x, acc, a, n, log_n);
  product_mod<P, kApprox>(x, key, tw, n, log_n);
}

template <bool kRounded, bool kApprox>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate64_kernel(const uint64_t* __restrict__ acc_in,
                      uint64_t* __restrict__ acc_out,
                      const int32_t* __restrict__ amounts,
                      const uint16_t* __restrict__ khat,
                      const uint32_t* __restrict__ tw, int n_steps, int n,
                      int log_n) {
  constexpr int kOut = Planes<kApprox>::kOut;
  extern __shared__ uint64_t smem[];
  uint64_t* acc = smem;                                          // [kRows][n]
  uint32_t* x = reinterpret_cast<uint32_t*>(acc + kRows * n);    // [kOut][n]
  uint16_t* res0 = reinterpret_cast<uint16_t*>(x + kOut * n);    // [kOut][n]

  const size_t item = blockIdx.x;
  const uint64_t* in = acc_in + item * kRows * n;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    acc[idx] = in[idx];
  __syncthreads();

  const size_t prime_stride = static_cast<size_t>(kRows) * kKeyPolys * n;
  for (int j = 0; j < n_steps; ++j) {
    const int a = amounts[item * n_steps + j];
    const uint16_t* key = khat + 2 * prime_stride * j;
    external_product_mod<kP0, kRounded, kApprox>(x, acc, a, key, tw, n,
                                                 log_n);
    save_residues(res0, x, kOut * n);
    external_product_mod<kP1, kRounded, kApprox>(
        x, acc, a, key + prime_stride, tw + 2 * n, n, log_n);
    crt_accumulate<kApprox>(acc, res0, x, n, log_n);
  }

  uint64_t* out = acc_out + item * kRows * n;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    out[idx] = acc[idx];
}

template <bool kRounded, bool kApprox>
int launch(const void* acc_in, void* acc_out, const void* amounts,
           const void* khat, const void* tw, int batch, int n_steps, int n,
           int log_n, cudaStream_t stream) {
  constexpr int kOut = Planes<kApprox>::kOut;
  const size_t smem = static_cast<size_t>(kRows) * n * 8 +
                      static_cast<size_t>(kOut) * n * (4 + 2);
  auto kernel = blind_rotate64_kernel<kRounded, kApprox>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  kernel<<<batch, kThreads, smem, stream>>>(
      static_cast<const uint64_t*>(acc_in), static_cast<uint64_t*>(acc_out),
      static_cast<const int32_t*>(amounts),
      static_cast<const uint16_t*>(khat), static_cast<const uint32_t*>(tw),
      n_steps, n, log_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc_in, acc_out: u64 [batch, 2, n]; amounts: int32 [batch, n_steps];
// khat: u16 [n_steps, 2 primes, 2 digit rows, 16, n]; tw: u32 [2 primes,
// 2 (fwd, inv), n]; rounded, approx: the mode (0 or 1).  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int fhe_blind_rotate64(const void* acc_in, void* acc_out,
                                  const void* amounts, const void* khat,
                                  const void* tw, int batch, int n_steps,
                                  int n, int rounded, int approx,
                                  void* stream) {
  if (n < 64 || n > 2048 || (n & (n - 1)) || batch < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rounded && approx)
    return launch<true, true>(acc_in, acc_out, amounts, khat, tw, batch,
                              n_steps, n, log_n, s);
  if (rounded)
    return launch<true, false>(acc_in, acc_out, amounts, khat, tw, batch,
                               n_steps, n, log_n, s);
  if (approx)
    return launch<false, true>(acc_in, acc_out, amounts, khat, tw, batch,
                               n_steps, n, log_n, s);
  return launch<false, false>(acc_in, acc_out, amounts, khat, tw, batch,
                              n_steps, n, log_n, s);
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
