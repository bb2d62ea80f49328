// Whole 32-bit-torus blind rotation, hand-written for Hopper (sm_90a).
//
// Replaces fhestring_tpu/crypto/kernels/blind_rotate_fused32.py:
// blind_rotate_fused32 (a Pallas TPU kernel).  The Python wrapper and the
// plain PyTorch version are in
// fhestring_tpu_torch/crypto/kernels/blind_rotate32.py; it states what is
// computed.  Per batch item and per step j of the n-step rotation:
//
//   1. rotate the u32 accumulator (k+1 = 2 polys of N) by X^a_j exactly,
//      take diff = rotated - acc, round it to the top 24 bits and split it
//      into 3 balanced base-256 digits: R = 6 digit polys;
//   2. for each prime p in {40961, 61441}: forward negacyclic NTT of the 6
//      digit polys, pointwise multiply-accumulate against this step's key
//      hats (6 x 8 polys: 2 output rows x 4 byte limbs of the key payload),
//      inverse NTT of the 8 products;
//   3. centered two-prime CRT of each product plane W_s, and
//      acc += sum_s W_s << 8s (mod 2^32).
//
// Exactness.  |W_s| <= R * N * 128 * 128 = 2.01e8 at N = 2048, below
// M/2 = 1.26e9 with M = 40961 * 61441 = 2,516,684,801, so the centered CRT
// returns W_s itself and its low 32 bits are exact in uint32 arithmetic.
// Residues are < 2^16, so every product of two residues is < 2^32: the
// transforms work in 32-bit words (ntt64.cuh says how far they may grow),
// and a plane's R = 6 products are summed in 64 bits and reduced once.
//
// Design.  The TPU kernel's sequential grid axis over the n steps is a
// loop inside the kernel: an item's accumulator stays in shared memory for
// all n steps and is written once.  Three bodies give the same bits:
//
//   1 block per item (512 threads; at N = 2048 accumulator 16 KB, one work
//     buffer of 8 polys for the digit hats and then the products 64 KB, the
//     prime-40961 residues as u16 32 KB: 112 KB, two blocks an SM), the
//     primes in turn;
//   a thread-block cluster of 2 or 4 blocks per item (rotate_cluster.cuh;
//     1,024 threads a block), split by prime, or by prime and output row:
//     14 or 7 of the step's 28 transforms a block, the parts exchanged
//     through distributed shared memory; the 4-block body also holds its
//     96 KB quarter of a step's key, copied in a step ahead (176 KB a
//     block).
//
// The transforms, the CRT and the cluster bodies are shared with the 64-bit
// kernels (ntt64.cuh, rotate_cluster.cuh).  The key hats arrive with 1/N
// folded in, so the inverse transform needs no final scaling.
//
// What bounds it.  Integer instructions on the CUDA cores, not memory: a
// step reads 393 KB of key hats (292 MB a launch, under 0.1 ms of HBM
// time; blocks on the same step share it through L2) and does 28
// transforms of length N, 315,392 butterflies of 5 integer instructions
// (a Shoup product and two lazy adds), and 196,608 multiply-adds: 1.8e6
// instructions an item-step at the least, 0.63 ms for B = 8 and 161 ms for
// B = 2048 at an H100's 64 int32 lanes x 132 SMs x 1.98 GHz.  One item on
// one SM can use 1/132 of that rate, and a request's batches are 5 to 40
// items, so the clusters spread an item over 4 SMs while the batch leaves
// them idle: at B = 8 the 4-block body reaches about 5% of the bound (the
// one-block body 1.6%); at B = 2048 the one-block body reaches about 32%
// of it.  The rest goes to shared memory traffic and address arithmetic (9
// instructions a butterfly as compiled), bank conflicts in the passes of
// distance 16 and below, and barriers; tensor-core transforms are later
// work.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"
#include "rotate_cluster.cuh"

namespace {

using ntt64::kM;
using ntt64::kP0;
using ntt64::kP1;
using ntt64::ntt_fwd;
using ntt64::ntt_inv;

constexpr int kRows = 2;               // k + 1
constexpr int kLevels = 3;             // gadget levels, base 2^8
constexpr int kDigits = kRows * kLevels;   // R
constexpr int kPlanes = 4;             // byte limbs of the key payload
constexpr int kOut = kRows * kPlanes;  // product planes per prime
constexpr int kThreads = 512;

static_assert(kOut >= kDigits, "work buffer holds the digit polys");
static_assert(kRows == ntt64::kRows && kLevels == ntt64::kLimbs,
              "the cluster bodies split 2 rows of 3 digit polys");

// Digits of diff = acc * X^a - acc of the `rows` accumulator rows at acc, as
// residues mod P: x[(r * 3 + lev) * n + t].  Identical to
// numpy_ref.decompose on diff << 32 (base 2^8, 3 levels, level 0 most
// significant).
template <uint32_t P>
__device__ void load_digits(uint32_t* x, const uint32_t* acc, int rows, int a,
                            int n, int log_n) {
  constexpr int shift = 32 - 8 * kLevels;
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    const int r = idx >> log_n;
    const int t = idx & (n - 1);
    const int src = (t - a) & (2 * n - 1);
    uint32_t rot = acc[r * n + (src & (n - 1))];
    if (src >= n) rot = 0u - rot;
    const uint32_t diff = rot - acc[idx];
    uint32_t state = (diff >> shift) + ((diff >> (shift - 1)) & 1u);
#pragma unroll
    for (int lev = kLevels - 1; lev >= 0; --lev) {
      int d = static_cast<int>(state & 255u);
      state >>= 8;
      const int carry = d >= 128;
      d -= carry << 8;
      state += static_cast<uint32_t>(carry);
      x[(r * kLevels + lev) * n + t] =
          d < 0 ? static_cast<uint32_t>(d + static_cast<int>(P))
                : static_cast<uint32_t>(d);
    }
  }
  __syncthreads();
}

// x[(col - col0) * 4 + s][h] = sum_i d_i[h] * key[i][col * 4 + s][h] mod P
// for the 4 product planes s of each of the kCols output rows from col0,
// with d0 and d1 the transformed digit polys [3][n] of accumulator rows 0
// and 1.  d0 and d1 may lie inside x: each column h is read, then written,
// by one thread only.  key: this step's and this prime's hats, u16
// [R][8][n] in device memory, or (kStaged) a copy of the kCols rows' polys
// in shared memory, u16 [R][kCols * 4][n] with col0 = 0.
template <uint32_t P, int kCols, bool kStaged = false>
__device__ void digit_products(uint32_t* x, const uint32_t* d0,
                               const uint32_t* d1,
                               const uint16_t* __restrict__ key, int col0,
                               int n) {
  constexpr int kRowPolys = kStaged ? kCols * kPlanes : kOut;
  for (int h = threadIdx.x; h < n; h += blockDim.x) {
    uint32_t d[kDigits];
#pragma unroll
    for (int lev = 0; lev < kLevels; ++lev) {
      d[lev] = d0[lev * n + h];
      d[kLevels + lev] = d1[lev * n + h];
    }
#pragma unroll
    for (int o = 0; o < kCols * kPlanes; ++o) {
      uint64_t s = 0;  // 6 products < 2^32
#pragma unroll
      for (int i = 0; i < kDigits; ++i) {
        const uint16_t* kp =
            key + (i * kRowPolys + col0 * kPlanes + o) * n + h;
        s += static_cast<uint64_t>(d[i]) * (kStaged ? *kp : __ldg(kp));
      }
      x[o * n + h] = ntt64::reduce_sum<P>(s);
    }
  }
  __syncthreads();
}

// sum_s W_s << 8s (mod 2^32) of local output row r, coefficient t: each W_s
// rebuilt from its residues mod P0 (res0) and mod P1 (res1), u16 or u32
// polys [rows * 4][n], by a centered Garner CRT.
template <class T0, class T1>
__device__ __forceinline__ uint32_t plane_sum(const T0* res0, const T1* res1,
                                              int r, int t, int n) {
  uint32_t sum = 0;
#pragma unroll
  for (int s = 0; s < kPlanes; ++s) {
    const int o = (r * kPlanes + s) * n + t;
    uint32_t v = ntt64::crt_value(res0[o], res1[o]);
    if (v > kM / 2) v -= kM;  // centered: wraps to W_s mod 2^32
    sum += v << (8 * s);
  }
  return sum;
}

template <uint32_t P>
__device__ void external_product_mod(uint32_t* x, const uint32_t* acc, int a,
                                     const uint16_t* __restrict__ key,
                                     const uint2* __restrict__ tw, int n,
                                     int log_n) {
  load_digits<P>(x, acc, kRows, a, n, log_n);
  ntt_fwd<P>(x, kDigits, log_n, tw);
  digit_products<P, kRows>(x, x, x + kLevels * n, key, 0, n);
  ntt_inv<P>(x, kOut, log_n, tw + n);
}

// The one-block body: an item's whole step on one SM, the primes in turn.
__global__ void __launch_bounds__(kThreads, 2)
blind_rotate32_kernel(const int32_t* __restrict__ acc_in,
                      int32_t* __restrict__ acc_out,
                      const int32_t* __restrict__ amounts,
                      const uint16_t* __restrict__ khat,
                      const uint2* __restrict__ tw, int n_steps, int n,
                      int log_n) {
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                                  // [kRows][n]
  uint32_t* x = acc + kRows * n;                         // [kOut][n]
  uint16_t* res0 = reinterpret_cast<uint16_t*>(x + kOut * n);  // [kOut][n]

  const size_t item = blockIdx.x;
  const int32_t* in = acc_in + item * kRows * n;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    acc[idx] = static_cast<uint32_t>(in[idx]);
  __syncthreads();

  const size_t prime_stride = static_cast<size_t>(kDigits) * kOut * n;
  for (int j = 0; j < n_steps; ++j) {
    const int a = amounts[item * n_steps + j];
    const uint16_t* key = khat + 2 * prime_stride * j;
    external_product_mod<kP0>(x, acc, a, key, tw, n, log_n);
    ntt64::save_residues(res0, x, kOut * n);
    external_product_mod<kP1>(x, acc, a, key + prime_stride, tw + 2 * n, n,
                              log_n);
    for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
      acc[idx] += plane_sum(res0, x, idx >> log_n, idx & (n - 1), n);
    __syncthreads();
  }

  int32_t* out = acc_out + item * kRows * n;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    out[idx] = static_cast<int32_t>(acc[idx]);
}

// What the cluster bodies (rotate_cluster.cuh) take from this kernel.
struct Spec {
  using Acc = uint32_t;
  // The digits of a step come from the accumulator and the item's rotation
  // amount of that step.
  using Source = const int32_t*;
  using Step = int;
  static __device__ __forceinline__ Step step(Source amounts, size_t item,
                                              int row0, int n, int n_steps,
                                              int j) {
    return amounts[item * n_steps + j];
  }
  static constexpr int kCount = kPlanes;
  static constexpr int kKeyPolys = kDigits * kOut;

  template <uint32_t P>
  static __device__ void digits(uint32_t* x, const uint32_t* acc, int rows,
                                int a, int n, int log_n) {
    load_digits<P>(x, acc, rows, a, n, log_n);
  }

  template <uint32_t P, int kCols>
  static __device__ void pointwise(uint32_t* x, const uint32_t* d0,
                                   const uint32_t* d1,
                                   const uint16_t* __restrict__ key, int col0,
                                   int n) {
    digit_products<P, kCols>(x, d0, d1, key, col0, n);
  }

  // One output row's key polys of a step and prime: 6 runs of 4 polys.
  static constexpr int kStageRuns = kDigits;
  static constexpr int kStageRunPolys = kPlanes;
  static constexpr int kStageRunStride = kOut;

  template <uint32_t P>
  static __device__ void pointwise_staged(uint32_t* x, const uint32_t* d0,
                                          const uint32_t* d1,
                                          const uint16_t* staged, int n) {
    digit_products<P, 1, true>(x, d0, d1, staged, 0, n);
  }

  template <class T0, class T1>
  static __device__ __forceinline__ uint32_t crt_sum(const T0* res0,
                                                     const T1* res1, int r,
                                                     int t, int n) {
    return plane_sum(res0, res1, r, t, n);
  }
};

// Bytes of shared memory of the one-block body.
constexpr size_t smem_bytes(int n) {
  return static_cast<size_t>(kRows + kOut) * n * 4 +
         static_cast<size_t>(kOut) * n * 2;
}

bool valid(int n, int cluster) {
  return n >= 64 && n <= 2048 && !(n & (n - 1)) &&
         (cluster == 1 || cluster == 2 || cluster == 4);
}

}  // namespace

// Once per device, before the first launch: loads the kernels and lets every
// body use the shared memory of N = 2048.  Returns a cudaError_t.
extern "C" int fhe_blind_rotate32_init() {
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(2048)));
  if (err == cudaSuccess)
    err = rotate_cluster::allow_shared_memory<Spec, 2>(2048);
  if (err == cudaSuccess)
    err = rotate_cluster::allow_shared_memory<Spec, 4>(2048);
  return static_cast<int>(err);
}

// acc_in, acc_out: int32 [batch, 2, n]; amounts: int32 [batch, n_steps];
// khat: u16 [n_steps, 2, 6, 8, n]; tw: u32 [2 primes, 2 (fwd, inv), n,
// 2 (twiddle, its Shoup quotient)] (ntt.kernel_twiddles);
// cluster: blocks per item, 1, 2 or 4.  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int fhe_blind_rotate32(const void* acc_in, void* acc_out,
                                  const void* amounts, const void* khat,
                                  const void* tw, int batch, int n_steps,
                                  int n, int cluster, void* stream) {
  if (!valid(n, cluster) || batch < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 2)
    return rotate_cluster::launch<Spec, 2>(
        acc_in, acc_out, static_cast<const int32_t*>(amounts), khat, tw,
        batch, n_steps, n, log_n, s);
  if (cluster == 4)
    return rotate_cluster::launch<Spec, 4>(
        acc_in, acc_out, static_cast<const int32_t*>(amounts), khat, tw,
        batch, n_steps, n, log_n, s);
  if (batch == 0) return 0;
  const size_t smem = smem_bytes(n);
  blind_rotate32_kernel<<<batch, kThreads, smem, s>>>(
      static_cast<const int32_t*>(acc_in), static_cast<int32_t*>(acc_out),
      static_cast<const int32_t*>(amounts),
      static_cast<const uint16_t*>(khat), static_cast<const uint2*>(tw),
      n_steps, n, log_n);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the body (cluster = 2 or 4) the current device runs
// at once at this n, or minus the cudaError_t.
extern "C" int fhe_blind_rotate32_max_clusters(int n, int cluster) {
  if (!valid(n, cluster) || cluster == 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  return cluster == 2 ? rotate_cluster::max_active_clusters<Spec, 2>(n)
                      : rotate_cluster::max_active_clusters<Spec, 4>(n);
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
