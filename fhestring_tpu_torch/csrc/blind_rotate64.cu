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
// itself.  Residues are < 2^16, so every product of two residues is < 2^32:
// the transforms work in 32-bit words (ntt64.cuh says how far they may
// grow), and a plane's 6 products are summed in 64 bits and reduced once.
// The accumulator wraps mod 2^64 in uint64_t.
//
// Design.  The TPU kernel's sequential grid axis over the n steps is a
// loop inside the kernel: an item's u64 accumulator stays in shared memory
// for all n steps and is written once.  Three bodies give the same bits:
//
//   1 block per item (1,024 threads; at N = 2048, with P product polys, 16
//     exact and 10 approx: accumulator 32 KB, one work buffer of P polys
//     for the digit-limb hats and then the products 4 P N bytes, the
//     prime-40961 residues as u16 2 P N bytes: 224 KB exact, 229,376 of
//     the 232,448 bytes a block may use, 152 KB approx; one block an SM),
//     the primes in turn;
//   a thread-block cluster of 2, 4 or 8 blocks per item
//     (rotate_cluster.cuh), split by prime, by prime and output row, or by
//     prime, output row and half of the row's product planes: 16, 8 or 4
//     of the production mode's 32 transforms a block (22, 11 or 5-6 of the
//     exact mode's 44), the parts exchanged through distributed shared
//     memory; 152, 164 or 168 KB a block in the production mode, 224, 200
//     or 208 KB in the exact mode: the 4- and 8-block bodies also hold
//     their slice of a step's key (64 KB; at 8 the 32-48 KB of key limbs
//     their planes read), copied in a step ahead.
//
// The transforms, the pointwise products and the CRT are in ntt64.cuh,
// shared with the one-step external product ntt_ext.cu.  The key hats
// arrive with 1/N folded in, so the inverse transform needs no final
// scaling.
//
// What bounds it.  Integer instructions on the CUDA cores, not memory: a
// step reads 256 KB (approx: 224 KB) of key hats (194.5 MB a launch, under
// 0.1 ms of HBM time; blocks on the same step share it through L2) and
// does, in the production mode, 32 transforms of length N, 360,448
// butterflies of 5 integer instructions (a Shoup product and two lazy
// adds), and 245,760 multiply-adds: 2.0e6 instructions an item-step at the
// least (exact: 2.8e6), 0.73 ms for B = 8 and 186 ms for B = 2048 at an
// H100's 64 int32 lanes x 132 SMs x 1.98 GHz.  One item on one SM can use
// 1/132 of that rate, and a request's batches are 5 to 40 items, so the
// clusters spread an item over up to 8 SMs while the batch leaves them
// idle: at B = 8 the 8-block body reaches about 6.9% of the bound
// (10.55 ms; the 4-block body 5.8%, the one-block body 2.0%); at B = 2048
// the one-block body reaches about 32% of it (580 ms).  The rest goes to
// shared memory traffic and address arithmetic (9 instructions a butterfly
// as compiled), in the 8-block body the stores into its peers and the
// step's parts that do not split, the key's 2-byte
// loads from L2 in the pointwise products of the 1- and 2-block bodies (a
// fifth of a step), and barriers; the transforms' work buffers are swizzled
// (ntt64.cuh), so no pass has bank conflicts; tensor-core transforms
// are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"
#include "rotate_cluster.cuh"

namespace {

using namespace ntt64;

constexpr int kThreads = 1024;
static_assert(kThreads % 256 == 0, "ntt64.cuh: swizzle_shift");

// round(v >> 41) mod 2^23 from the high word of v: (v >> 41) + bit 40.
__device__ __forceinline__ uint32_t round_top(uint64_t v) {
  const uint32_t hi = static_cast<uint32_t>(v >> 32);
  return ((hi >> 9) + ((hi >> 8) & 1u)) & kDigitMask;
}

// Digit limbs of step amount a of the `rows` accumulator rows at acc, as
// residues mod P: x[(r * 3 + la) * n + swizzle(t)].  Exact:
// numpy_ref.decompose(acc * X^a - acc, 23, 1); rounded:
// numpy_ref.cmux_rounded's digit.  Limbs as pbs.balanced_limbs_i32.
template <uint32_t P, bool kRounded>
__device__ void load_digits(uint32_t* x, const uint64_t* acc, int rows, int a,
                            int n, int log_n) {
  const int shift = swizzle_shift(threadIdx.x & (n - 1));
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
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
    const int at = t + shift;
#pragma unroll
    for (int la = 0; la < kLimbs; ++la)
      x[(r * kLimbs + la) * n + at] = limb_residue<P>(limb[la]);
  }
  __syncthreads();
}

// acc[r][t] += sum_s W_s << 8s, W_s rebuilt from its residues mod P0
// (res0) and mod P1 (x).
template <bool kApprox>
__device__ void crt_accumulate(uint64_t* acc, const uint16_t* res0,
                               const uint32_t* x, int n, int log_n) {
  const int shift = swizzle_shift(threadIdx.x & (n - 1));
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    acc[idx] += crt_sum<kApprox>(res0, x, idx >> log_n,
                                 (idx & (n - 1)) + shift, n);
  __syncthreads();
}

template <uint32_t P, bool kRounded, bool kApprox>
__device__ void external_product_mod(uint32_t* x, const uint64_t* acc, int a,
                                     const uint16_t* __restrict__ key,
                                     const uint2* __restrict__ tw, int n,
                                     int log_n) {
  load_digits<P, kRounded>(x, acc, kRows, a, n, log_n);
  product_mod<P, kApprox>(x, key, tw, n, log_n);
}

template <bool kRounded, bool kApprox>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate64_kernel(const uint64_t* __restrict__ acc_in,
                      uint64_t* __restrict__ acc_out,
                      const int32_t* __restrict__ amounts,
                      const uint16_t* __restrict__ khat,
                      const uint2* __restrict__ tw, int n_steps, int n,
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

// What the cluster bodies (rotate_cluster.cuh) take from this kernel: the
// products of ntt64.cuh, and the digits of a step from the accumulator and
// the item's rotation amount of that step.
template <bool kRounded, bool kApprox>
struct Spec : ClusterProduct<kApprox> {
  using Source = const int32_t*;
  using Step = int;
  static __device__ __forceinline__ Step step(Source amounts, size_t item,
                                              int row0, int n, int n_steps,
                                              int j) {
    return amounts[item * n_steps + j];
  }

  template <uint32_t P>
  static __device__ void digits(uint32_t* x, const uint64_t* acc, int rows,
                                int a, int n, int log_n) {
    load_digits<P, kRounded>(x, acc, rows, a, n, log_n);
  }
};

// Bytes of shared memory of the one-block body.
template <bool kApprox>
constexpr size_t smem_bytes(int n) {
  return static_cast<size_t>(kRows) * n * 8 +
         static_cast<size_t>(Planes<kApprox>::kOut) * n * (4 + 2);
}

// Lets the three bodies of a mode use the shared memory of N = 2048.
template <bool kRounded, bool kApprox>
cudaError_t allow_shared_memory() {
  using S = Spec<kRounded, kApprox>;
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate64_kernel<kRounded, kApprox>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<kApprox>(2048)));
  if (err == cudaSuccess) err = rotate_cluster::allow_shared_memory<S, 2>(2048);
  if (err == cudaSuccess) err = rotate_cluster::allow_shared_memory<S, 4>(2048);
  if (err == cudaSuccess) err = rotate_cluster::allow_shared_memory<S, 8>(2048);
  return err;
}

template <bool kRounded, bool kApprox>
int launch(const void* acc_in, void* acc_out, const void* amounts,
           const void* khat, const void* tw, int batch, int n_steps, int n,
           int log_n, int cluster, cudaStream_t stream) {
  using S = Spec<kRounded, kApprox>;
  if (cluster == 2)
    return rotate_cluster::launch<S, 2>(
        acc_in, acc_out, static_cast<const int32_t*>(amounts), khat, tw,
        batch, n_steps, n, log_n, stream);
  if (cluster == 4)
    return rotate_cluster::launch<S, 4>(
        acc_in, acc_out, static_cast<const int32_t*>(amounts), khat, tw,
        batch, n_steps, n, log_n, stream);
  if (cluster == 8)
    return rotate_cluster::launch<S, 8>(
        acc_in, acc_out, static_cast<const int32_t*>(amounts), khat, tw,
        batch, n_steps, n, log_n, stream);
  if (batch == 0) return 0;
  auto kernel = blind_rotate64_kernel<kRounded, kApprox>;
  const size_t smem = smem_bytes<kApprox>(n);
  kernel<<<batch, kThreads, smem, stream>>>(
      static_cast<const uint64_t*>(acc_in), static_cast<uint64_t*>(acc_out),
      static_cast<const int32_t*>(amounts),
      static_cast<const uint16_t*>(khat), static_cast<const uint2*>(tw),
      n_steps, n, log_n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRounded, bool kApprox>
int max_clusters(int n, int cluster) {
  using S = Spec<kRounded, kApprox>;
  return cluster == 2   ? rotate_cluster::max_active_clusters<S, 2>(n)
         : cluster == 4 ? rotate_cluster::max_active_clusters<S, 4>(n)
                        : rotate_cluster::max_active_clusters<S, 8>(n);
}

bool valid(int n, int cluster) {
  return n >= 64 && n <= 2048 && !(n & (n - 1)) &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8);
}

}  // namespace

// Once per device, before the first launch: loads the kernels and lets every
// body of every mode use the shared memory of N = 2048.  Returns a
// cudaError_t.
extern "C" int fhe_blind_rotate64_init() {
  cudaError_t err = allow_shared_memory<false, false>();
  if (err == cudaSuccess) err = allow_shared_memory<true, false>();
  if (err == cudaSuccess) err = allow_shared_memory<false, true>();
  if (err == cudaSuccess) err = allow_shared_memory<true, true>();
  return static_cast<int>(err);
}

// acc_in, acc_out: u64 [batch, 2, n]; amounts: int32 [batch, n_steps];
// khat: u16 [n_steps, 2 primes, 2 digit rows, 16, n]; tw: u32 [2 primes,
// 2 (fwd, inv), n, 2 (twiddle, its Shoup quotient)] (ntt.kernel_twiddles);
// rounded, approx: the mode (0 or 1); cluster: blocks per item, 1, 2, 4 or
// 8.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int fhe_blind_rotate64(const void* acc_in, void* acc_out,
                                  const void* amounts, const void* khat,
                                  const void* tw, int batch, int n_steps,
                                  int n, int rounded, int approx,
                                  int cluster, void* stream) {
  if (!valid(n, cluster) || batch < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rounded && approx)
    return launch<true, true>(acc_in, acc_out, amounts, khat, tw, batch,
                              n_steps, n, log_n, cluster, s);
  if (rounded)
    return launch<true, false>(acc_in, acc_out, amounts, khat, tw, batch,
                               n_steps, n, log_n, cluster, s);
  if (approx)
    return launch<false, true>(acc_in, acc_out, amounts, khat, tw, batch,
                               n_steps, n, log_n, cluster, s);
  return launch<false, false>(acc_in, acc_out, amounts, khat, tw, batch,
                              n_steps, n, log_n, cluster, s);
}

// How many clusters of the body (cluster = 2, 4 or 8) the current device runs
// at once at this n and mode, or minus the cudaError_t.
extern "C" int fhe_blind_rotate64_max_clusters(int n, int rounded, int approx,
                                               int cluster) {
  if (!valid(n, cluster) || cluster == 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (rounded && approx) return max_clusters<true, true>(n, cluster);
  if (rounded) return max_clusters<true, false>(n, cluster);
  if (approx) return max_clusters<false, true>(n, cluster);
  return max_clusters<false, false>(n, cluster);
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
