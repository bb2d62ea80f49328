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
// Design.  Three bodies with the same bits, as blind_rotate64.cu has.  One
// block of 1024 threads per batch item: shared memory at N = 2048 is one
// work buffer of 16 polys (digit-limb hats, then products) u32 128 KB and
// the prime-40961 results u16 64 KB, 192 KB, so one block runs per SM.  Or a
// thread-block cluster of 2 or 4 blocks per item (rotate_cluster.cuh, the
// choreography of blind_rotate64.cu's exact mode run for a single step):
// split by prime, or by prime and output row, the hats and residues
// exchanged through distributed shared memory, so that a batch of a few
// items uses 2 or 4 times as many SMs.  The spec below gives that code its
// digits: the limbs of dl in place of digits made from an accumulator.  The
// result goes straight to device memory, or is added to what is there
// (accumulate: acc += ext in the same launch; every word has one writer).
//
// What bounds it.  As blind_rotate64.cu's exact mode per step: integer
// instructions on the CUDA cores (per prime 22 transforms of length N in
// passes of up to 3 stages, lazy Shoup butterflies; 2.8e6 instructions an
// item at the least); every block reads the step's 256 KB of key hats from
// L2 (a half or a quarter of it in the cluster bodies).  A batch of up to
// 132 items takes one wave of the one-block body; the card runs 66 clusters
// of 2 and 30 of 4 at once.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"
#include "rotate_cluster.cuh"

namespace {

using namespace ntt64;

constexpr int kThreads = 1024;
static_assert(kThreads % 256 == 0, "ntt64.cuh: swizzle_shift");
constexpr int kOut = Planes<false>::kOut;

// `rows` digit rows of an item, given as their limbs src[la * limb_stride +
// r * n + t] (dl from the item's first row on), as residues mod P at
// x[(r * 3 + la) * n + swizzle(t)].
template <uint32_t P>
__device__ void load_limbs(uint32_t* x, const int8_t* __restrict__ src,
                           int rows, size_t limb_stride, int n, int log_n) {
  const int shift = swizzle_shift(threadIdx.x & (n - 1));
  for (int idx = threadIdx.x; idx < kLimbs * rows * n; idx += blockDim.x) {
    const int la = idx / (rows * n);
    const int rt = idx - la * rows * n;  // r * n + t
    const int r = rt >> log_n;
    const int t = rt & (n - 1);
    x[(r * kLimbs + la) * n + t + shift] =
        limb_residue<P>(src[la * limb_stride + rt]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
ntt_ext_kernel(const int8_t* __restrict__ dl,
               const uint16_t* __restrict__ khat,
               const uint2* __restrict__ tw, uint64_t* __restrict__ out,
               int batch, int n, int log_n, bool accumulate) {
  extern __shared__ uint32_t x[];                                 // [kOut][n]
  uint16_t* res0 = reinterpret_cast<uint16_t*>(x + kOut * n);     // [kOut][n]

  const size_t item = blockIdx.x;
  const size_t limb_stride = static_cast<size_t>(batch) * kRows * n;
  const size_t prime_stride = static_cast<size_t>(kRows) * kKeyPolys * n;
  dl += item * kRows * n;
  load_limbs<kP0>(x, dl, kRows, limb_stride, n, log_n);
  product_mod<kP0, false>(x, khat, tw, n, log_n);
  save_residues(res0, x, kOut * n);
  load_limbs<kP1>(x, dl, kRows, limb_stride, n, log_n);
  product_mod<kP1, false>(x, khat + prime_stride, tw + 2 * n, n, log_n);

  uint64_t* dst = out + item * kRows * n;
  const int shift = swizzle_shift(threadIdx.x & (n - 1));
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x)
    dst[idx] = (accumulate ? dst[idx] : 0ull) +
               crt_sum<false>(res0, x, idx >> log_n,
                              (idx & (n - 1)) + shift, n);
}

// What the cluster bodies (rotate_cluster.cuh) take from this kernel: the
// exact mode's products, and digits that are given, not made: the launch's
// source is dl, a step's the limbs of the block's rows of its item.
struct Spec : ClusterProduct<false> {
  struct Source {
    const int8_t* dl;
    int batch;
  };
  struct Step {
    const int8_t* rows;
    size_t limb_stride;
  };
  static __device__ __forceinline__ Step step(Source source, size_t item,
                                              int row0, int n, int n_steps,
                                              int j) {
    return Step{source.dl + (item * kRows + row0) * n,
                static_cast<size_t>(source.batch) * kRows * n};
  }

  template <uint32_t P>
  static __device__ void digits(uint32_t* x, const uint64_t* acc, int rows,
                                const Step& step, int n, int log_n) {
    load_limbs<P>(x, step.rows, rows, step.limb_stride, n, log_n);
  }
};

// A cluster body, a single step: the accumulator starts as out's old value
// (accumulate) or zero, and ends as the result.
template <int kC>
int launch_cluster(const void* dl, const void* khat, const void* tw,
                   void* out, int batch, int n, int log_n, bool accumulate,
                   cudaStream_t stream) {
  return rotate_cluster::launch<Spec, kC>(
      accumulate ? out : nullptr, out,
      Spec::Source{static_cast<const int8_t*>(dl), batch}, khat, tw, batch, 1,
      n, log_n, stream);
}

bool valid(int n, int cluster) {
  return n >= 64 && n <= 2048 && !(n & (n - 1)) &&
         (cluster == 1 || cluster == 2 || cluster == 4);
}

}  // namespace

// Once per device, before the first launch (and before any stream capture):
// loads the kernels and lets every body use the shared memory of N = 2048.
// Returns a cudaError_t.
extern "C" int fhe_ntt_ext_init() {
  cudaError_t err = cudaFuncSetAttribute(
      ntt_ext_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOut * 2048 * (4 + 2));
  if (err == cudaSuccess)
    err = rotate_cluster::allow_shared_memory<Spec, 2>(2048);
  if (err == cudaSuccess)
    err = rotate_cluster::allow_shared_memory<Spec, 4>(2048);
  return static_cast<int>(err);
}

// dl: int8 [3, batch, 2 * n] digit limbs (natural coefficient order);
// khat: u16 [2 primes, 2 digit rows, 16, n] (one step of the
// blind_rotate64 key); tw: u32 [2 primes, 2 (fwd, inv), n, 2 (twiddle, its
// Shoup quotient)] (ntt.kernel_twiddles); out: u64
// [batch, 2, n], set to the product, or with accumulate != 0 increased by
// it (mod 2^64); cluster: blocks per item, 1, 2 or 4.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int fhe_ntt_ext(const void* dl, const void* khat, const void* tw,
                           void* out, int batch, int n, int accumulate,
                           int cluster, void* stream) {
  if (!valid(n, cluster) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 2)
    return launch_cluster<2>(dl, khat, tw, out, batch, n, log_n,
                             accumulate != 0, s);
  if (cluster == 4)
    return launch_cluster<4>(dl, khat, tw, out, batch, n, log_n,
                             accumulate != 0, s);
  const size_t smem = static_cast<size_t>(kOut) * n * (4 + 2);
  if (batch == 0) return 0;
  ntt_ext_kernel<<<batch, kThreads, smem, s>>>(
      static_cast<const int8_t*>(dl), static_cast<const uint16_t*>(khat),
      static_cast<const uint2*>(tw), static_cast<uint64_t*>(out), batch, n,
      log_n, accumulate != 0);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the body (cluster = 2 or 4) the current device runs
// at once at this n, or minus the cudaError_t.
extern "C" int fhe_ntt_ext_max_clusters(int n, int cluster) {
  if (!valid(n, cluster) || cluster == 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  return cluster == 2 ? rotate_cluster::max_active_clusters<Spec, 2>(n)
                      : rotate_cluster::max_active_clusters<Spec, 4>(n);
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
