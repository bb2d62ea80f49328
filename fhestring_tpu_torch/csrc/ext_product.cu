// One step's 64-bit external product by direct negacyclic convolution in
// uint64_t, hand-written for Hopper (sm_90a).
//
// Replaces fhestring_tpu/crypto/kernels/ext_product.py: ext_product_u64 (a
// Pallas TPU kernel).  The Python wrapper and the plain PyTorch version are
// in fhestring_tpu_torch/crypto/kernels/ext_product.py.  Per batch item b,
// output row col and coefficient t:
//
//   ext[b][col][t] = sum_r sum_c d[b][r][c] * K[r][col][t - c]  (mod 2^64)
//
// with d = sum_la 256^la * dl_la the 23-bit digit rebuilt from its 3
// balanced int8 limbs, K = sum_lb 256^lb * limb_lb (mod 2^64) the u64 key
// value rebuilt from its 8 balanced byte limbs, and K[t - c] = -K[t - c + N]
// for c > t (negacyclic).  The TPU kernel multiplies limb by limb on the
// MXU and recombines the shift planes s = la + lb < 8; the terms with
// la + lb >= 8 it drops are multiples of 2^64, so the two give the same
// bits.
//
// Arithmetic.  Each key value is split as K = lo + 2^32 * hi with lo a
// signed int32: then d * K = d * lo + 2^32 * (d * hi) (mod 2^64), one
// 32 x 32 -> 64-bit multiply-add into a uint64_t sum and one 32-bit
// multiply-add into a uint32_t sum (only its value mod 2^32 matters), both
// wrapping without overflow of any signed type.
//
// Design.  A block of 128 threads owns 128 consecutive coefficients t of
// one output row and kItems batch items (1, or 4 once the batch gives the
// card two blocks per SM: grid N/128 x (k+1) x ceil(B/kItems)).  Per digit
// row r it stages in shared memory the key poly of (r, col) doubled with
// its negation, as (lo, hi) pairs [2N], and the items' digits [N][kItems];
// thread t then walks c over [0, N), reading the key at (t - c) mod 2N
// (neighbouring threads, neighbouring words) and the digits of c (one
// broadcast).  Shared memory at N = 2048: 32 KB of key and 8 KB
// (kItems = 1) or 32 KB (kItems = 4) of digits.  On an H100 a body of 8
// items was never the fastest, and one of 2 beat this choice by at most
// 16% (PERF.md).
//
// What bounds it.  The multiply-adds on the CUDA cores: 2 * N * (k+1) * N
// = 1.7e7 u64 products per item and step at N = 2048, two integer
// multiply-adds each.  The NTT kernel (ntt_ext.cu) does some 20x fewer
// operations; tensor cores are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 2;       // k + 1 = digit rows R at ell = 1
constexpr int kLimbs = 3;      // balanced int8 limbs of a digit
constexpr int kKeyPlanes = 8;  // byte limbs of a u64 key value
constexpr int kTile = 128;     // coefficients t per block = threads

template <int kItems>
__global__ void __launch_bounds__(kTile)
ext_product_kernel(const int8_t* __restrict__ dl,
                   const int8_t* __restrict__ key,
                   uint64_t* __restrict__ out, int batch, int n) {
  extern __shared__ int2 smem[];
  int2* kd = smem;                                             // [2n]
  int32_t* dg = reinterpret_cast<int32_t*>(kd + 2 * n);        // [n][kItems]

  const int t = blockIdx.x * kTile + threadIdx.x;
  const int col = blockIdx.y;
  const int b0 = blockIdx.z * kItems;
  const size_t limb_stride = static_cast<size_t>(batch) * kRows * n;

  uint64_t lo_sum[kItems];
  uint32_t hi_sum[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    lo_sum[i] = 0;
    hi_sum[i] = 0;
  }

  for (int r = 0; r < kRows; ++r) {
    const int8_t* kl = key + static_cast<size_t>(r * kRows + col) *
                                 kKeyPlanes * n;
    for (int u = threadIdx.x; u < n; u += kTile) {
      uint64_t v = 0;
#pragma unroll
      for (int lb = 0; lb < kKeyPlanes; ++lb)
        v += static_cast<uint64_t>(static_cast<int64_t>(kl[lb * n + u]))
             << (8 * lb);
      const uint64_t w = 0ull - v;
      const int32_t vlo = static_cast<int32_t>(static_cast<uint32_t>(v));
      const int32_t wlo = static_cast<int32_t>(static_cast<uint32_t>(w));
      kd[u] = make_int2(
          vlo, static_cast<int32_t>(
                   (v - static_cast<uint64_t>(static_cast<int64_t>(vlo))) >>
                   32));
      kd[u + n] = make_int2(
          wlo, static_cast<int32_t>(
                   (w - static_cast<uint64_t>(static_cast<int64_t>(wlo))) >>
                   32));
    }
    for (int idx = threadIdx.x; idx < n * kItems; idx += kTile) {
      const int c = idx / kItems;
      const int b = b0 + idx % kItems;
      int32_t d = 0;
      if (b < batch) {
        const int8_t* src = dl + static_cast<size_t>(b) * kRows * n + r * n + c;
#pragma unroll
        for (int la = 0; la < kLimbs; ++la)
          d += static_cast<int32_t>(src[la * limb_stride]) * (1 << (8 * la));
      }
      dg[idx] = d;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const int2 k = kd[(t - c) & (2 * n - 1)];
      int32_t dv[kItems];
      if constexpr (kItems % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
          const int4 v = reinterpret_cast<const int4*>(dg + c * kItems)[q];
          dv[4 * q] = v.x;
          dv[4 * q + 1] = v.y;
          dv[4 * q + 2] = v.z;
          dv[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kItems; ++i) dv[i] = dg[c * kItems + i];
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        lo_sum[i] += static_cast<uint64_t>(static_cast<int64_t>(dv[i]) *
                                           static_cast<int64_t>(k.x));
        hi_sum[i] += static_cast<uint32_t>(dv[i]) * static_cast<uint32_t>(k.y);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int b = b0 + i;
    if (b < batch)
      out[(static_cast<size_t>(b) * kRows + col) * n + t] =
          lo_sum[i] + (static_cast<uint64_t>(hi_sum[i]) << 32);
  }
}

template <int kItems>
int launch(const void* dl, const void* key, void* out, int batch, int n,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * n) * sizeof(int2) +
                      static_cast<size_t>(n) * kItems * sizeof(int32_t);
  auto kernel = ext_product_kernel<kItems>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kTile, kRows, (batch + kItems - 1) / kItems);
  kernel<<<grid, kTile, smem, stream>>>(static_cast<const int8_t*>(dl),
                                        static_cast<const int8_t*>(key),
                                        static_cast<uint64_t*>(out), batch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dl: int8 [3, batch, 2 * n] digit limbs (natural coefficient order); key:
// int8 [2 digit rows, 2 output rows, 8, n] byte limbs of the step's key
// polys; out: u64 [batch, 2, n].  items: batch items per block, 1 or 4
// (the wrapper's items_per_block).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int fhe_ext_product(const void* dl, const void* key, void* out,
                               int batch, int n, int items, void* stream) {
  if (n < kTile || n > 2048 || (n & (n - 1)) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (items) {
    case 4: return launch<4>(dl, key, out, batch, n, s);
    case 1: return launch<1>(dl, key, out, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
