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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP0 = 40961;
constexpr uint32_t kP1 = 61441;
constexpr uint32_t kM = kP0 * kP1;     // 2,516,684,801 < 2^32
constexpr uint32_t kInvP0 = 3;         // 40961^-1 mod 61441
constexpr int kRows = 2;               // k + 1 (= digit rows R at ell = 1)
constexpr int kBaseLog = 23;
constexpr uint32_t kDigitMask = (1u << kBaseLog) - 1;
constexpr uint32_t kDigitHalf = 1u << (kBaseLog - 1);
constexpr int kLimbs = 3;              // balanced int8 limbs of a digit
constexpr int kDigitPolys = kRows * kLimbs;
constexpr int kKeyPlanes = 8;          // byte limbs of a u64 key value
constexpr int kKeyPolys = kRows * kKeyPlanes;   // per digit row and prime
constexpr int kThreads = 1024;

static_assert(kInvP0 * kP0 % kP1 == 1, "CRT inverse");

// Shift planes s in [kS0, 8) of the mode; kOut product polys per prime.
template <bool kApprox>
struct Planes {
  static constexpr int kS0 = kApprox ? 3 : 0;
  static constexpr int kCount = kKeyPlanes - kS0;
  static constexpr int kOut = kRows * kCount;
  static_assert(kOut >= kDigitPolys, "work buffer holds the digit polys");
};

template <uint32_t P>
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b) {
  return (a * b) % P;  // a, b < P < 2^16
}

template <uint32_t P>
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= P ? s - P : s;
}

template <uint32_t P>
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

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
    uint32_t state;
    if (kRounded) {
      uint32_t rot = round_top(from);
      if (src >= n) rot = (0u - rot) & kDigitMask;
      state = (rot - round_top(acc[idx])) & kDigitMask;
    } else {
      const uint64_t rot = src >= n ? 0ull - from : from;
      const uint64_t diff = rot - acc[idx];
      state = static_cast<uint32_t>((diff >> 41) + ((diff >> 40) & 1ull)) &
              kDigitMask;
    }
    int d = static_cast<int>(state) -
            (state >= kDigitHalf ? static_cast<int>(1u << kBaseLog) : 0);
#pragma unroll
    for (int la = 0; la < kLimbs; ++la) {
      const int limb = ((d + 128) & 255) - 128;
      d = (d - limb) / 256;  // exact: d - limb is a multiple of 256
      x[(r * kLimbs + la) * n + t] =
          limb < 0 ? static_cast<uint32_t>(limb + static_cast<int>(P))
                   : static_cast<uint32_t>(limb);
    }
  }
  __syncthreads();
}

// Forward negacyclic NTT of npoly polys in place: Cooley-Tukey, natural
// order in, bit-reversed out; psi_rev[k] = psi^bitrev(k).
template <uint32_t P>
__device__ void ntt_fwd(uint32_t* x, int npoly, int n, int log_n,
                        const uint32_t* __restrict__ psi_rev) {
  const int half = n >> 1;
  const int total = npoly * half;
  for (int m = 1, log_t = log_n - 1; m < n; m <<= 1, --log_t) {
    const int t = 1 << log_t;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k = idx & (half - 1);
      const int i = k >> log_t;
      uint32_t* a = x + (idx >> (log_n - 1)) * n;
      const int j0 = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j0];
      const uint32_t v = mul_mod<P>(a[j0 + t], __ldg(psi_rev + m + i));
      a[j0] = add_mod<P>(u, v);
      a[j0 + t] = sub_mod<P>(u, v);
    }
    __syncthreads();
  }
}

// Inverse: Gentleman-Sande, bit-reversed in, natural out,
// psi_inv_rev[k] = psi^-bitrev(k); no 1/N scaling (the key carries it).
template <uint32_t P>
__device__ void ntt_inv(uint32_t* x, int npoly, int n, int log_n,
                        const uint32_t* __restrict__ psi_inv_rev) {
  const int half = n >> 1;
  const int total = npoly * half;
  for (int h = half, log_t = 0; h >= 1; h >>= 1, ++log_t) {
    const int t = 1 << log_t;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k = idx & (half - 1);
      const int i = k >> log_t;
      uint32_t* a = x + (idx >> (log_n - 1)) * n;
      const int j0 = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j0];
      const uint32_t v = a[j0 + t];
      a[j0] = add_mod<P>(u, v);
      a[j0 + t] = mul_mod<P>(sub_mod<P>(u, v), __ldg(psi_inv_rev + h + i));
    }
    __syncthreads();
  }
}

// x[col * kCount + s - kS0][h] = sum_r sum_{la + lb = s} x[r * 3 + la][h] *
// key[r][col * 8 + lb][h] mod P, in place: each column h is read and
// written by one thread only.  key: this step's and this prime's hats,
// u16 [R][16][n].
template <uint32_t P, bool kApprox>
__device__ void pointwise(uint32_t* x, const uint16_t* __restrict__ key,
                          int n) {
  using Pl = Planes<kApprox>;
  constexpr int kLb0 = Pl::kS0 > kLimbs - 1 ? Pl::kS0 - (kLimbs - 1) : 0;
  for (int h = threadIdx.x; h < n; h += blockDim.x) {
    uint32_t d[kDigitPolys];
#pragma unroll
    for (int i = 0; i < kDigitPolys; ++i) d[i] = x[i * n + h];
    uint32_t out[Pl::kOut];
#pragma unroll
    for (int o = 0; o < Pl::kOut; ++o) out[o] = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int col = 0; col < kRows; ++col) {
#pragma unroll
        for (int lb = kLb0; lb < kKeyPlanes; ++lb) {
          const uint32_t k =
              __ldg(key + (r * kKeyPolys + col * kKeyPlanes + lb) * n + h);
#pragma unroll
          for (int la = 0; la < kLimbs; ++la) {
            const int s = la + lb;
            if (s >= Pl::kS0 && s < kKeyPlanes)
              out[col * Pl::kCount + s - Pl::kS0] +=
                  mul_mod<P>(d[r * kLimbs + la], k);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < Pl::kOut; ++o) x[o * n + h] = out[o] % P;
  }
  __syncthreads();
}

// acc[r][t] += sum_s W_s << 8s, W_s rebuilt from its residues mod P0
// (res0) and mod P1 (x) by a centered Garner CRT.
template <bool kApprox>
__device__ void crt_accumulate(uint64_t* acc, const uint16_t* res0,
                               const uint32_t* x, int n, int log_n) {
  using Pl = Planes<kApprox>;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x) {
    const int r = idx >> log_n;
    const int t = idx & (n - 1);
    uint64_t sum = 0;
#pragma unroll
    for (int i = 0; i < Pl::kCount; ++i) {
      const int o = (r * Pl::kCount + i) * n + t;
      const uint32_t r0 = res0[o];  // < P0 < P1
      const uint32_t r1 = x[o];
      const uint32_t d = r1 >= r0 ? r1 - r0 : r1 + kP1 - r0;
      const uint32_t x2 = (d * kInvP0) % kP1;
      const uint32_t v = r0 + kP0 * x2;  // the residue pair's value in [0, M)
      const int64_t w = v > kM / 2 ? static_cast<int64_t>(v) - kM
                                   : static_cast<int64_t>(v);
      sum += static_cast<uint64_t>(w) << (8 * (i + Pl::kS0));
    }
    acc[idx] += sum;
  }
  __syncthreads();
}

template <uint32_t P, bool kRounded, bool kApprox>
__device__ void external_product_mod(uint32_t* x, const uint64_t* acc, int a,
                                     const uint16_t* __restrict__ key,
                                     const uint32_t* __restrict__ tw, int n,
                                     int log_n) {
  load_digits<P, kRounded>(x, acc, a, n, log_n);
  ntt_fwd<P>(x, kDigitPolys, n, log_n, tw);
  pointwise<P, kApprox>(x, key, n);
  ntt_inv<P>(x, Planes<kApprox>::kOut, n, log_n, tw + n);
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
    for (int idx = threadIdx.x; idx < kOut * n; idx += blockDim.x)
      res0[idx] = static_cast<uint16_t>(x[idx]);
    __syncthreads();
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
