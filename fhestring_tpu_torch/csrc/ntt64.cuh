// Device code shared by the 64-bit-torus external products: the whole
// blind rotation (blind_rotate64.cu) and one step of it (ntt_ext.cu); the
// digit rule also by the per-step prologue (rotate_decompose.cu).
//
// The two-prime negacyclic NTT on the CUDA cores: forward transforms of the
// 3 balanced int8 limbs of each 23-bit digit (R = 2 digit rows, 6 polys),
// pointwise products against the step's key hats (the 8 balanced byte limbs
// lb of each u64 key value, u16 residues with 1/N folded in), one product
// poly per output row and shift plane s = la + lb < 8, inverse transforms,
// and the centered two-prime CRT of each plane W_s.
//
// Exactness.  |W_s| <= 3 (la, lb) pairs * R * N * 128 * 128 = 2.01e8 at
// R = 2 and N = 2048, below M/2 = 1.26e9 with M = 40961 * 61441 =
// 2,516,684,801, so the centered CRT returns W_s itself.  Residues are
// < 2^16, so every product of two residues is < 2^32 and a sum of 6 reduced
// products is < 2^19: 32-bit arithmetic in the transforms.
//
// Every function here is block-wide: the block's threads split the work and
// the function ends with __syncthreads().

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ntt64 {

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

// A 23-bit digit state centred into [-2^22, 2^22).
__device__ __forceinline__ int centered_digit(uint32_t state) {
  return static_cast<int>(state) -
         (state >= kDigitHalf ? static_cast<int>(1u << kBaseLog) : 0);
}

// The exact-mode digit of a u64 torus difference, numpy_ref.decompose(diff,
// 23, 1): round(diff >> 41) mod 2^23, centred.
__device__ __forceinline__ int exact_digit(uint64_t diff) {
  return centered_digit(
      static_cast<uint32_t>((diff >> 41) + ((diff >> 40) & 1ull)) &
      kDigitMask);
}

// The 3 balanced int8 limbs of a digit, as pbs.balanced_limbs_i32:
// d = sum_la 256^la * limb[la], each limb in [-128, 128).
__device__ __forceinline__ void digit_limbs(int d, int (&limb)[kLimbs]) {
#pragma unroll
  for (int la = 0; la < kLimbs; ++la) {
    limb[la] = ((d + 128) & 255) - 128;
    d = (d - limb[la]) / 256;  // exact: d - limb is a multiple of 256
  }
}

// A balanced limb in [-128, 128) as a residue mod P.
template <uint32_t P>
__device__ __forceinline__ uint32_t limb_residue(int limb) {
  return limb < 0 ? static_cast<uint32_t>(limb + static_cast<int>(P))
                  : static_cast<uint32_t>(limb);
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

// The digit-limb polys (x[(r * 3 + la) * n + t] as residues mod P) through
// the forward transforms, the pointwise products and the inverse
// transforms: the product polys of one prime, natural order, in x.
template <uint32_t P, bool kApprox>
__device__ void product_mod(uint32_t* x, const uint16_t* __restrict__ key,
                            const uint32_t* __restrict__ tw, int n,
                            int log_n) {
  ntt_fwd<P>(x, kDigitPolys, n, log_n, tw);
  pointwise<P, kApprox>(x, key, n);
  ntt_inv<P>(x, Planes<kApprox>::kOut, n, log_n, tw + n);
}

// sum_s W_s << 8s (mod 2^64) of output row r, coefficient t: each W_s
// rebuilt from its residues mod P0 (res0) and mod P1 (x) by a centered
// Garner CRT.
template <bool kApprox>
__device__ __forceinline__ uint64_t crt_sum(const uint16_t* res0,
                                            const uint32_t* x, int r, int t,
                                            int n) {
  using Pl = Planes<kApprox>;
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
  return sum;
}

// Keep the prime-P0 results (< 2^16) while x is reused for prime P1.
__device__ __forceinline__ void save_residues(uint16_t* res0,
                                              const uint32_t* x, int count) {
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x)
    res0[idx] = static_cast<uint16_t>(x[idx]);
  __syncthreads();
}

}  // namespace ntt64
