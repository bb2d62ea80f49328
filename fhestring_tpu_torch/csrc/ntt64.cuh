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
// < 2^16, so every product of two residues is < 2^32: the transforms work
// in 32-bit words, and a plane's 6 products are summed in 64 bits.
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

// A sum of a few products of residues, below 2^36, reduced mod P: the
// products are summed in 64 bits, one multiply-add each, and reduced once.
template <uint32_t P>
__device__ __forceinline__ uint32_t reduce_sum(uint64_t sum) {
  constexpr uint32_t kWord = static_cast<uint32_t>((1ull << 32) % P);
  const uint32_t lo = static_cast<uint32_t>(sum);
  const uint32_t hi = static_cast<uint32_t>(sum >> 32);  // < 16
  return (lo % P + hi * kWord) % P;
}

// y * w mod P up to one P, in [0, 2P), for any y < 2^32: Shoup's product
// by a constant w < P given with its quotient, tw = (w, floor(w 2^32 / P)).
template <uint32_t P>
__device__ __forceinline__ uint32_t mul_shoup(uint32_t y, uint2 tw) {
  return y * tw.x - __umulhi(y, tw.y) * P;
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

// The transforms run several radix-2 stages per pass over shared memory: a
// thread takes E = 2^kS coefficients, a[q << log_u] for q < E, into
// registers, runs the kS stages whose partners lie among them, and writes
// them back, so the 11 stages of N = 2048 cost 4 passes and 4 barriers.
// The pass over the stages of distance 4, 2 and 1 holds 8 neighbouring
// coefficients and moves them as two 16-byte words.
//
// The butterflies are lazy: residues are below 2^16 and words have 32 bits,
// so nothing is reduced between stages.  A twiddle comes with its Shoup
// quotient, and the product of any 32-bit value by it costs three integer
// instructions and lies in [0, 2P).  Forward, u + t and u - t + 2P grow by
// at most 2P a stage (below 23P after 11); inverse, u + v at most doubles a
// stage (below 2^11 P < 2^27) and u - v is offset by a multiple of P that
// bounds v.  The last pass reduces its outputs to [0, P).  All of it is
// exact arithmetic mod P, so the result is that of a stage-by-stage
// transform on reduced values.

template <int E, bool kContig>
__device__ __forceinline__ void load_coeffs(uint32_t (&e)[E],
                                            const uint32_t* a, int log_u) {
  if constexpr (kContig) {
    static_assert(E == 8, "two 16-byte words");
    const uint4 lo = *reinterpret_cast<const uint4*>(a);
    const uint4 hi = *reinterpret_cast<const uint4*>(a + 4);
    e[0] = lo.x, e[1] = lo.y, e[2] = lo.z, e[3] = lo.w;
    e[4] = hi.x, e[5] = hi.y, e[6] = hi.z, e[7] = hi.w;
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q) e[q] = a[q << log_u];
  }
}

template <int E, bool kContig>
__device__ __forceinline__ void store_coeffs(const uint32_t (&e)[E],
                                             uint32_t* a, int log_u) {
  if constexpr (kContig) {
    *reinterpret_cast<uint4*>(a) = make_uint4(e[0], e[1], e[2], e[3]);
    *reinterpret_cast<uint4*>(a + 4) = make_uint4(e[4], e[5], e[6], e[7]);
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q) a[q << log_u] = e[q];
  }
}

// Stages s0 .. s0 + kS - 1 of the forward transform (Cooley-Tukey; stage s
// has 2^s groups, distance n >> (s + 1), twiddle psi_rev[2^s + group]) on
// npoly polys.  The unit distance is that of the pass's last stage,
// 2^log_u; kContig: log_u = 0.
template <uint32_t P, int kS, bool kContig>
__device__ __forceinline__ void fwd_pass(uint32_t* x, int npoly, int log_n,
                                         int s0,
                                         const uint2* __restrict__ psi_rev) {
  constexpr int E = 1 << kS;
  const int log_u = kContig ? 0 : log_n - s0 - kS;
  const int log_items = log_n - kS;  // work items per poly
  const int total = npoly << log_items;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int w = idx & ((1 << log_items) - 1);
    const int i = w >> log_u;  // the group of stage s0
    uint32_t* a = x + ((idx >> log_items) << log_n) + (i << (log_u + kS)) +
                  (w & ((1 << log_u) - 1));
    uint32_t e[E];
    load_coeffs<E, kContig>(e, a, log_u);
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      const int half = E >> (st + 1);  // partner distance, in units
#pragma unroll
      for (int g = 0; g < (1 << st); ++g) {
        const uint2 tw = __ldg(psi_rev + (1 << (s0 + st)) + (i << st) + g);
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const int q = g * 2 * half + k;
          const uint32_t u = e[q];
          const uint32_t v = mul_shoup<P>(e[q + half], tw);
          e[q] = u + v;
          e[q + half] = u - v + 2 * P;
        }
      }
    }
    if constexpr (kContig) {  // the transform's last pass
#pragma unroll
      for (int q = 0; q < E; ++q) e[q] %= P;
    }
    store_coeffs<E, kContig>(e, a, log_u);
  }
  __syncthreads();
}

// kS stages of the inverse transform (Gentleman-Sande; the stage of
// distance t has h = n / 2t groups, twiddle psi_inv_rev[h + group]) of
// distances 2^log_u, 2^(log_u + 1), ... on npoly polys; kLast: the
// transform's last pass.
template <uint32_t P, int kS, bool kContig, bool kLast = false>
__device__ __forceinline__ void inv_pass(
    uint32_t* x, int npoly, int log_n, int log_u_,
    const uint2* __restrict__ psi_inv_rev) {
  constexpr int E = 1 << kS;
  const int log_u = kContig ? 0 : log_u_;
  const int log_items = log_n - kS;
  const int total = npoly << log_items;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int w = idx & ((1 << log_items) - 1);
    const int i = w >> log_u;  // the group of the pass's last stage
    uint32_t* a = x + ((idx >> log_items) << log_n) + (i << (log_u + kS)) +
                  (w & ((1 << log_u) - 1));
    uint32_t e[E];
    load_coeffs<E, kContig>(e, a, log_u);
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      const int half = 1 << st;  // partner distance, in units
      const int h = 1 << (log_n - log_u - st - 1);
      const uint32_t bound = P << (log_u + st);  // above the stage's inputs
#pragma unroll
      for (int g = 0; g < (E >> (st + 1)); ++g) {
        const uint2 tw = __ldg(psi_inv_rev + h + (i << (kS - st - 1)) + g);
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const int q = g * 2 * half + k;
          const uint32_t u = e[q];
          const uint32_t v = e[q + half];
          e[q] = u + v;
          e[q + half] = mul_shoup<P>(u - v + bound, tw);
        }
      }
    }
    if constexpr (kLast) {
#pragma unroll
      for (int q = 0; q < E; ++q) e[q] %= P;
    }
    store_coeffs<E, kContig>(e, a, log_u);
  }
  __syncthreads();
}

// Forward negacyclic NTT of npoly polys in place: Cooley-Tukey, natural
// order in, bit-reversed out; psi_rev[k] = psi^bitrev(k) with its Shoup
// quotient.  n = 2^log_n, log_n >= 6: passes of 3 stages, one of the 1 or 2
// left over, and the pass on neighbouring coefficients.  In and out: [0, P).
template <uint32_t P>
__device__ void ntt_fwd(uint32_t* x, int npoly, int log_n,
                        const uint2* __restrict__ psi_rev) {
  const int last = log_n - 3;  // first stage of the last pass
  int s = 0;
  for (; s + 3 <= last; s += 3)
    fwd_pass<P, 3, false>(x, npoly, log_n, s, psi_rev);
  if (last - s == 2) fwd_pass<P, 2, false>(x, npoly, log_n, s, psi_rev);
  if (last - s == 1) fwd_pass<P, 1, false>(x, npoly, log_n, s, psi_rev);
  fwd_pass<P, 3, true>(x, npoly, log_n, last, psi_rev);
}

// Inverse: Gentleman-Sande, bit-reversed in, natural out,
// psi_inv_rev[k] = psi^-bitrev(k); no 1/N scaling (the key carries it).
// The forward transform's passes in reverse.
template <uint32_t P>
__device__ void ntt_inv(uint32_t* x, int npoly, int log_n,
                        const uint2* __restrict__ psi_inv_rev) {
  inv_pass<P, 3, true>(x, npoly, log_n, 0, psi_inv_rev);
  int log_u = 3;
  const int left = (log_n - 3) % 3;
  if (left == 2) inv_pass<P, 2, false>(x, npoly, log_n, log_u, psi_inv_rev);
  if (left == 1) inv_pass<P, 1, false>(x, npoly, log_n, log_u, psi_inv_rev);
  for (log_u += left; log_u + 3 < log_n; log_u += 3)
    inv_pass<P, 3, false>(x, npoly, log_n, log_u, psi_inv_rev);
  inv_pass<P, 3, false, true>(x, npoly, log_n, log_u, psi_inv_rev);
}

// x[(col - col0) * kCount + s - kS0][h] = sum_r sum_{la + lb = s}
// d_r[la][h] * key[r][col * 8 + lb][h] mod P for the kCols output rows from
// col0, with d0 and d1 the transformed limb polys [3][n] of digit rows 0 and
// 1.  d0 and d1 may lie inside x: each column h is read, then written, by
// one thread only.  key: this step's and this prime's hats, u16 [R][16][n]
// in device memory, or (kStaged) a copy of the kCols rows' polys in shared
// memory, u16 [R][kCols * 8][n] with col0 = 0.
template <uint32_t P, bool kApprox, int kCols, bool kStaged = false>
__device__ void pointwise(uint32_t* x, const uint32_t* d0, const uint32_t* d1,
                          const uint16_t* __restrict__ key, int col0, int n) {
  using Pl = Planes<kApprox>;
  constexpr int kLb0 = Pl::kS0 > kLimbs - 1 ? Pl::kS0 - (kLimbs - 1) : 0;
  constexpr int kRowPolys = kStaged ? kCols * kKeyPlanes : kKeyPolys;
  for (int h = threadIdx.x; h < n; h += blockDim.x) {
    uint32_t d[kDigitPolys];
#pragma unroll
    for (int la = 0; la < kLimbs; ++la) {
      d[la] = d0[la * n + h];
      d[kLimbs + la] = d1[la * n + h];
    }
    uint64_t out[kCols * Pl::kCount];  // each a sum of 6 products < 2^32
#pragma unroll
    for (int o = 0; o < kCols * Pl::kCount; ++o) out[o] = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int lb = kLb0; lb < kKeyPlanes; ++lb) {
          const uint16_t* kp =
              key + (r * kRowPolys + (col0 + c) * kKeyPlanes + lb) * n + h;
          const uint32_t k = kStaged ? *kp : __ldg(kp);
#pragma unroll
          for (int la = 0; la < kLimbs; ++la) {
            const int s = la + lb;
            if (s >= Pl::kS0 && s < kKeyPlanes)
              out[c * Pl::kCount + s - Pl::kS0] +=
                  static_cast<uint64_t>(d[r * kLimbs + la]) * k;
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kCols * Pl::kCount; ++o)
      x[o * n + h] = reduce_sum<P>(out[o]);
  }
  __syncthreads();
}

// The digit-limb polys (x[(r * 3 + la) * n + t] as residues mod P) through
// the forward transforms, the pointwise products and the inverse
// transforms: the product polys of one prime, natural order, in x.
template <uint32_t P, bool kApprox>
__device__ void product_mod(uint32_t* x, const uint16_t* __restrict__ key,
                            const uint2* __restrict__ tw, int n,
                            int log_n) {
  ntt_fwd<P>(x, kDigitPolys, log_n, tw);
  pointwise<P, kApprox, kRows>(x, x, x + kLimbs * n, key, 0, n);
  ntt_inv<P>(x, Planes<kApprox>::kOut, log_n, tw + n);
}

// The value in [0, M) with residues r0 mod P0 and r1 mod P1 (Garner).
__device__ __forceinline__ uint32_t crt_value(uint32_t r0, uint32_t r1) {
  const uint32_t d = r1 >= r0 ? r1 - r0 : r1 + kP1 - r0;  // r0 < P0 < P1
  return r0 + kP0 * ((d * kInvP0) % kP1);
}

// The integer W, |W| < M/2, with those residues: the centered CRT.
__device__ __forceinline__ int64_t crt_centered(uint32_t r0, uint32_t r1) {
  const uint32_t v = crt_value(r0, r1);
  return v > kM / 2 ? static_cast<int64_t>(v) - kM : static_cast<int64_t>(v);
}

// sum_s W_s << 8s (mod 2^64) of output row r, coefficient t: each W_s
// rebuilt from its residues mod P0 (res0) and mod P1 (res1), u16 or u32
// polys [rows * kCount][n].
template <bool kApprox, class T0, class T1>
__device__ __forceinline__ uint64_t crt_sum(const T0* res0, const T1* res1,
                                            int r, int t, int n) {
  using Pl = Planes<kApprox>;
  uint64_t sum = 0;
#pragma unroll
  for (int i = 0; i < Pl::kCount; ++i) {
    const int o = (r * Pl::kCount + i) * n + t;
    sum += static_cast<uint64_t>(crt_centered(res0[o], res1[o]))
           << (8 * (i + Pl::kS0));
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
