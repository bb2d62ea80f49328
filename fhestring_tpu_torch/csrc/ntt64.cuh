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

// The layout of every buffer the transforms work on.  Coefficient t of a
// poly lies at word swizzle(t) of it: inside each row of 32 words (one word
// in each shared-memory bank) bits 2-4 of t are XORed with a key made from
// bits 5-7, the row's place r among 8: bank b of the row holds coefficient
// b ^ key(r), key(r) = 4 r ^ 24 r0 (bit 2 of the key is r0, bit 3 r0 ^ r1,
// bit 4 r0 ^ r2).  So every warp-wide access of a pass is conflict-free
// (tests/test_torch_ntt_banks.py holds each pass of each n to it): where a
// warp's threads read the same place in 2 or 4 rows (a pass whose unit
// distance is 8 or 16 words), the rows' keys send them to different banks,
// and in the pass on neighbouring coefficients the 16-byte words of threads
// t and t + 4 land in different halves of the 32 banks.
// The key is linear, so swizzle(a ^ b) = swizzle(a) ^ swizzle(b), and it
// moves no word out of its row or out of its aligned group of 4: a thread
// that reads or writes elementwise, one word a coefficient, stays
// conflict-free, and a copy of whole buffers keeps the layout.  The
// transforms never see it: a reader or writer of coefficient t goes to
// swizzle(t), the accumulator stays in natural order, and the key hats are
// read from device memory at t.
__host__ __device__ __forceinline__ constexpr int swizzle(int t) {
  const int r4 = (t >> 3) & 28;
  return t ^ r4 ^ ((r4 & 4) * 6);
}

// Every body runs 512 or 1024 threads, a multiple of 256, and its loops walk
// indices threadIdx.x, + blockDim.x, ...: bits 0-7 of the index never change
// along a thread's walk, and swizzle(t) - t depends on bits 2-7 of t alone.
// So a thread finds the swizzle once, at the first coefficient t0 it meets,
// and adds swizzle_shift(t0) to every coefficient of its walk.
__device__ __forceinline__ int swizzle_shift(int t0) {
  return swizzle(t0) - t0;
}

// The transforms run several radix-2 stages per pass over shared memory: a
// thread takes E = 2^kS coefficients, a[q << log_u] for q < E, into
// registers, runs the kS stages whose partners lie among them, and writes
// them back, so the 11 stages of N = 2048 cost 4 passes and 4 barriers.
// The pass over the stages of distance 4, 2 and 1 holds 8 neighbouring
// coefficients and moves them as two 16-byte words.  A poly gives a pass
// n >> kS work items, and a warp's threads all stay inside one poly while
// there are at least 32 of them: in a warp that spans polys, the threads of
// each poly would read the same places, and no layout of a poly could part
// them.  So a pass takes at most log_n - 5 stages (splits below).
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
//
// What bounds the passes: integer instructions, since no access has a bank
// conflict.  tools/step_breakdown, K2's one-block body at B = 8 on an
// H100, ms a stage of the step's transforms: the passes of 3 stages 1.92,
// the pass of distances 16 and 8 2.25 (3.84 in the natural layout, where it
// read the same 8 banks of 4 rows), the pass on neighbouring coefficients
// 2.34 (2.76 with threads t and t + 4 on the same banks).  The pass of 2
// stages does fewer stages a load and a store, and the neighbour pass
// reduces mod P.

// The word at byte offset b of x.
__device__ __forceinline__ uint32_t& word(uint32_t* x, int b) {
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(x) + b);
}

// Coefficient q of a work item lies at byte b ^ off[q] of x, with b that of
// its first coefficient and off[q] = 4 swizzle(q << log_u): one XOR an
// access, where the natural layout adds an offset.
template <int E, bool kContig>
__device__ __forceinline__ void load_coeffs(uint32_t (&e)[E], uint32_t* x,
                                            int b, const int (&off)[E]) {
  if constexpr (kContig) {
    static_assert(E == 8, "two 16-byte words");
    const uint4 lo = reinterpret_cast<const uint4&>(word(x, b));
    const uint4 hi = reinterpret_cast<const uint4&>(word(x, b ^ 16));
    e[0] = lo.x, e[1] = lo.y, e[2] = lo.z, e[3] = lo.w;
    e[4] = hi.x, e[5] = hi.y, e[6] = hi.z, e[7] = hi.w;
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q) e[q] = word(x, b ^ off[q]);
  }
}

template <int E, bool kContig>
__device__ __forceinline__ void store_coeffs(const uint32_t (&e)[E],
                                             uint32_t* x, int b,
                                             const int (&off)[E]) {
  if constexpr (kContig) {
    reinterpret_cast<uint4&>(word(x, b)) = make_uint4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<uint4&>(word(x, b ^ 16)) =
        make_uint4(e[4], e[5], e[6], e[7]);
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q) word(x, b ^ off[q]) = e[q];
  }
}

// off[log_u][q] = 4 swizzle(q << log_u): the byte offsets of the 8
// coefficients of a work item from its first at unit distance 2^log_u
// (log_u <= 8 at n <= 2048), read by a pass once, from constant memory.
struct UnitOffsets {
  int off[9][8];
};

constexpr UnitOffsets unit_offsets_table() {
  UnitOffsets table{};
  for (int log_u = 0; log_u < 9; ++log_u)
    for (int q = 0; q < 8; ++q)
      table.off[log_u][q] = 4 * swizzle(q << log_u);
  return table;
}

__constant__ UnitOffsets kUnitOffsets = unit_offsets_table();

template <int E>
__device__ __forceinline__ void unit_offsets(int (&off)[E], int log_u) {
#pragma unroll
  for (int q = 0; q < E; ++q) off[q] = kUnitOffsets.off[log_u][q];
}

// The first coefficient of work item w of a poly: its group of the pass,
// w >> log_u, and its place in the group.
template <int kS>
__device__ __forceinline__ int first_coeff(int w, int log_u) {
  return ((w >> log_u) << (log_u + kS)) + (w & ((1 << log_u) - 1));
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
  int off[E];
  unit_offsets(off, log_u);
  const int shift = swizzle_shift(
      first_coeff<kS>(threadIdx.x & ((1 << log_items) - 1), log_u));
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int w = idx & ((1 << log_items) - 1);
    const int i = w >> log_u;  // the group of stage s0
    const int b = 4 * (((idx >> log_items) << log_n) +
                       first_coeff<kS>(w, log_u) + shift);
    uint32_t e[E];
    load_coeffs<E, kContig>(e, x, b, off);
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
    store_coeffs<E, kContig>(e, x, b, off);
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
  int off[E];
  unit_offsets(off, log_u);
  const int shift = swizzle_shift(
      first_coeff<kS>(threadIdx.x & ((1 << log_items) - 1), log_u));
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int w = idx & ((1 << log_items) - 1);
    const int i = w >> log_u;  // the group of the pass's last stage
    const int b = 4 * (((idx >> log_items) << log_n) +
                       first_coeff<kS>(w, log_u) + shift);
    uint32_t e[E];
    load_coeffs<E, kContig>(e, x, b, off);
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
    store_coeffs<E, kContig>(e, x, b, off);
  }
  __syncthreads();
}

// How the stages of distance 8 and above are split into passes: as many of
// 3 stages as fit, then one of the 2 or 1 left over; at n = 128 two of 2 and
// at n = 64 three of 1, so that a warp stays inside a poly.  Forward the
// passes run in this order, inverse in the reverse order.
struct Splits {
  int threes, twos, ones;
};

__device__ __forceinline__ Splits splits(int log_n) {
  const int stages = log_n - 3;
  const int most = log_n - 5 < 3 ? log_n - 5 : 3;
  const int threes = most == 3 ? stages / 3 : 0;
  const int twos = most >= 2 ? (stages - 3 * threes) / 2 : 0;
  return {threes, twos, stages - 3 * threes - 2 * twos};
}

// Forward negacyclic NTT of npoly polys in place: Cooley-Tukey, natural
// order in, bit-reversed out; psi_rev[k] = psi^bitrev(k) with its Shoup
// quotient.  n = 2^log_n, log_n >= 6: the passes of splits() and the pass
// on neighbouring coefficients.  In and out: [0, P).
template <uint32_t P>
__device__ void ntt_fwd(uint32_t* x, int npoly, int log_n,
                        const uint2* __restrict__ psi_rev) {
  const Splits sp = splits(log_n);
  int s = 0;
  for (int k = 0; k < sp.threes; ++k, s += 3)
    fwd_pass<P, 3, false>(x, npoly, log_n, s, psi_rev);
  for (int k = 0; k < sp.twos; ++k, s += 2)
    fwd_pass<P, 2, false>(x, npoly, log_n, s, psi_rev);
  for (int k = 0; k < sp.ones; ++k, s += 1)
    fwd_pass<P, 1, false>(x, npoly, log_n, s, psi_rev);
  fwd_pass<P, 3, true>(x, npoly, log_n, s, psi_rev);
}

// Inverse: Gentleman-Sande, bit-reversed in, natural out,
// psi_inv_rev[k] = psi^-bitrev(k); no 1/N scaling (the key carries it).
// The forward transform's passes in reverse; the last, of 3 stages from
// n = 256 on, reduces its outputs (below, a pass of its own does).
template <uint32_t P>
__device__ void ntt_inv(uint32_t* x, int npoly, int log_n,
                        const uint2* __restrict__ psi_inv_rev) {
  const Splits sp = splits(log_n);
  inv_pass<P, 3, true>(x, npoly, log_n, 0, psi_inv_rev);
  int log_u = 3;
  for (int k = 0; k < sp.ones; ++k, log_u += 1)
    inv_pass<P, 1, false>(x, npoly, log_n, log_u, psi_inv_rev);
  for (int k = 0; k < sp.twos; ++k, log_u += 2)
    inv_pass<P, 2, false>(x, npoly, log_n, log_u, psi_inv_rev);
  if (sp.threes == 0) {
    for (int idx = threadIdx.x; idx < npoly << log_n; idx += blockDim.x)
      x[idx] %= P;
    __syncthreads();
    return;
  }
  for (int k = 1; k < sp.threes; ++k, log_u += 3)
    inv_pass<P, 3, false>(x, npoly, log_n, log_u, psi_inv_rev);
  inv_pass<P, 3, false, true>(x, npoly, log_n, log_u, psi_inv_rev);
}

// x[(col - col0) * (kS1 - kS0) + s - kS0][h] = sum_r sum_{la + lb = s}
// d_r[la][h] * key[r][col * 8 + lb][h] mod P for the shift planes s in
// [kS0, kS1) of the kCols output rows from col0, with d0 and d1 the
// transformed limb polys [3][n] of digit rows 0 and 1 (x, d0 and d1
// swizzled, the key not).  d0 and d1 may lie inside x: each column is read,
// then written, by one thread only.  key: this step's and this prime's hats,
// u16 [R][16][n] in device memory, or (kStaged) a copy in shared memory of
// the limbs lb of each of the kCols rows from kStagedLb0 on, kStagedLimbs of
// them, u16 [R][kCols * kStagedLimbs][n], with col0 = 0.
template <uint32_t P, int kS0, int kS1, int kCols, bool kStaged,
          int kStagedLb0 = 0, int kStagedLimbs = kKeyPlanes>
__device__ void pointwise_planes(uint32_t* x, const uint32_t* d0,
                                 const uint32_t* d1,
                                 const uint16_t* __restrict__ key, int col0,
                                 int n) {
  constexpr int kCount = kS1 - kS0;
  constexpr int kLb0 = kS0 > kLimbs - 1 ? kS0 - (kLimbs - 1) : 0;
  constexpr int kLb1 = kS1 < kKeyPlanes ? kS1 : kKeyPlanes;
  constexpr int kColPolys = kStaged ? kStagedLimbs : kKeyPlanes;
  constexpr int kRowPolys = kStaged ? kCols * kStagedLimbs : kKeyPolys;
  constexpr int kFirst = kStaged ? kStagedLb0 : 0;
  static_assert(kFirst <= kLb0 && kLb1 <= kFirst + kColPolys,
                "the staged limbs hold every limb the planes read");
  const int shift = swizzle_shift(threadIdx.x & (n - 1));
  for (int h = threadIdx.x; h < n; h += blockDim.x) {
    uint32_t d[kDigitPolys];
    const int at = h + shift;
#pragma unroll
    for (int la = 0; la < kLimbs; ++la) {
      d[la] = d0[la * n + at];
      d[kLimbs + la] = d1[la * n + at];
    }
    uint64_t out[kCols * kCount];  // each a sum of 6 products < 2^32
#pragma unroll
    for (int o = 0; o < kCols * kCount; ++o) out[o] = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int lb = kLb0; lb < kLb1; ++lb) {
          const uint16_t* kp =
              key + (r * kRowPolys + (col0 + c) * kColPolys + lb - kFirst) *
                        n + h;
          const uint32_t k = kStaged ? *kp : __ldg(kp);
#pragma unroll
          for (int la = 0; la < kLimbs; ++la) {
            const int s = la + lb;
            if (s >= kS0 && s < kS1)
              out[c * kCount + s - kS0] +=
                  static_cast<uint64_t>(d[r * kLimbs + la]) * k;
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kCols * kCount; ++o)
      x[o * n + at] = reduce_sum<P>(out[o]);
  }
  __syncthreads();
}

// Every shift plane of the mode: x[(col - col0) * kCount + s - kS0][h], as
// pointwise_planes; the staged key holds all 8 limbs of each of the kCols
// rows, u16 [R][kCols * 8][n].
template <uint32_t P, bool kApprox, int kCols, bool kStaged = false>
__device__ void pointwise(uint32_t* x, const uint32_t* d0, const uint32_t* d1,
                          const uint16_t* __restrict__ key, int col0, int n) {
  pointwise_planes<P, Planes<kApprox>::kS0, kKeyPlanes, kCols, kStaged>(
      x, d0, d1, key, col0, n);
}

// The digit-limb polys (x[(r * 3 + la) * n + swizzle(t)] as residues mod P)
// through the forward transforms, the pointwise products and the inverse
// transforms: the product polys of one prime, in coefficient order and
// swizzled, in x.
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
// polys [rows * kCount][n], swizzled: coefficient t at word at = swizzle(t)
// of each poly.
template <bool kApprox, class T0, class T1>
__device__ __forceinline__ uint64_t crt_sum(const T0* res0, const T1* res1,
                                            int r, int at, int n) {
  using Pl = Planes<kApprox>;
  uint64_t sum = 0;
#pragma unroll
  for (int i = 0; i < Pl::kCount; ++i) {
    const int o = (r * Pl::kCount + i) * n + at;
    sum += static_cast<uint64_t>(crt_centered(res0[o], res1[o]))
           << (8 * (i + Pl::kS0));
  }
  return sum;
}

// Keep the prime-P0 results (< 2^16) while x is reused for prime P1, in
// x's layout.
__device__ __forceinline__ void save_residues(uint16_t* res0,
                                              const uint32_t* x, int count) {
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x)
    res0[idx] = static_cast<uint16_t>(x[idx]);
  __syncthreads();
}

// What a thread-block-cluster body (rotate_cluster.cuh) takes from the
// 64-bit kernels, but for the source of the digits: the accumulator's word,
// the pointwise products, the CRT, and how one output row's key polys of a
// step and prime lie in the key (2 runs of 8 polys).  blind_rotate64.cu and
// ntt_ext.cu each add their digits.
template <bool kApprox>
struct ClusterProduct {
  using Acc = uint64_t;
  static constexpr int kCount = Planes<kApprox>::kCount;
  static constexpr int kKeyPolys = kRows * ntt64::kKeyPolys;

  template <uint32_t P, int kCols>
  static __device__ void pointwise(uint32_t* x, const uint32_t* d0,
                                   const uint32_t* d1,
                                   const uint16_t* __restrict__ key, int col0,
                                   int n) {
    ntt64::pointwise<P, kApprox, kCols>(x, d0, d1, key, col0, n);
  }

  static constexpr int kStageRuns = kRows;
  static constexpr int kStageRunPolys = kKeyPlanes;
  static constexpr int kStageRunStride = ntt64::kKeyPolys;

  template <uint32_t P>
  static __device__ void pointwise_staged(uint32_t* x, const uint32_t* d0,
                                          const uint32_t* d1,
                                          const uint16_t* staged, int n) {
    ntt64::pointwise<P, kApprox, 1, true>(x, d0, d1, staged, 0, n);
  }

  // The 8-block body (rotate_cluster.cuh) splits an output row's planes
  // between two blocks: half 0 the first ceil(kCount / 2), half 1 the rest
  // (approx 3 + 2, exact 4 + 4).  Plane s = la + lb reads key limbs
  // lb in [s - 2, s], so a half's planes [kS0, kS1) read the limbs from
  // max(kS0 - 2, 0) to kS1 - 1: its run of each digit row, which overlaps
  // the other half's by 2 limbs.
  template <int kHalf>
  struct Half {
    static constexpr int kFirst = kHalf == 0 ? 0 : (kCount + 1) / 2;
    static constexpr int kPlanes = kHalf == 0 ? (kCount + 1) / 2 : kCount / 2;
    static constexpr int kS0 = Planes<kApprox>::kS0 + kFirst;
    static constexpr int kS1 = kS0 + kPlanes;
    static constexpr int kRunFirst = kS0 > kLimbs - 1 ? kS0 - (kLimbs - 1) : 0;
    static constexpr int kRunPolys = kS1 - kRunFirst;
  };

  template <uint32_t P, int kHalf>
  static __device__ void pointwise_half(uint32_t* x, const uint32_t* d0,
                                        const uint32_t* d1,
                                        const uint16_t* staged, int n) {
    using H = Half<kHalf>;
    ntt64::pointwise_planes<P, H::kS0, H::kS1, 1, true, H::kRunFirst,
                            H::kRunPolys>(x, d0, d1, staged, 0, n);
  }

  template <class T0, class T1>
  static __device__ __forceinline__ uint64_t crt_sum(const T0* res0,
                                                     const T1* res1, int r,
                                                     int at, int n) {
    return ntt64::crt_sum<kApprox>(res0, res1, r, at, n);
  }
};

}  // namespace ntt64
