// One batch item's whole blind rotation on a thread-block cluster: the
// bodies of blind_rotate32.cu and blind_rotate64.cu that spread an item over
// 2, 4 or 8 SMs of a Hopper card, so that a batch of a few items still uses
// most of it.
//
// A step of the rotation splits with little communication.  The two primes
// are independent until the CRT, the k+1 = 2 output rows are independent
// after the forward transforms, and so are an output row's product planes
// until the CRT.  A cluster of kC blocks, rank = prime + 2 * row + 4 * half,
// runs one item:
//
//   kC = 2  block p makes the digits once, runs prime p's 6 forward
//           transforms, the pointwise products against prime p's half of
//           the key and the inverse transforms, and stores its residues as
//           u16 into the other block's shared memory.  Both blocks then run
//           the CRT and update their own copy of the accumulator.
//   kC = 4  block (p, r) keeps accumulator row r only.  It makes row r's 3
//           digit polys, transforms them mod prime p, stores the 3 hats into
//           block (p, 1 - r), multiplies all 6 hats against the key slice of
//           prime p and output row r, inverse-transforms row r's product
//           planes, stores their residues into block (1 - p, r), and both
//           run row r's CRT.
//   kC = 8  block (p, r, h) keeps accumulator row r, as the 4-block body's
//           block (p, r) does, and runs half h of row r's product planes
//           (S::Half: K2 approx 3 + 2, exact 4 + 4, K1 2 + 2).  It makes row
//           r's 3 digit polys and transforms mod prime p those of its half
//           (first_limb: half 0 limb 0, half 1 limbs 1 and 2), and stores
//           the hats into the hat buffers, [2 rows][3 limbs], of the four
//           blocks of prime p, itself included: (p, r, h), (p, 1 - r, h),
//           (p, r, 1 - h), (p, 1 - r, 1 - h).  Then it multiplies all 6 hats
//           against the key polys its planes read, inverse-transforms its
//           planes, and stores their residues as u16 into the residue
//           buffers, [2 primes][all planes of the row], of the four blocks
//           of row r, itself included: (p, r, h), (1 - p, r, h),
//           (p, r, 1 - h), (1 - p, r, 1 - h).  All four then run the whole
//           CRT of row r from those buffers and update their own copy of it.
//
// So a block runs a half (kC = 2), a quarter (kC = 4) or an eighth (kC = 8,
// give or take a transform) of the step's transforms and reads that share
// of the step's key (kC = 8: a little more, the key limbs its planes read).
// The result is bit-identical to the one-block schedule: the same integers
// are summed, only on other SMs.
//
// Ordering of distributed shared memory.  A block only ever stores into a
// peer, into buffers that the peer reads but never writes (hin: the other
// row's hats, at kC = 8 the other half's too; res: the other prime's
// residues, at kC = 8 the other half's too).  Two cluster barriers a step
// order every store against the peer's reads:
//
//   kC = 4  H (after the hat stores, before the pointwise products) and R
//   and 8   (after the residue stores, before the CRT).  A peer stores hats
//           of step j + 1 only after R of step j, which this block reaches
//           after it read hin in step j's pointwise products; it stores
//           residues of step j + 1 only after H of step j + 1, which this
//           block reaches after step j's CRT.  Both barriers hold the whole
//           cluster, so the argument does not depend on which peer stores:
//           at kC = 8 three peers store into hin and three into res, each
//           between the same two barriers as at kC = 4; every place of a
//           buffer has one writer a step; and a block's stores into its own
//           hin and res come after its own reads of them a step before (the
//           pointwise products, the CRT), in program order.  So kC = 8 needs
//           no barrier more than kC = 4.
//   kC = 2  R as above, and a barrier split into its arrive (after the CRT)
//           and its wait (before the next residue stores), so its latency
//           hides behind the next step's transforms.
//
// A barrier before the first step holds every block of the cluster to have
// started before a peer's shared memory is written.  After the last R no
// block stores into a peer, so a block may exit as soon as it is done.
//
// The kernel-specific parts come from a spec S:
//   S::Acc         the accumulator's word (uint32_t or uint64_t);
//   S::kCount      product planes per output row;
//   S::kKeyPolys   key polys per step and prime;
//   S::Source      what the digits of a launch are made from, a kernel
//                  argument: the rotation amounts (blind_rotate32.cu,
//                  blind_rotate64.cu) or the digit limbs given (ntt_ext.cu,
//                  which runs a single step);
//   S::Step        the same for one item, first row and step:
//                  S::step(source, item, row0, n, n_steps, j);
//   S::digits<P>(x, acc, rows, step, n, log_n)   the limb polys of `rows`
//                  accumulator rows as residues mod P at x[(r * 3 + l) * n
//                  + swizzle(t)], block-wide;
//   S::pointwise<P, kCols>(x, d0, d1, key, col0, n)   the product polys of
//                  kCols output rows from col0 at x[(c * kCount + i) * n +
//                  swizzle(h)], block-wide; d0, d1: the hats of digit rows 0
//                  and 1;
//   S::crt_sum(res0, res1, r, at, n)   sum_s W_s << 8s of local row r,
//                  coefficient t, from the residues mod P0 and mod P1 at
//                  word at = swizzle(t) of each poly (ntt64.cuh's swizzle is
//                  the layout of x, of the hats and of the residues: the
//                  copies between blocks move whole words and keep it);
//   S::kStageRuns, kStageRunPolys, kStageRunStride   one output row's key
//                  polys of a step and prime: that many runs of that many
//                  polys, that many polys apart, the row's first at
//                  row * kStageRunPolys;
//   S::pointwise_staged<P>(x, d0, d1, staged, n)   pointwise<P, 1> on a copy
//                  of those runs, packed, in shared memory;
//   kC = 8 only (blind_rotate32.cu, blind_rotate64.cu):
//   S::Half<h>     half h's planes of an output row, kPlanes of them from
//                  the row's plane kFirst, and the key polys they read:
//                  kRunPolys of each run from its poly kRunFirst;
//   S::pointwise_half<P, h>(x, d0, d1, staged, n)   those planes at
//                  x[i * n + swizzle(h)], from a copy of those key polys,
//                  packed, in shared memory.
//
// The 4- and 8-block bodies hold their slice of a step's key in shared
// memory: one thread starts bulk copies (cp.async.bulk, completion on an
// mbarrier) of step j + 1's slice as soon as step j's pointwise products
// are done, so the slice lands while the inverse transforms, the CRT and
// the next forward transforms run, and the products read shared memory,
// not L2.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt64.cuh"

namespace rotate_cluster {

namespace cg = cooperative_groups;

using ntt64::kLimbs;
using ntt64::kP0;
using ntt64::kP1;
using ntt64::kRows;

constexpr int kThreads = 1024;
static_assert(kThreads % 256 == 0, "ntt64.cuh: swizzle_shift");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// An mbarrier in shared memory, for the bulk copies of the key.
__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   shared_address(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: start the bulk copies of the block's key slice of one step
// and prime (S::kStageRuns runs of kRunPolys polys from `key`,
// S::kStageRunStride polys apart) into `staged`; the barrier completes when
// all their bytes have landed.
template <class S, int kRunPolys = S::kStageRunPolys>
__device__ __forceinline__ void stage_key(uint16_t* staged,
                                          const uint16_t* key, uint64_t* bar,
                                          int n) {
  const uint32_t run_bytes = kRunPolys * n * 2;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(S::kStageRuns * run_bytes)
               : "memory");
  for (int run = 0; run < S::kStageRuns; ++run)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(
            shared_address(staged + run * kRunPolys * n)),
        "l"(key + static_cast<size_t>(run) * S::kStageRunStride * n),
        "r"(run_bytes), "r"(shared_address(bar))
        : "memory");
}

// The product planes, inverse transforms and key polys of a run that a
// block of an output row runs: the row's all (kC = 2 and 4), half h's
// (kC = 8).
template <class S, int kC>
struct Share {
  static constexpr int kPlanes = S::kCount;  // the most over the blocks
  static constexpr int kRunPolys = S::kStageRunPolys;
  static __device__ __forceinline__ int planes(int) { return kPlanes; }
  static __device__ __forceinline__ int run_first(int) { return 0; }

  template <uint32_t P>
  static __device__ __forceinline__ void pointwise(uint32_t* x,
                                                   const uint32_t* d0,
                                                   const uint32_t* d1,
                                                   const uint16_t* staged,
                                                   int n, int) {
    S::template pointwise_staged<P>(x, d0, d1, staged, n);
  }

  static __device__ __forceinline__ void stage(uint16_t* staged,
                                               const uint16_t* key,
                                               uint64_t* bar, int n, int) {
    stage_key<S>(staged, key, bar, n);
  }
};

template <class S>
struct Share<S, 8> {
  using H0 = typename S::template Half<0>;
  using H1 = typename S::template Half<1>;
  static_assert(H0::kFirst == 0 && H1::kFirst == H0::kPlanes &&
                    H0::kPlanes + H1::kPlanes == S::kCount,
                "the halves split the row's planes");
  static constexpr int kPlanes =
      H0::kPlanes > H1::kPlanes ? H0::kPlanes : H1::kPlanes;
  static constexpr int kRunPolys =
      H0::kRunPolys > H1::kRunPolys ? H0::kRunPolys : H1::kRunPolys;
  static __device__ __forceinline__ int planes(int half) {
    return half ? H1::kPlanes : H0::kPlanes;
  }
  static __device__ __forceinline__ int first(int half) {
    return half ? H1::kFirst : H0::kFirst;
  }
  static __device__ __forceinline__ int run_first(int half) {
    return half ? H1::kRunFirst : H0::kRunFirst;
  }

  template <uint32_t P>
  static __device__ __forceinline__ void pointwise(uint32_t* x,
                                                   const uint32_t* d0,
                                                   const uint32_t* d1,
                                                   const uint16_t* staged,
                                                   int n, int half) {
    if (half)
      S::template pointwise_half<P, 1>(x, d0, d1, staged, n);
    else
      S::template pointwise_half<P, 0>(x, d0, d1, staged, n);
  }

  static __device__ __forceinline__ void stage(uint16_t* staged,
                                               const uint16_t* key,
                                               uint64_t* bar, int n,
                                               int half) {
    if (half)
      stage_key<S, H1::kRunPolys>(staged, key, bar, n);
    else
      stage_key<S, H0::kRunPolys>(staged, key, bar, n);
  }
};

// What one block of a cluster of kC holds, and its shared memory.
template <class S, int kC>
struct Body {
  static_assert(kC == 2 || kC == 4 || kC == 8,
                "cluster bodies: 2, 4 or 8 blocks an item");
  using Sh = Share<S, kC>;
  static constexpr bool kSplitRows = kC >= 4;
  static constexpr bool kSplitPlanes = kC == 8;
  static constexpr int kMyRows = kSplitRows ? 1 : kRows;
  static constexpr int kHats = kMyRows * kLimbs;     // forward transforms
  static constexpr int kOut = kMyRows * Sh::kPlanes;  // inverse transforms
  static constexpr int kWork = kOut > kHats ? kOut : kHats;
  // The hats a block receives: the other row's (kC = 4), or (kC = 8) both
  // rows' of its prime, [2][kLimbs], its own included.
  static constexpr int kHin = kSplitPlanes ? 2 * kLimbs : kSplitRows ? kLimbs : 0;
  // The residues a block receives: the other prime's of its planes, or
  // (kC = 8) both primes' of every plane of its row, [2][S::kCount].
  static constexpr int kRes = kSplitPlanes ? 2 * S::kCount : kOut;
  // The 4- and 8-block bodies have room to hold their slice of a step's key.
  static constexpr int kStaged = kSplitRows ? S::kStageRuns * Sh::kRunPolys : 0;
  // acc [kMyRows][n], x u32 [kWork][n], hin u32 [kHin][n], res u16 [kRes][n],
  // staged key u16 [kStaged][n], one mbarrier
  static size_t smem_bytes(int n) {
    return static_cast<size_t>(n) * (kMyRows * sizeof(typename S::Acc) +
                                     4 * (kWork + kHin) +
                                     2 * (kRes + kStaged)) +
           sizeof(uint64_t);
  }
};

// kC = 8: the digit limbs of its row whose forward transforms a half runs,
// half 0 limb 0 and half 1 limbs 1 and 2: half 1 has as many product planes
// as half 0 or fewer, so the two halves' transforms are as even as 3 + 5
// (approx) or 3 + 8 (exact) polys split in two allow.
__device__ __forceinline__ int first_limb(int half) { return half ? 1 : 0; }
__device__ __forceinline__ int limb_count(int half) { return half ? 2 : 1; }

// kC = 8: where a block stores its part of a step, the same place of four
// blocks' buffers, its own first.  hats: its row's hats of its limbs, into
// hin at (row * 3 + first limb) * n of blocks rank, rank ^ 2, rank ^ 4 and
// rank ^ 6 (every block of its prime); res: its planes' residues, into res
// at (prime * S::kCount + first plane) * n of blocks rank, rank ^ 1,
// rank ^ 4 and rank ^ 5 (every block of its row).
struct Stores8 {
  uint4* hats[4];
  uint32_t* res[4];
};

// One step's work of one block up to its residue stores, for its prime P.
// peer_hin, peer_res (kC = 2, 4): where the hats and residues go in block
// rank ^ 2 and rank ^ 1; to (kC = 8): where they go.
template <class S, int kC, uint32_t P>
__device__ void prime_part(uint32_t* x, const uint32_t* hin,
                           uint32_t* peer_hin, uint16_t* peer_res,
                           const Stores8& to,
                           const typename S::Acc* acc,
                           const typename S::Step& a,
                           const uint16_t* __restrict__ key,
                           uint16_t* staged, uint64_t* bar, int step,
                           int n_steps, size_t step_stride,
                           const uint2* __restrict__ tw, int row0, int half,
                           int n, int log_n) {
  using B = Body<S, kC>;
  S::template digits<P>(x, acc, B::kMyRows, a, n, log_n);
  const uint32_t* d0 = x;
  const uint32_t* d1 = x + kLimbs * n;
  if constexpr (B::kSplitPlanes) {
    const int l0 = first_limb(half), count = limb_count(half);
    ntt64::ntt_fwd<P>(x + l0 * n, count, log_n, tw);
    const uint4* src = reinterpret_cast<const uint4*>(x + l0 * n);
    for (int idx = threadIdx.x; idx < count * n / 4; idx += blockDim.x) {
      const uint4 v = src[idx];
      to.hats[0][idx] = v;
      to.hats[1][idx] = v;
      to.hats[2][idx] = v;
      to.hats[3][idx] = v;
    }
    cluster_arrive();  // barrier H
    cluster_wait();
    d0 = hin;
    d1 = hin + kLimbs * n;
  } else {
    ntt64::ntt_fwd<P>(x, B::kHats, log_n, tw);
  }
  if constexpr (B::kSplitRows && !B::kSplitPlanes) {
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(peer_hin);
    for (int idx = threadIdx.x; idx < kLimbs * n / 4; idx += blockDim.x)
      dst[idx] = src[idx];
    cluster_arrive();  // barrier H
    cluster_wait();
    d0 = row0 == 0 ? x : hin;
    d1 = row0 == 0 ? hin : x;
  }
  if constexpr (B::kSplitRows) {
    // This step's key slice was started a step ago; the next one's starts
    // once every thread is done with this one's (pointwise ends in a
    // block-wide barrier).
    mbarrier_wait(bar, step & 1);
    B::Sh::template pointwise<P>(x, d0, d1, staged, n, half);
    if (threadIdx.x == 0 && step + 1 < n_steps)
      B::Sh::stage(staged, key + step_stride, bar, n, half);
  } else {
    S::template pointwise<P, B::kMyRows>(x, d0, d1, key, row0, n);
  }
  const int out = B::kMyRows * B::Sh::planes(half);
  ntt64::ntt_inv<P>(x, out, log_n, tw + n);
  if constexpr (!B::kSplitRows)
    cluster_wait();  // the peer has read step j - 1's res
  const uint2* src = reinterpret_cast<const uint2*>(x);
  uint32_t* dst = reinterpret_cast<uint32_t*>(peer_res);
  if constexpr (B::kSplitPlanes) {
    for (int idx = threadIdx.x; idx < out * n / 2; idx += blockDim.x) {
      const uint2 v = src[idx];  // two residues < 2^16
      const uint32_t w = v.x | (v.y << 16);
      to.res[0][idx] = w;
      to.res[1][idx] = w;
      to.res[2][idx] = w;
      to.res[3][idx] = w;
    }
  } else {
    for (int idx = threadIdx.x; idx < out * n / 2; idx += blockDim.x) {
      const uint2 v = src[idx];  // two residues < 2^16
      dst[idx] = v.x | (v.y << 16);
    }
  }
}

template <class S, int kC>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const typename S::Acc* acc_in, typename S::Acc* acc_out,
       const typename S::Source source, const uint16_t* __restrict__ khat,
       const uint2* __restrict__ tw, int n_steps, int n, int log_n) {
  using B = Body<S, kC>;
  using Acc = typename S::Acc;
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  Acc* acc = reinterpret_cast<Acc*>(cluster_smem);           // [kMyRows][n]
  uint32_t* x = reinterpret_cast<uint32_t*>(acc + B::kMyRows * n);
  uint32_t* hin = x + B::kWork * n;
  uint16_t* res = reinterpret_cast<uint16_t*>(hin + B::kHin * n);
  uint16_t* staged = res + B::kRes * n;                      // [kStaged][n]
  uint64_t* bar = reinterpret_cast<uint64_t*>(staged + B::kStaged * n);

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int prime = rank & 1;
  const int row0 = B::kSplitPlanes ? static_cast<int>((rank >> 1) & 1u)
                   : B::kSplitRows ? static_cast<int>(rank >> 1)
                                   : 0;
  const int half = B::kSplitPlanes ? static_cast<int>(rank >> 2) : 0;
  const size_t item = blockIdx.x / kC;
  uint16_t* peer_res = cluster.map_shared_rank(res, rank ^ 1u);
  uint32_t* peer_hin =
      B::kSplitRows ? cluster.map_shared_rank(hin, rank ^ 2u) : nullptr;
  Stores8 to{};
  if constexpr (B::kSplitPlanes) {
    uint32_t* hats = hin + (row0 * kLimbs + first_limb(half)) * n;
    uint16_t* planes =
        res + (prime * S::kCount + B::Sh::first(half)) * n;
    const unsigned hat_peer[3] = {rank ^ 2u, rank ^ 4u, rank ^ 6u};
    const unsigned res_peer[3] = {rank ^ 1u, rank ^ 4u, rank ^ 5u};
    to.hats[0] = reinterpret_cast<uint4*>(hats);
    to.res[0] = reinterpret_cast<uint32_t*>(planes);
    for (int k = 0; k < 3; ++k) {
      to.hats[k + 1] = reinterpret_cast<uint4*>(
          cluster.map_shared_rank(hats, hat_peer[k]));
      to.res[k + 1] = reinterpret_cast<uint32_t*>(
          cluster.map_shared_rank(planes, res_peer[k]));
    }
  }

  // The accumulator may be updated in place (acc_out == acc_in): a row is
  // read here, before the first cluster barrier, and written after the
  // last.  Without acc_in it starts at zero.
  const Acc* in = acc_in + (item * kRows + row0) * n;
  for (int idx = threadIdx.x; idx < B::kMyRows * n; idx += blockDim.x)
    acc[idx] = acc_in ? in[idx] : Acc(0);
  cluster_arrive();  // every block of the cluster has started
  cluster_wait();
  if (!B::kSplitRows) cluster_arrive();

  // The block's key: its prime's half of a step and, where the block holds
  // one output row, that row's polys of each run (kC = 8: those its half's
  // planes read).
  const uint16_t* key = khat + static_cast<size_t>(prime) * S::kKeyPolys * n;
  const size_t step_stride = static_cast<size_t>(2) * S::kKeyPolys * n;
  if (B::kSplitRows) {
    key += static_cast<size_t>(row0) * S::kStageRunPolys * n;
    if constexpr (B::kSplitPlanes)
      key += static_cast<size_t>(B::Sh::run_first(half)) * n;
    if (threadIdx.x == 0) {
      mbarrier_init(bar);
      if (n_steps > 0) B::Sh::stage(staged, key, bar, n, half);
    }
    __syncthreads();
  }
  const uint2* twp = tw + 2 * n * prime;
  const int shift = ntt64::swizzle_shift(threadIdx.x & (n - 1));
  for (int j = 0; j < n_steps; ++j, key += step_stride) {
    const typename S::Step a = S::step(source, item, row0, n, n_steps, j);
    if (prime == 0)
      prime_part<S, kC, kP0>(x, hin, peer_hin, peer_res, to, acc, a, key,
                             staged, bar, j, n_steps, step_stride, twp, row0,
                             half, n, log_n);
    else
      prime_part<S, kC, kP1>(x, hin, peer_hin, peer_res, to, acc, a, key,
                             staged, bar, j, n_steps, step_stride, twp, row0,
                             half, n, log_n);
    cluster_arrive();  // barrier R
    cluster_wait();
    for (int idx = threadIdx.x; idx < B::kMyRows * n; idx += blockDim.x) {
      const int r = idx >> log_n, at = (idx & (n - 1)) + shift;
      if constexpr (B::kSplitPlanes)
        acc[idx] += S::crt_sum(res, res + S::kCount * n, r, at, n);
      else
        acc[idx] += prime == 0 ? S::crt_sum(x, res, r, at, n)
                               : S::crt_sum(res, x, r, at, n);
    }
    if (!B::kSplitRows) cluster_arrive();
    __syncthreads();
  }
  if (!B::kSplitRows) cluster_wait();

  // Each row is written once: by block `row` of 2, by the prime-0 block of
  // 4, by the prime-0 block of half 0 of 8.
  if (B::kSplitRows && (prime != 0 || half != 0)) return;
  const int local = B::kSplitRows ? 0 : prime;
  const int row = B::kSplitRows ? row0 : prime;
  Acc* out = acc_out + (item * kRows + row) * n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    out[idx] = acc[local * n + idx];
}

// Lets the body use the shared memory of polynomial size n (and below).
// Each kernel's init function calls it once per device with the largest n:
// a launch that is captured into a CUDA graph cannot set an attribute.
template <class S, int kC>
cudaError_t allow_shared_memory(int n) {
  return cudaFuncSetAttribute(
      kernel<S, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Body<S, kC>::smem_bytes(n)));
}

template <class S, int kC>
void configure(cudaLaunchConfig_t* config, cudaLaunchAttribute* attr,
               int batch, int n, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kC;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(batch) * kC);
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = Body<S, kC>::smem_bytes(n);
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
}

// Launches the cluster body of kC blocks an item; the launch's cudaError_t.
template <class S, int kC>
int launch(const void* acc_in, void* acc_out, typename S::Source source,
           const void* khat, const void* tw, int batch, int n_steps, int n,
           int log_n, cudaStream_t stream) {
  using Acc = typename S::Acc;
  if (batch == 0) return 0;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  configure<S, kC>(&config, &attr, batch, n, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel<S, kC>, static_cast<const Acc*>(acc_in),
      static_cast<Acc*>(acc_out), source,
      static_cast<const uint16_t*>(khat), static_cast<const uint2*>(tw),
      n_steps, n, log_n);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of the body the card runs at once (its blocks must be
// co-scheduled inside one GPC), or minus the cudaError_t.
template <class S, int kC>
int max_active_clusters(int n) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  configure<S, kC>(&config, &attr, 1, n, nullptr);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel<S, kC>, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

}  // namespace rotate_cluster
