// One step's 64-bit external product as int8 x int8 -> int32 products on the
// tensor cores (mma.sync m16n8k32), hand-written for Hopper (sm_90a).
//
// Replaces fhestring_tpu/crypto/kernels/ext_product.py: ext_product_u64 (a
// Pallas TPU kernel: Hankel-band int8 matmuls on the MXU).  The Python
// wrapper and the plain PyTorch version are in
// fhestring_tpu_torch/crypto/kernels/ext_product.py.  Per batch item b,
// output row col and coefficient t:
//
//   ext[b][col][t] = sum_s 256^s * sum_{la + lb = s, s < 8} sum_r sum_c
//                    dl_la[b][r][c] * limb_lb(P[r][col])[(t - c) mod 2N]
//                                                              (mod 2^64)
//
// with dl_la the 3 balanced int8 limbs of the 23-bit digits (the output of
// rotate_decompose.cu), P = (K, -K) the key poly doubled with its negation
// (negacyclic: X^N = -1) and limb_lb its 8 balanced byte limbs.  The limbs of
// -K are the balanced limbs of the negated u64 value, not the negated limbs
// (-(-128) is no int8): crypto/keys.py packs the 8 planes of P once, each
// reversed (byte i of a plane is limb_lb(P)[-i mod 2N]).  The terms with
// la + lb >= 8 are multiples of 2^64 and are never computed.
//
// As a matrix product: M = the output coefficient t, K = the digit index c
// (over both digit rows r), N = batch item x digit limb la.  The A operand
// A[t][c] = limb_lb(P)[(t - c) mod 2N] is a Toeplitz matrix and is never
// materialised: a block stages the window of each limb plane that its tile
// of t and its chunk of c can reach; the planes are stored reversed, so the
// 4 consecutive c of one fragment word are 4 ascending bytes.  A thread's word starts at a byte
// offset that depends on its row t, so the window is stored four times,
// shifted by 0 to 3 bytes, and a thread reads aligned words from the copy
// t mod 4.  The B operand is dl as rotate_decompose.cu leaves it (c
// contiguous per limb, item and row).  The int32 sums of one shift s = la +
// lb share one accumulator fragment: |sum| <= 3 pairs * 2 rows * N * 128^2
// = 2^27.6 at N = 2048.  At the end ext = sum_s sign_extend64(plane_s) << 8s
// in uint64_t, added to the output by atomicAdd(unsigned long long): blocks
// that split K add partial sums, and since addition mod 2^64 is associative
// the bits do not depend on their order.  The output may be the rotation's
// accumulator itself (acc += ext without a third launch) or a zeroed buffer.
//
// Design.  A block of 4 warps owns kMt = 128 coefficients t (two m16 tiles a
// warp) of one output row, kGroups groups of 8 batch items (one n8 tile per
// group and limb la) and `per_block` consecutive chunks of `chunk` digit
// indices, staged one after another; grid N/128 x cols * ceil(B / (8
// kGroups)) x (2N / chunk / per_block), cols the output rows of the key it
// is given (2, or 1 for a column shard of the key).  The digits go to shared memory by cp.async,
// the key window through registers, where the 3 shifted copies are made.
// Because A is Toeplitz, the 8 fragment words of a warp's two tiles are 6
// different words and 2 of them are the next k-step's: 4 shared-memory loads
// a limb plane and k-step feed 6 kGroups products.  Shared memory: 8 planes
// x 4 copies x (chunk + 160) bytes and 3 x 8 kGroups x (chunk + 16) bytes,
// 34 KB at chunk = 512 and one group; the strides are padded so that a
// warp's fragment loads fall in 32 different banks.
//
// What bounds it.  3.5e8 int8 multiply-adds an item and step at N = 2048
// (4 (r, col) x 21 (la, lb) pairs x N^2), 0.36 us at the tensor cores' 1,979
// TOP/s.  mma.sync starts about one m16n8k32 product every 7 cycles a
// scheduler on an H100 (timestamps in the kernel, PERF.md), half the unit's
// rate, and the k-loop runs at that: 45% of the peak at B = 2048.  At a
// request's batches the launch, the staging of one chunk (two trips to
// device memory) and the atomics are as long as the products; a batch below
// 8 items wastes the rest of its n8 tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 2;       // k + 1 = digit rows R at ell = 1
constexpr int kLimbs = 3;      // balanced int8 limbs of a digit
constexpr int kKeyPlanes = 8;  // byte limbs of a u64 key value
constexpr int kCopies = 4;     // byte shifts of a staged limb plane
constexpr int kTiles = 2;      // m16 tiles (16 coefficients t) per warp
constexpr int kWarps = 4;
constexpr int kMt = 16 * kTiles * kWarps;  // coefficients t per block
constexpr int kThreads = 32 * kWarps;
constexpr int kItems = 8;      // batch items of one n8 tile

// Words between two copies of a plane: the window's (chunk + kMt) / 4 rounded
// up to 8 mod 32 (chunk is a multiple of 128), so the 4 copies a warp reads
// (rows t mod 4) fall in different banks.
static_assert(kMt / 4 <= 40 && kMt % 16 == 0, "stride_a holds the window");
__host__ __device__ constexpr int stride_a(int chunk) { return chunk / 4 + 40; }
// Words between two rows of digits: 4 mod 32, so the 8 items of a fragment
// fall in different banks.
__host__ __device__ constexpr int stride_b(int chunk) { return chunk / 4 + 4; }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory to shared memory without passing registers;
// zeros if `valid` is false.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// kCols: the output rows of the key the kernel is given (kRows, or 1 for a
// column shard), a template parameter so that the whole key's body is the
// code it was before shards existed.
template <int kGroups, int kCols>
__global__ void __launch_bounds__(kThreads)
ext_product_kernel(const int8_t* __restrict__ dl,
                   const int8_t* __restrict__ key,
                   unsigned long long* __restrict__ out, int batch, int n,
                   int chunk, int per_block) {
  extern __shared__ uint32_t smem[];
  const int sa = stride_a(chunk), sb = stride_b(chunk);
  uint32_t* aw = smem;                               // [8][4][sa]
  uint32_t* bw = smem + kKeyPlanes * kCopies * sa;   // [3][8 kGroups][sb]

  const int t_lo = blockIdx.x * kMt;
  const int col = blockIdx.y % kCols;
  const int b0 = (blockIdx.y / kCols) * kItems * kGroups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t limb_stride = static_cast<size_t>(batch) * kRows * n;

  int acc[kKeyPlanes][kTiles][kGroups][4];
#pragma unroll
  for (int s = 0; s < kKeyPlanes; ++s)
#pragma unroll
    for (int m = 0; m < kTiles; ++m)
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][m][q][i] = 0;

  for (int ch = blockIdx.z * per_block; ch < (blockIdx.z + 1) * per_block;
       ++ch) {
    const int r = (ch * chunk) / n;
    const int c_lo = (ch * chunk) & (n - 1);

    // Stage the digits of the chunk: dl[la][b][r * n + c_lo + .], 16 bytes
    // an asynchronous copy, all in flight at once; items past the batch are
    // zero.
    const int vecs = chunk / 16;
    for (int idx = threadIdx.x; idx < kLimbs * kItems * kGroups * vecs;
         idx += kThreads) {
      const int row = idx / vecs, v = idx - row * vecs;
      const int la = row / (kItems * kGroups);
      const int b = b0 + row - la * (kItems * kGroups);
      const int8_t* src = dl + la * limb_stride +
                          static_cast<size_t>(b < batch ? b : 0) * kRows * n +
                          r * n + c_lo + 16 * v;
      cp_async_16(bw + row * sb + 4 * v, src, b < batch);
    }

    // Stage the 8 limb planes, all 4 copies at once: byte x of the window
    // is P at (t_lo + kMt - c_lo - x) mod 2N, which is byte (x + c_lo - t_lo
    // - kMt) mod 2N of the reversed plane the key holds, so that A[t][c] is
    // the window's byte (c - c_lo) - (t - t_lo) + kMt.  Copy k is the window
    // shifted up by k bytes.
    const int8_t* kq = key + static_cast<size_t>(r * kCols + col) *
                                 kKeyPlanes * 2 * n;
    const int start = (c_lo - t_lo - kMt) & (2 * n - 1);  // a multiple of 64
    const int vecs_a = (chunk + kMt) / 16;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kKeyPlanes * vecs_a; idx += kThreads) {
      const int lb = idx / vecs_a, v = idx - lb * vecs_a;
      const int8_t* plane = kq + lb * 2 * n;
      const int off = (start + 16 * v) & (2 * n - 1);
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(plane + off));
      const uint32_t prev =
          v ? __ldg(reinterpret_cast<const uint32_t*>(
                  plane + ((off - 4) & (2 * n - 1))))
            : 0u;
      uint32_t* dst = aw + lb * kCopies * sa + 4 * v;
      *reinterpret_cast<uint4*>(dst) = w;
#pragma unroll
      for (int k = 1; k < kCopies; ++k) {
        const int sh = 32 - 8 * k;
        *reinterpret_cast<uint4*>(dst + k * sa) = make_uint4(
            __funnelshift_r(prev, w.x, sh), __funnelshift_r(w.x, w.y, sh),
            __funnelshift_r(w.y, w.z, sh), __funnelshift_r(w.z, w.w, sh));
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // Row t' = 32 warp + g + 8 e (e = 0..3: the two rows of the warp's two
    // m16 tiles) reads the copy t' mod 4 = g mod 4 at word (c' + kMt) / 4 -
    // floor(t' / 4) = ap[8 j + 4 h - 2 e] for the k-step j and its half h.
    // A is Toeplitz, so the two tiles' 8 fragment words are 6 different
    // words, ap[8 j - 6 .. 8 j + 4] in steps of 2, and the upper 2 are the
    // lower 2 of the next k-step: 4 loads a limb plane and k-step.
    const uint32_t* ap =
        aw + (g & 3) * sa + kMt / 4 - 8 * warp - (g >> 2) + tig;
    const uint32_t* bp = bw + g * sb + tig;
    uint32_t carry[kKeyPlanes][2];
#pragma unroll
    for (int lb = 0; lb < kKeyPlanes; ++lb) {
      carry[lb][0] = ap[lb * kCopies * sa - 6];
      carry[lb][1] = ap[lb * kCopies * sa - 4];
    }
#pragma unroll 2
    for (int j = 0; j < chunk / 32; ++j) {
      uint32_t bf[kLimbs][kGroups][2];
#pragma unroll
      for (int la = 0; la < kLimbs; ++la)
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const uint32_t* p = bp + (la * kGroups + q) * kItems * sb + 8 * j;
          bf[la][q][0] = p[0];
          bf[la][q][1] = p[4];
        }
#pragma unroll
      for (int lb = 0; lb < kKeyPlanes; ++lb) {
        const uint32_t* p = ap + lb * kCopies * sa + 8 * j;
        const uint32_t w0 = p[-2], w1 = p[0], w2 = p[2], w3 = p[4];
        // tile 0: rows e = 0, 1; tile 1: rows e = 2, 3
        const uint32_t af[kTiles][4] = {{w1, w0, w3, w2},
                                        {carry[lb][1], carry[lb][0], w1, w0}};
        carry[lb][0] = w2;
        carry[lb][1] = w3;
        // la downwards: two products into one accumulator are 6 kGroups
        // apart
#pragma unroll
        for (int la = kLimbs - 1; la >= 0; --la) {
          if (la + lb >= kKeyPlanes) continue;
#pragma unroll
          for (int m = 0; m < kTiles; ++m)
#pragma unroll
            for (int q = 0; q < kGroups; ++q)
              mma_s8(acc[la + lb][m][q], af[m], bf[la][q][0], bf[la][q][1]);
        }
      }
    }
    __syncthreads();
  }

  // ext = sum_s sign_extend64(plane_s) << 8s, added to the output.
#pragma unroll
  for (int m = 0; m < kTiles; ++m)
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = b0 + q * kItems + 2 * tig + (i & 1);
        if (b >= batch) continue;
        const int t = t_lo + 16 * (kTiles * warp + m) + g + 8 * (i >> 1);
        uint64_t sum = 0;
#pragma unroll
        for (int s = 0; s < kKeyPlanes; ++s)
          sum += static_cast<uint64_t>(static_cast<int64_t>(acc[s][m][q][i]))
                 << (8 * s);
        atomicAdd(out + (static_cast<size_t>(b) * kCols + col) * n + t,
                  static_cast<unsigned long long>(sum));
      }
}

size_t smem_bytes(int groups, int chunk) {
  return (static_cast<size_t>(kKeyPlanes) * kCopies * stride_a(chunk) +
          static_cast<size_t>(kLimbs) * kItems * groups * stride_b(chunk)) *
         sizeof(uint32_t);
}

template <int kGroups, int kCols>
int launch(const void* dl, const void* key, void* out, int batch, int n,
           int chunk, int split, cudaStream_t stream) {
  const int chunks = 2 * n / chunk;
  const dim3 grid(n / kMt,
                  kCols * ((batch + kItems * kGroups - 1) / (kItems * kGroups)),
                  split);
  ext_product_kernel<kGroups, kCols>
      <<<grid, kThreads, smem_bytes(kGroups, chunk), stream>>>(
          static_cast<const int8_t*>(dl), static_cast<const int8_t*>(key),
          static_cast<unsigned long long*>(out), batch, n, chunk,
          chunks / split);
  return static_cast<int>(cudaGetLastError());
}

// Let the kernel use the block's whole shared memory, and have the SM split
// its memory in favour of shared memory, so that as many blocks are
// resident as their shared memory allows.
template <int kGroups, int kCols>
cudaError_t allow_shared_memory(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ext_product_kernel<kGroups, kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ext_product_kernel<kGroups, kCols>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Once per device, before the first launch (and before any stream capture):
// loads the kernels and lets them use the block's whole shared memory.
// Returns a cudaError_t.
extern "C" int fhe_ext_product_init() {
  int device = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess) err = allow_shared_memory<1, kRows>(bytes);
  if (err == cudaSuccess) err = allow_shared_memory<2, kRows>(bytes);
  if (err == cudaSuccess) err = allow_shared_memory<1, 1>(bytes);
  if (err == cudaSuccess) err = allow_shared_memory<2, 1>(bytes);
  return static_cast<int>(err);
}

// out[b][col][t] += ext[b][col][t] (mod 2^64).  dl: int8 [3, batch, 2 * n]
// digit limbs (natural coefficient order); key: int8 [2 digit rows, cols
// output rows, 8, 2 * n] reversed limb planes of the step's doubled key
// polys: all 2 output rows, or a shard of consecutive ones (the key-sharded
// blind rotation, fhestring_tpu_torch/parallel.py); out: u64 [batch, cols,
// n], the accumulator or a zeroed buffer.  groups: 8-item groups a block (1
// or 2); chunk: digit indices staged at once (a multiple of 128, at most
// n); split: blocks that share one output tile's 2n / chunk chunks (a
// divisor of that count).  Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int fhe_ext_product(const void* dl, const void* key, void* out,
                               int batch, int n, int cols, int groups,
                               int chunk, int split, void* stream) {
  if (n < 128 || n > 2048 || (n & (n - 1)) || batch < 0 || cols < 1 ||
      cols > kRows || chunk < 128 || chunk > n || chunk % 128 || split < 1 ||
      (2 * n / chunk) % split)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (groups * 8 + cols) {
    case 8 + kRows: return launch<1, kRows>(dl, key, out, batch, n, chunk,
                                            split, s);
    case 16 + kRows: return launch<2, kRows>(dl, key, out, batch, n, chunk,
                                             split, s);
    case 8 + 1: return launch<1, 1>(dl, key, out, batch, n, chunk, split, s);
    case 16 + 1: return launch<2, 1>(dl, key, out, batch, n, chunk, split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
