// Hash-partition + parity bitmap + per-bin XOR fold: U packed units (K1) or
// one whole set (K5).
//
// Replaces two TPU kernels of src/repro/kernels/bin_xorsum.py:
//   * `_units_kernel` / `bin_parity_xorsum_units` (K1) — per-unit seeds,
//     the protocol's multiply-shift reduction
//       bin = (mix32(e, seed[u]) * n_bins) >> 32          (__umulhi)
//   * `_kernel` / `bin_parity_xorsum` (K5) — one set, one seed, the
//     historical modulo reduction
//       bin = mix32(e, seed) % n_bins                     (n odd: 63, 127, ...)
// and in both
//   xors[u, bin] ^= e ;  parity[u, bin] ^= 1
// The TPU kernels build a one-hot dispatch matrix and multiply, because a
// TPU cannot scatter; here every thread hashes its keys and scatters them
// with shared-memory atomics into one table per row: n XOR words and n
// parity words.  XOR and parity are order-independent, so any schedule gives
// equal bits; a key equal to 0 flips its bin's parity and leaves its fold
// unchanged, as in the reference.  K1 stores the parity packed (bin b = bit
// b % 32 of word b / 32, pad bits 0: the layout of kernels/gf2_matmul.py,
// which K2 reads as is), one `__ballot_sync` over 32 bins a word.  The
// table keeps a word per bin all the same: packed in shared memory, a
// warp's 32 parity atomics would meet on n / 32 words (2 at n = 63).
//
// Bound: memory.  Each valid key is 4 bytes read plus its mask byte against
// about a dozen integer operations, and the outputs are n fold words and
// n / 32 parity words a row.  So the design keeps the scatter in shared
// memory and writes each output word once, with plain coalesced stores:
// no zero-filled outputs, no global atomics.  Keys come in with 128-bit
// loads and the mask with 32-bit loads where the row is aligned (scalar
// loads otherwise), four of each in flight per thread before it folds any.
// Two regimes, picked from the shape:
//
//   * short rows (E <= 4096: serve cohorts, tree leaves; and longer rows
//     when there are enough of them to give every SM two blocks): a group
//     of 256 / rows_per_block threads per row, several rows per block.  A
//     row past U does nothing; every row below U, masked or not, writes its
//     whole output row.
//   * long rows (the other shapes, and K5): one thread-block cluster per
//     row, up to 16 blocks of 512 threads (8 where the card will not
//     schedule 16), about 8192 keys a block, more where 16 blocks do not
//     cover the row.  Each block folds its slice into its own table, then
//     after `cluster.sync()` rank r XOR-reduces its share of the parity
//     words, and the bins under them, across every rank's table through
//     distributed shared memory and writes them once.  K5 writes its parity
//     unpacked, one int32 per bin, as `encode_group` returns it.
#include "common.cuh"

#include <cooperative_groups.h>
#include <map>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // short rows: threads a block
constexpr int kLongThreads = 512;        // long rows: threads a block of the cluster
constexpr int kUnroll = 4;               // 16-byte key loads in flight per thread
constexpr int kShortMaxKeys = 4096;      // rows up to this long are always short
constexpr int kKeysPerBlock = 8192;      // cluster size: about this many keys a block
constexpr size_t kDefaultSmem = 48 * 1024;

// fold one key into a table of n XOR words then n parity words
template <bool kModulo>
__device__ __forceinline__ void fold(uint32_t* tab, uint32_t e, uint32_t seed, int n) {
  const uint32_t h = mix32(e, seed);
  const uint32_t b = kModulo ? h % (uint32_t)n : __umulhi(h, (uint32_t)n);
  if (e) atomicXor(&tab[b], e);
  atomicXor(&tab[n + b], 1u);
}

// Fold keys [lo, hi) of one row into `tab`, the calling thread taking every
// `step`-th key (or 4-key quad) from `first`.  `lo` is a multiple of 4.
template <bool kModulo>
__device__ void fold_range(uint32_t* tab, const uint32_t* __restrict__ row,
                           const uint8_t* __restrict__ vrow, uint32_t seed, int n,
                           int lo, int hi, int first, int step) {
  int i0 = lo;
  const bool vec = (reinterpret_cast<uintptr_t>(row + lo) & 15) == 0 &&
                   (!vrow || (reinterpret_cast<uintptr_t>(vrow + lo) & 3) == 0);
  if (vec) {
    const int nq = (hi - lo) >> 2;
    const uint4* r4 = reinterpret_cast<const uint4*>(row + lo);
    const uint32_t* v4 = vrow ? reinterpret_cast<const uint32_t*>(vrow + lo) : nullptr;
    // kUnroll quads in flight per thread before the first fold: the loads,
    // not the shared-memory atomics, are what a thread waits on
    for (int q0 = first; q0 < nq; q0 += kUnroll * step) {
      uint4 k[kUnroll];
      uint32_t m[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int q = q0 + j * step;
        k[j] = q < nq ? __ldg(r4 + q) : make_uint4(0u, 0u, 0u, 0u);
        m[j] = q < nq ? (v4 ? __ldg(v4 + q) : 0x01010101u) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (m[j] & 0x000000FFu) fold<kModulo>(tab, k[j].x, seed, n);
        if (m[j] & 0x0000FF00u) fold<kModulo>(tab, k[j].y, seed, n);
        if (m[j] & 0x00FF0000u) fold<kModulo>(tab, k[j].z, seed, n);
        if (m[j] & 0xFF000000u) fold<kModulo>(tab, k[j].w, seed, n);
      }
    }
    i0 = lo + (nq << 2);
  }
  for (int i = i0 + first; i < hi; i += step)
    if (!vrow || vrow[i]) fold<kModulo>(tab, __ldg(row + i), seed, n);
}

__global__ void __launch_bounds__(kThreads)
short_rows_kernel(const uint32_t* __restrict__ elems, const uint8_t* __restrict__ valid,
                  const uint32_t* __restrict__ seeds, uint32_t* __restrict__ parity,
                  uint32_t* __restrict__ xors, int U, int E, int n, int rows_per_block) {
  extern __shared__ __align__(16) uint32_t table[];
  const int group = kThreads / rows_per_block;        // a multiple of 32
  const int slot = threadIdx.x / group, t = threadIdx.x % group;
  const int u = blockIdx.x * rows_per_block + slot;
  uint32_t* tab = table + slot * 2 * n;
  for (int i = t; i < 2 * n; i += group) tab[i] = 0u;
  __syncthreads();
  if (u < U)
    fold_range<false>(tab, elems + (size_t)u * E, valid ? valid + (size_t)u * E : nullptr,
                      seeds[u], n, 0, E, t, group);
  __syncthreads();
  if (u >= U) return;                                  // uniform over the group
  for (int b = t; b < n; b += group) xors[(size_t)u * n + b] = tab[b];
  const int pw = (n + 31) >> 5, lane = t & 31;
  for (int w = t >> 5; w < pw; w += group >> 5) {      // uniform over the warp
    const int b = 32 * w + lane;
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, b < n && (tab[n + b] & 1u));
    if (lane == 0) parity[(size_t)u * pw + w] = word;
  }
}

template <bool kModulo>
__global__ void __launch_bounds__(kLongThreads)
long_rows_kernel(const uint32_t* __restrict__ elems, const uint8_t* __restrict__ valid,
                 const uint32_t* __restrict__ seeds, uint32_t seed0,
                 uint32_t* __restrict__ parity, uint32_t* __restrict__ xors,
                 int E, int n, int slice, int packed) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint32_t table[];
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int u = blockIdx.x / cs;
  const int pw = (n + 31) >> 5;

  for (int i = threadIdx.x; i < 2 * n; i += kLongThreads) table[i] = 0u;
  __syncthreads();
  const int lo = min(E, rank * slice), hi = min(E, lo + slice);
  fold_range<kModulo>(table, elems + (size_t)u * E, valid ? valid + (size_t)u * E : nullptr,
                      seeds ? seeds[u] : seed0, n, lo, hi, threadIdx.x, kLongThreads);
  cluster.sync();

  // rank r owns parity words [w0, w1) and the bins under them
  const int w0 = (int)((long long)pw * rank / cs);
  const int w1 = (int)((long long)pw * (rank + 1) / cs);
  const int b1 = min(n, 32 * w1);
  for (int b = 32 * w0 + threadIdx.x; b < b1; b += kLongThreads) {
    uint32_t x = 0u, p = 0u;
    for (int q = 0; q < cs; ++q) {
      const uint32_t* remote = cluster.map_shared_rank(table, q);
      x ^= remote[b];
      p ^= remote[n + b];
    }
    xors[(size_t)u * n + b] = x;
    if (!packed) parity[(size_t)u * n + b] = p & 1u;
  }
  if (packed) {
    const int lane = threadIdx.x & 31;
    for (int w = w0 + (threadIdx.x >> 5); w < w1; w += kLongThreads / 32) {
      const int b = 32 * w + lane;
      uint32_t p = 0u;
      if (b < n)
        for (int q = 0; q < cs; ++q) p ^= cluster.map_shared_rank(table, q)[n + b];
      const uint32_t word = __ballot_sync(0xFFFFFFFFu, p & 1u);
      if (lane == 0) parity[(size_t)u * pw + w] = word;
    }
  }
  cluster.sync();            // no block leaves while another reads its table
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The largest cluster (16, else 8) the card schedules for this kernel at
// this much shared memory; asked once per (kernel, smem).
template <bool kModulo>
int max_cluster(size_t smem) {
  static std::map<size_t, int> known;
  auto it = known.find(smem);
  if (it != known.end()) return it->second;
  const void* fn = (const void*)long_rows_kernel<kModulo>;
  int best = 8;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
      cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 16;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(16);
    cfg.blockDim = dim3(kLongThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) == cudaSuccess && clusters > 0)
      best = 16;
  }
  cudaGetLastError();        // a refused query leaves no error behind
  known[smem] = best;
  return best;
}

template <bool kModulo>
int launch_long(const void* elems, const void* valid, const void* seeds, uint32_t seed0,
                void* parity, void* xors, int U, int E, int n, int packed, void* stream) {
  const size_t smem = (size_t)2 * n * sizeof(uint32_t);
  cudaError_t e = allow_smem((const void*)long_rows_kernel<kModulo>, smem);
  if (e != cudaSuccess) return (int)e;
  int cs = (E + kKeysPerBlock - 1) / kKeysPerBlock;
  cs = max(1, min(cs, max_cluster<kModulo>(smem)));
  const int slice = (((E + cs - 1) / cs) + 3) & ~3;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)U * cs);
  cfg.blockDim = dim3(kLongThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, long_rows_kernel<kModulo>,
                         (const uint32_t*)elems, (const uint8_t*)valid,
                         (const uint32_t*)seeds, seed0, (uint32_t*)parity, (uint32_t*)xors,
                         E, n, slice, packed);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// K1: elems (U, E) uint32, valid (U, E) bytes, seeds (U,) uint32 ->
// parity (U, ceil(n/32)) packed words, xors (U, n); both written in full
// (no initialisation needed).  Returns the CUDA error code (0 = ok).
extern "C" int bin_xorsum_units_launch(const void* elems, const void* valid,
                                       const void* seeds, void* parity, void* xors,
                                       int U, int E, int n_bins, void* stream) {
  if (U == 0) return 0;
  int rows = 8;
  while (rows > 1 && (size_t)rows * 2 * n_bins * 4 > kDefaultSmem) rows >>= 1;
  const int blocks = (U + rows - 1) / rows;
  if (E > kShortMaxKeys && blocks < 2 * sm_count())
    return launch_long<false>(elems, valid, seeds, 0u, parity, xors, U, E, n_bins, 1, stream);
  const size_t smem = (size_t)rows * 2 * n_bins * sizeof(uint32_t);
  cudaError_t e = allow_smem((const void*)short_rows_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  short_rows_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)elems, (const uint8_t*)valid, (const uint32_t*)seeds,
      (uint32_t*)parity, (uint32_t*)xors, U, E, n_bins, rows);
  return (int)cudaGetLastError();
}

// K5: elems (E,) uint32, every one a member -> parity (n,) int32 0/1 and
// xors (n,), both written in full.  Returns the CUDA error code.
extern "C" int bin_parity_xorsum_launch(const void* elems, unsigned int seed,
                                        void* parity, void* xors,
                                        int E, int n_bins, void* stream) {
  return launch_long<true>(elems, nullptr, nullptr, seed, parity, xors, 1, E, n_bins, 0, stream);
}
