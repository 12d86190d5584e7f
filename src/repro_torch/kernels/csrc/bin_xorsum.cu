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
// K1 has two regimes, picked from the shape:
//
//   * short rows (E <= 4096: serve cohorts, tree leaves; and longer rows
//     when there are enough of them to give every SM two blocks): a group
//     of 256 / rows_per_block threads per row, several rows per block.  A
//     row past U does nothing; every row below U, masked or not, writes its
//     whole output row.
//   * long rows (the other shapes): one thread-block cluster per row, up
//     to 16 blocks of 512 threads (8 where the card will not schedule 16),
//     about 8192 keys a block, more where 16 blocks do not cover the row.
//     Each block folds its slice into its own table, then after
//     `cluster.sync()` rank r XOR-reduces its share of the parity words,
//     and the bins under them, across every rank's table through
//     distributed shared memory and writes them once.
//
// K5 folds one set over the whole card (`set_fold_kernel`): up to 8192
// keys one block and no merge; beyond, an even number of blocks of 512
// threads, about 4096 keys each and at most one an SM (132 at 10^6 keys),
// in clusters of two.  A block clears its table while its first keys load,
// folds its slice, and the pair XORs its two tables through distributed
// shared memory, each rank writing half the bins: one partial table a
// cluster (n fold words, ceil(n/32) parity words), so 66 partials at
// n = 8191 are 2.2 MB, half the input.  `set_merge_kernel` XORs the
// partials into the outputs, 32 bins a block, every partial of a warp in
// flight at once.  Per key: mix32, the remainder by a reciprocal passed in
// (Lemire's direct remainder, no division), two 32-bit shared atomics.
// From n = 4096 the table packs its parity bits (half the words to clear
// and to read); below, a warp's parity atomics would meet on a few words,
// so the table keeps a parity word a bin.  Tried on the card and left
// (PERF.md): one 64-bit shared atomicXor a key (the SASS is a
// compare-and-swap loop, slow on a hot bin); the merge behind a grid-wide
// barrier of a cooperative launch (the card takes one with a cluster
// dimension, but it ran slower than a second kernel); no clusters, each
// block's table a partial (twice the merge, no faster).
//
// What bounds K5 at 10^6 keys on the H100 is neither the 4 MB read nor the
// issue floor of the fold loop (PERF.md has both) but fixed costs — the
// launch, clearing the table, the pair's reduce through distributed shared
// memory, the merge's own launch — and the throughput of shared atomics.
#include "common.cuh"

#include <algorithm>
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

// ---------------------------------------------------------------------------
// K5: one set over the whole card
// ---------------------------------------------------------------------------

constexpr int kSetThreads = 512;         // threads a block of the fold
constexpr int kSetOneBlock = 8192;       // sets up to this long: one block, no merge
constexpr int kSetKeysPerBlock = 4096;   // short of a full card: about this many keys a block
constexpr int kSetCluster = 2;           // one TPC: 66 pairs tile the 132 SMs
constexpr int kPackedMinBins = 4096;     // from here the table packs its parity bits
constexpr int kReduceBatch = 8;          // bins a thread reads before it writes one
constexpr int kMergeThreads = 256;       // threads a block of the merge: 32 bins
constexpr int kMergeBatch = 16;          // partials a warp reads before it XORs one

// h % n for every 32-bit h and n, by Lemire's direct remainder: with
// M = floor((2^64 - 1) / n) + 1, h % n = ((M * h mod 2^64) * n) >> 64.  The
// last product is taken in two 32-bit halves of the low word.
__device__ __forceinline__ uint32_t fastmod(uint32_t h, uint64_t magic, uint32_t n) {
  const uint64_t low = magic * h;
  return (uint32_t)(((uint64_t)(uint32_t)(low >> 32) * n + __umulhi((uint32_t)low, n)) >> 32);
}

// 32-bit words of K5's table at n bins, a multiple of 4 (cleared 16 bytes
// at a time).  Wide (n < kPackedMinBins): two words a bin, the fold and a
// parity word.  Packed: n fold words, then ceil(n/32) parity words, bin b
// = bit b % 32 of word b / 32 — half the words to clear and to read, but a
// warp's parity atomics meet on n / 32 words, so small tables stay wide.
__host__ __device__ inline int set_table_words(int n) {
  return ((n < kPackedMinBins ? 2 * n : n + (n + 31) / 32) + 3) & ~3;
}

// one key into the table: two 32-bit atomics (a 64-bit shared atomicXor
// compiles to a compare-and-swap loop); key 0 flips the parity alone
template <bool kPacked>
__device__ __forceinline__ void set_fold(uint32_t* tab, uint32_t e, uint32_t seed,
                                         uint64_t magic, uint32_t n) {
  const uint32_t b = fastmod(mix32(e, seed), magic, n);
  if (kPacked) {
    atomicXor(tab + b, e);
    atomicXor(tab + n + (b >> 5), 1u << (b & 31));
  } else {
    atomicXor(tab + 2 * b, e);
    atomicXor(tab + 2 * b + 1, 1u);
  }
}

// bin b of a table: (fold, parity bit; with_parity false: 0 where packed)
template <bool kPacked>
__device__ __forceinline__ uint2 set_bin(const uint32_t* tab, int b, int n, bool with_parity) {
  if (!kPacked) return reinterpret_cast<const uint2*>(tab)[b];
  return make_uint2(tab[b], with_parity ? (tab[n + (b >> 5)] >> (b & 31)) & 1u : 0u);
}

// Block g folds keys [g * slice, (g + 1) * slice) into its table, then
// the cluster's two tables are XORed through distributed shared memory,
// rank r taking its share of the parity words and the bins under them.
// With one partial (one cluster, or one block) that is the output; else
// it goes to `part` row c — n fold words, then ceil(n/32) packed parity
// words — for set_merge_kernel.
template <bool kPacked>
__global__ void __launch_bounds__(kSetThreads)
set_fold_kernel(const uint32_t* __restrict__ elems, uint32_t seed, uint64_t magic,
                uint32_t* __restrict__ parity, uint32_t* __restrict__ xors,
                uint32_t* __restrict__ part, int E, int n, int slice) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint32_t tab[];
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int C = gridDim.x / cs, c = blockIdx.x / cs;
  const int pw = (n + 31) >> 5;
  const int lo = min(E, (int)blockIdx.x * slice), hi = min(E, lo + slice);

  // the first round's key loads go out before the table is cleared
  const uint32_t* row = elems + lo;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int nq = vec ? (hi - lo) >> 2 : 0;
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  uint4 k[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int q = threadIdx.x + j * kSetThreads;
    k[j] = q < nq ? __ldg(r4 + q) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < set_table_words(n) / 4; i += kSetThreads)
    reinterpret_cast<uint4*>(tab)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int q0 = threadIdx.x;;) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (q0 + j * kSetThreads < nq) {
        set_fold<kPacked>(tab, k[j].x, seed, magic, n);
        set_fold<kPacked>(tab, k[j].y, seed, magic, n);
        set_fold<kPacked>(tab, k[j].z, seed, magic, n);
        set_fold<kPacked>(tab, k[j].w, seed, magic, n);
      }
    }
    q0 += kUnroll * kSetThreads;
    if (q0 >= nq) break;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int q = q0 + j * kSetThreads;
      k[j] = q < nq ? __ldg(r4 + q) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int i = (nq << 2) + threadIdx.x; i < hi - lo; i += kSetThreads)
    set_fold<kPacked>(tab, __ldg(row + i), seed, magic, n);
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();

  // rank r owns parity words [w0, w1): bins [32 w0, 32 w1), those past n
  // read as 0; a warp's 32 bins share one parity word, so the loop is
  // uniform over the warp.  A partial takes the parity words packed: a
  // packed table's as they are, a wide table's through a ballot.
  const int w0 = pw * rank / cs, w1 = pw * (rank + 1) / cs;
  const bool bits = !kPacked || C == 1;        // the bins' parity bits are needed
  const uint32_t* peer = cs > 1 ? cluster.map_shared_rank(tab, rank ^ 1) : nullptr;
  uint32_t* prow = part + (size_t)c * (n + pw);
  const int lane = threadIdx.x & 31;
  for (int b0 = 32 * w0 + threadIdx.x; b0 < 32 * w1; b0 += kReduceBatch * kSetThreads) {
    uint2 mine[kReduceBatch], far[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
      const int b = b0 + j * kSetThreads;
      const bool in = b < 32 * w1 && b < n;
      mine[j] = in ? set_bin<kPacked>(tab, b, n, bits) : make_uint2(0u, 0u);
      far[j] = in && peer ? set_bin<kPacked>(peer, b, n, bits) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
      const int b = b0 + j * kSetThreads;
      if (b >= 32 * w1) break;
      const uint32_t x = mine[j].x ^ far[j].x, p = mine[j].y ^ far[j].y;
      if (C == 1) {
        if (b < n) {
          xors[b] = x;
          parity[b] = p;
        }
      } else {
        if (b < n) prow[b] = x;
        if (!kPacked) {
          const uint32_t word = __ballot_sync(0xFFFFFFFFu, p);
          if (lane == 0) prow[n + (b >> 5)] = word;
        }
      }
    }
  }
  if (kPacked && C > 1)
    for (int w = w0 + threadIdx.x; w < w1; w += kSetThreads)
      prow[n + w] = tab[n + w] ^ (peer ? peer[n + w] : 0u);
  // no block leaves while its peer reads its table: each of those reads
  // has landed (its value is stored above), so a relaxed arrive will do
  if (cs > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" :::
                 "memory");
}

// The partials' XOR, 32 bins a block: lane per bin, warps over the
// partials (a warp's loads all in flight before it XORs any), then one XOR
// across the warps through shared memory.
__global__ void __launch_bounds__(kMergeThreads)
set_merge_kernel(const uint32_t* __restrict__ part, uint32_t* __restrict__ parity,
                 uint32_t* __restrict__ xors, int C, int n) {
  constexpr int nw = kMergeThreads / 32;
  __shared__ uint32_t red[2][nw][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = 32 * blockIdx.x + lane;
  const int stride = n + ((n + 31) >> 5);
  uint32_t x = 0u, p = 0u;
  for (int c0 = w; c0 < C; c0 += kMergeBatch * nw) {
    uint32_t xs[kMergeBatch], ps[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int c = c0 + j * nw;
      const uint32_t* row = part + (size_t)c * stride;
      xs[j] = c < C && b < n ? __ldcg(row + b) : 0u;
      ps[j] = c < C ? __ldcg(row + n + blockIdx.x) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      x ^= xs[j];
      p ^= ps[j];
    }
  }
  red[0][w][lane] = x;
  red[1][w][lane] = p;
  __syncthreads();
  if (w == 0 && b < n) {
    for (int q = 1; q < nw; ++q) {
      x ^= red[0][q][lane];
      p ^= red[1][q][lane];
    }
    xors[b] = x;
    parity[b] = (p >> lane) & 1u;
  }
}

struct SetPlan {
  int grid = 1, cluster = 1, partials = 1;
  size_t smem = 0;
};

using SetFoldFn = void (*)(const uint32_t*, uint32_t, uint64_t, uint32_t*, uint32_t*,
                           uint32_t*, int, int, int);

SetFoldFn set_fold_fn(int n) {
  return n < kPackedMinBins ? set_fold_kernel<false> : set_fold_kernel<true>;
}

// Geometry of K5 at (E, n): one block up to kSetOneBlock keys; beyond, an
// even number of blocks, about kSetKeysPerBlock keys each, at most one an
// SM, in clusters of 2; a partial table a cluster.
cudaError_t set_plan(int E, int n, SetPlan* p) {
  p->smem = (size_t)set_table_words(n) * sizeof(uint32_t);
  const cudaError_t e = allow_smem((const void*)set_fold_fn(n), p->smem);
  if (e != cudaSuccess || E <= kSetOneBlock) return e;
  const int want = 2 * ((E + 2 * kSetKeysPerBlock - 1) / (2 * kSetKeysPerBlock));
  p->grid = std::max(2, std::min(want, sm_count() & ~1));
  p->cluster = kSetCluster;
  p->partials = p->grid / kSetCluster;
  return cudaSuccess;
}

cudaError_t launch_set(const uint32_t* elems, uint32_t seed, uint64_t magic, uint32_t* parity,
                       uint32_t* xors, uint32_t* part, long long part_words, int E, int n,
                       cudaStream_t stream) {
  SetPlan p;
  cudaError_t e = set_plan(E, n, &p);
  if (e != cudaSuccess) return e;
  if (p.partials > 1 && part_words < (long long)p.partials * (n + (n + 31) / 32))
    return cudaErrorInvalidValue;
  const int slice = ((E + p.grid - 1) / p.grid + 3) & ~3;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kSetThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, set_fold_fn(n), elems, seed, magic, parity, xors, part, E, n,
                         slice);
  if (e != cudaSuccess) return e;
  if (p.partials > 1)
    set_merge_kernel<<<(n + 31) / 32, kMergeThreads, 0, stream>>>(part, parity, xors,
                                                                  p.partials, n);
  return cudaGetLastError();
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

// K5 on the PR 13 route, one cluster of at most 16 blocks: kept so a
// measurement can time the set-wide kernel against it; no wrapper calls it.
extern "C" int bin_parity_xorsum_cluster_launch(const void* elems, unsigned int seed,
                                                void* parity, void* xors,
                                                int E, int n_bins, void* stream) {
  return launch_long<true>(elems, nullptr, nullptr, seed, parity, xors, 1, E, n_bins, 0, stream);
}

// K5: elems (E,) uint32, every one a member -> parity (n,) int32 0/1 and
// xors (n,), both written in full; `part` holds the plan's partials
// (partials x (n + ceil(n/32)) words, untouched where partials == 1) and
// `part_words` says how many words it has.  `magic` is
// floor((2^64 - 1) / n) + 1 mod 2^64.  Returns the CUDA error code.
extern "C" int bin_parity_xorsum_launch(const void* elems, unsigned int seed,
                                        unsigned long long magic, void* parity, void* xors,
                                        void* part, long long part_words,
                                        int E, int n_bins, void* stream) {
  return launch_set((const uint32_t*)elems, seed, magic, (uint32_t*)parity, (uint32_t*)xors,
                    (uint32_t*)part, part_words, E, n_bins, (cudaStream_t)stream);
}

// The launch geometry of K5 at (E, n): out = {grid, threads, cluster,
// shared bytes a block, partials, packed table}.  Returns the CUDA error code.
extern "C" int bin_parity_xorsum_plan(int E, int n_bins, int* out) {
  SetPlan p;
  const cudaError_t e = set_plan(E, n_bins, &p);
  out[0] = p.grid;
  out[1] = kSetThreads;
  out[2] = p.cluster;
  out[3] = (int)p.smem;
  out[4] = p.partials;
  out[5] = n_bins >= kPackedMinBins;
  return (int)e;
}
