// Hash-partition + parity bitmap + per-bin XOR fold: U packed units (K1) or
// one whole set (K5), one kernel body.
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
// The reduction is a template switch; everything else is shared.  The TPU
// kernels build a one-hot dispatch matrix and multiply, because a TPU
// cannot scatter; here every thread hashes its elements and scatters them
// with shared-memory atomics.  XOR and parity are order-independent, so
// any schedule gives equal bits, and a key equal to 0 flips its bin's
// parity and leaves its fold unchanged, as in the reference.
//
// Bound: memory.  Each element is 5 bytes read (key + valid byte; 4 for K5,
// whose set has no padding) against about a dozen integer operations, so
// the design only has to keep the scatter out of device memory: one block
// owns a chunk of one row, folds it into a table in shared memory, and
// flushes the non-zero entries into the zero-initialised outputs with
// global atomics.  Rows are ragged in the extreme (2 rows of 524288 keys,
// or 4000 rows of 512; K5 is one row of up to 10^6), so long rows split
// over blockIdx.y chunks and the global atomics combine them.  For small n
// every warp gets a private copy of the table to spread atomic contention
// on a few dozen words.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kModulo>
__global__ void __launch_bounds__(kThreads)
bin_xorsum_kernel(const uint32_t* __restrict__ elems,
                  const uint8_t* __restrict__ valid,   // may be null: all valid
                  const uint32_t* __restrict__ seeds,  // may be null: seed0
                  uint32_t seed0,
                  int32_t* __restrict__ parity,
                  uint32_t* __restrict__ xors,
                  int E, int n_bins, int chunk, int copies) {
  extern __shared__ uint32_t table[];      // copies x (n xor words | n parity words)
  const int u = blockIdx.x;
  const int lo = blockIdx.y * chunk;
  const int hi = min(E, lo + chunk);
  const int words = 2 * n_bins;

  for (int i = threadIdx.x; i < copies * words; i += kThreads) table[i] = 0u;
  __syncthreads();

  const uint32_t seed = seeds ? seeds[u] : seed0;
  const uint32_t* row = elems + (size_t)u * E;
  const uint8_t* vrow = valid ? valid + (size_t)u * E : nullptr;
  uint32_t* mine = table + ((threadIdx.x / 32) % copies) * words;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    if (!vrow || vrow[i]) {
      const uint32_t e = row[i];
      const uint32_t h = mix32(e, seed);
      const uint32_t bin = kModulo ? h % (uint32_t)n_bins : __umulhi(h, (uint32_t)n_bins);
      atomicXor(&mine[bin], e);
      atomicXor(&mine[n_bins + bin], 1u);
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    uint32_t x = 0u, p = 0u;
    for (int c = 0; c < copies; ++c) {
      x ^= table[c * words + b];
      p ^= table[c * words + n_bins + b];
    }
    if (x) atomicXor(&xors[(size_t)u * n_bins + b], x);
    if (p) atomicXor((uint32_t*)&parity[(size_t)u * n_bins + b], 1u);
  }
}

template <bool kModulo>
int launch(const void* elems, const void* valid, const void* seeds, uint32_t seed0,
           void* parity, void* xors, int U, int E, int n_bins, void* stream) {
  if (U == 0 || E == 0) return 0;
  // rows split into chunks of up to 8192 keys; gridDim.y caps at 65535
  int chunk = 8192;
  while ((E + chunk - 1) / chunk > 65535) chunk *= 2;
  const int chunks = (E + chunk - 1) / chunk;
  // warp-private tables while eight of them stay within 48 KB
  const int copies = (2 * n_bins * kWarps * 4 <= 48 * 1024) ? kWarps : 1;
  const size_t smem = (size_t)copies * 2 * n_bins * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bin_xorsum_kernel<kModulo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(U, chunks);
  bin_xorsum_kernel<kModulo><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)elems, (const uint8_t*)valid, (const uint32_t*)seeds, seed0,
      (int32_t*)parity, (uint32_t*)xors, E, n_bins, chunk, copies);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: elems (U, E) uint32, valid (U, E) bytes, seeds (U,) uint32; parity
// and xors zero-initialised (U, n_bins).  Returns the CUDA error code of
// the launch (0 = ok).
extern "C" int bin_xorsum_units_launch(const void* elems, const void* valid,
                                       const void* seeds, void* parity, void* xors,
                                       int U, int E, int n_bins, void* stream) {
  return launch<false>(elems, valid, seeds, 0u, parity, xors, U, E, n_bins, stream);
}

// K5: elems (E,) uint32, every one a member; parity and xors
// zero-initialised (n_bins,).  Returns the CUDA error code of the launch.
extern "C" int bin_parity_xorsum_launch(const void* elems, unsigned int seed,
                                        void* parity, void* xors,
                                        int E, int n_bins, void* stream) {
  return launch<true>(elems, nullptr, nullptr, seed, parity, xors, 1, E, n_bins, stream);
}
