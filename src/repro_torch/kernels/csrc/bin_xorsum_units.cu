// Hash-partition + parity bitmap + per-bin XOR fold for U packed units.
//
// Replaces the TPU kernel `_units_kernel` / `bin_parity_xorsum_units` of
// src/repro/kernels/bin_xorsum.py.  That kernel builds a one-hot dispatch
// matrix and multiplies, because a TPU cannot scatter; here every thread
// hashes its elements and scatters them with shared-memory atomics:
//
//   bin = (mix32(e, seed[u]) * n_bins) >> 32          (__umulhi)
//   xors[u, bin] ^= e ;  parity[u, bin] ^= 1
//
// XOR and parity are order-independent, so any schedule gives equal bits.
//
// Bound: memory.  Each element is 5 bytes read (key + valid byte) against
// about a dozen integer operations, so the design only has to keep the
// scatter out of device memory: one block owns a chunk of one unit row,
// folds it into a table in shared memory, and flushes the non-zero entries
// into the zero-initialised outputs with global atomics.  Rows are ragged
// in the extreme (2 rows of 524288 keys, or 4000 rows of 512), so long rows
// split over blockIdx.y chunks and the global atomics combine them.  For
// small n every warp gets a private copy of the table to spread atomic
// contention on a few dozen words.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bin_xorsum_units_kernel(const uint32_t* __restrict__ elems,
                        const uint8_t* __restrict__ valid,
                        const uint32_t* __restrict__ seeds,
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

  const uint32_t seed = seeds[u];
  const uint32_t* row = elems + (size_t)u * E;
  const uint8_t* vrow = valid + (size_t)u * E;
  uint32_t* mine = table + ((threadIdx.x / 32) % copies) * words;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    if (vrow[i]) {
      const uint32_t e = row[i];
      const uint32_t bin = __umulhi(mix32(e, seed), (uint32_t)n_bins);
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

}  // namespace

// parity and xors must be zero-initialised (U, n_bins).  Returns the CUDA
// error code of the launch (0 = ok).
extern "C" int bin_xorsum_units_launch(const void* elems, const void* valid,
                                       const void* seeds, void* parity, void* xors,
                                       int U, int E, int n_bins, void* stream) {
  if (U == 0 || E == 0) return 0;
  // rows split into chunks of up to 8192 keys; gridDim.y caps at 65535
  int chunk = 8192;
  while ((E + chunk - 1) / chunk > 65535) chunk *= 2;
  const int chunks = (E + chunk - 1) / chunk;
  // warp-private tables while eight of them stay within 48 KB
  const int copies = (2 * n_bins * kWarps * 4 <= 48 * 1024) ? kWarps : 1;
  const size_t smem = (size_t)copies * 2 * n_bins * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bin_xorsum_units_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(U, chunks);
  bin_xorsum_units_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)elems, (const uint8_t*)valid, (const uint32_t*)seeds,
      (int32_t*)parity, (uint32_t*)xors, E, n_bins, chunk, copies);
  return (int)cudaGetLastError();
}
