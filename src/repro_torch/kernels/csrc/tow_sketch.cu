// Tug-of-War sketches: all ell ±1 sums in one pass over each row's keys.
//
//   Y[r, i] = sum_e valid[r, e] * (1 - 2 * (mix32(mix32(e, 0x5EED) ^ seed_i, 0x7077) & 1))
//
// Replaces two TPU kernels of the same hash family: `_kernel` / `tow_sketch`
// of src/repro/kernels/tow_sketch.py (one row, ell = 128, phase 0) and
// `_kernel` / `tree_digest` of src/repro/kernels/tree_digest.py (R range
// rows, ell = 32, one launch per tree level).  The TPU forms materialise a
// (tile x ell) sign matrix per tile and reduce it; here no such matrix
// exists.
//
// Bound: integer operations — ell hash evaluations per valid key against 5
// bytes read.  A block stages the first-round hashes h1 of 1024 keys of one
// row in shared memory (invalid keys staged as absent), then every thread
// owns one seed and a slice of the staged keys and keeps a single running
// sum in a register: the inner loop is one shared-memory broadcast read and
// one mix32 per (key, seed).  A block walks up to four tiles before it adds
// its sums into the zero-initialised output with one atomicAdd per seed.
//
// The two regimes: phase 0 is one row of up to 2^20 keys; a tree level is
// up to 2^20 rows (2 x pow2 frontier) of 512-4096 keys, or 16 rows of 2^20
// keys of which 14 are all padding.  So rows sit on gridDim.x (up to
// 2^31 - 1) and a row's key chunks on gridDim.y, and a tile whose keys are
// all masked is skipped after staging (a padding row costs its mask read).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;         // keys staged per step
constexpr int kTilesPerBlock = 4;   // keys per block = 4096

__global__ void __launch_bounds__(kThreads)
tow_sketch_kernel(const uint32_t* __restrict__ elems,
                  const uint8_t* __restrict__ valid,   // may be null: all valid
                  const uint32_t* __restrict__ seeds,
                  int32_t* __restrict__ out, int E, int ell) {
  __shared__ uint32_t h1[kTile];
  __shared__ uint8_t on[kTile];
  const size_t r = blockIdx.x;
  const uint32_t* row = elems + r * E;
  const uint8_t* vrow = valid ? valid + r * E : nullptr;
  const int lo = blockIdx.y * (kTile * kTilesPerBlock);
  const int hi = min(E, lo + kTile * kTilesPerBlock);

  // seeds are walked in spans of up to blockDim.x; within a span the block
  // splits into `slices` groups that share the staged keys between them
  for (int i0 = 0; i0 < ell; i0 += kThreads) {
    const int span = min(ell - i0, kThreads);
    const int slices = kThreads / span;
    const int i = i0 + threadIdx.x % span;
    const int s = threadIdx.x / span;
    const uint32_t seed = seeds[i];
    int acc = 0;
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int cnt = min(kTile, hi - t0);
      int any = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        const uint8_t o = vrow ? (vrow[t0 + j] != 0) : 1;
        h1[j] = mix32(row[t0 + j], 0x5EEDu);
        on[j] = o;
        any |= o;
      }
      if (!__syncthreads_or(any)) continue;   // an all-padding tile adds 0
      if (s < slices) {
        for (int j = s; j < cnt; j += slices) {
          const int sign = 1 - 2 * (int)(mix32(h1[j] ^ seed, 0x7077u) & 1u);
          acc += on[j] ? sign : 0;
        }
      }
    }
    if (s < slices && acc != 0) atomicAdd(&out[r * ell + i], acc);
  }
}

}  // namespace

// elems (R, E) uint32, valid (R, E) bytes or null, seeds (ell,) uint32,
// out (R, ell) int32 zero-initialised.  Returns the CUDA error code of the
// launch (0 = ok); a row longer than 65535 chunks of 4096 keys is refused
// with cudaErrorInvalidValue.
extern "C" int tow_sketch_launch(const void* elems, const void* valid,
                                 const void* seeds, void* out,
                                 int R, int E, int ell, void* stream) {
  if (R == 0 || E == 0 || ell == 0) return 0;
  const int per_block = kTile * kTilesPerBlock;
  const int chunks = (E + per_block - 1) / per_block;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(R, chunks);
  tow_sketch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)elems, (const uint8_t*)valid, (const uint32_t*)seeds,
      (int32_t*)out, E, ell);
  return (int)cudaGetLastError();
}
