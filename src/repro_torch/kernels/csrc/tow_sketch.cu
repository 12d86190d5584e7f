// Tug-of-War sketches: all ell ±1 sums in one pass over each row's keys.
//
//   Y[r, i] = sum_e valid[r, e] * (1 - 2 * (mix32(mix32(e, 0x5EED) ^ seed_i, 0x7077) & 1))
//           = n_r - 2 * #{valid e : mix32(mix32(e, 0x5EED) ^ seed_i, 0x7077) odd}
//
// Replaces two TPU kernels of the same hash family: `_kernel` / `tow_sketch`
// of src/repro/kernels/tow_sketch.py (one row, ell = 128, phase 0) and
// `_kernel` / `tree_digest` of src/repro/kernels/tree_digest.py (R range
// rows, ell = 32, one launch per tree level).  The TPU forms materialise a
// (tile x ell) sign matrix per tile and reduce it; here no such matrix
// exists.
//
// Bound: integer operations — ell hash evaluations per valid key against
// 4-5 bytes read — so the design is about instruction issue.  A warp takes
// 32 keys at a time, one a lane; each lane hashes its own key's first round
// h1 = mix32(key, 0x5EED) once, and the warp broadcasts the valid keys' h1
// with __shfl_sync.  Lane i owns ell/32 seeds (i, i + 32, ...) as
// independent chains in registers and counts the *odd* second-round hashes:
// Y = n - 2 * odd, so the inner loop per (key, seed) is the mix32 (its last
// shift and xor folded into one multiply, `odd_bit16`), a mask and an add,
// with no sign or select.  Padding costs its mask load and a
// __ballot_sync: a group of 32 keys with no valid one is skipped before its
// keys are read, and a partly valid group walks only its set bits (__ffs).
//
// Two entries:
//   tow_sketch_launch — (R, E) rows + byte mask (the reference's contract:
//                       K3, one row, and the padded K4).  Rows of up to
//                       kWarpRowMax keys go one warp a row and are stored
//                       directly.  Longer rows go to `bpr` blocks each, as
//                       many as give every warp about kGroupsPerWarp groups
//                       of 32 keys: the grid grows with the cells, not the
//                       rows, so K3's one row of 2^20 keys puts 64 warps on
//                       every SM and the few real rows of a padded level
//                       get as many warps as they would alone.  A block
//                       walks its row's groups in a grid stride, sums its 8
//                       warps in shared memory and issues one atomicAdd per
//                       seed into the zeroed output (or stores when it
//                       holds the whole row).
//   tow_ranges_launch — ragged rows read straight from one sorted key array:
//                       row r is keys[lo[r] : lo[r] + cnt[r]] (the tree
//                       walk's ranges, both sides stacked).  No padded
//                       matrix, mask or index matrix exists: a warp item is
//                       up to `tile` consecutive keys of one row (the host
//                       sizes `tile` so that the items fill the card).  Item r <
//                       R is the head of row r (stored directly when it
//                       holds the whole row, zeros for cnt = 0); the tail
//                       tiles of longer rows are listed after lo and cnt by
//                       the host (row, start, length) and added atomically
//                       into the zeroed output.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRowMax = 256;    // rows up to this long: one warp a row
constexpr int kGroupsPerWarp = 4;   // long rows: 32-key groups a warp walks
constexpr int kBlocksPerSM = 8;     // grid-stride cap: 8 x 8 = 64 warps an SM

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

// The lane's NS seeds of the span starting at i0 (absent seeds read 0; their
// sums are never stored).
template <int NS>
__device__ __forceinline__ void load_seeds(const uint32_t* seeds, int i0, int ell,
                                           uint32_t (&s)[NS], int (&odd)[NS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int i = i0 + lane + 32 * k;
    s[k] = i < ell ? seeds[i] : 0u;
    odd[k] = 0;
  }
}

// Bit 16 of the result is bit 0 of mix32(y, 0x7077): that bit is bit 0 ^
// bit 16 of x = (...) * 0xC2B2AE35, and bit 16 of x * 0x10001 = x + (x << 16)
// is exactly that xor (no carry reaches it).  So one multiply by the product
// of the two constants stands for the multiply, the last shift and the xor.
__device__ __forceinline__ uint32_t odd_bit16(uint32_t y) {
  uint32_t x = y + 0x7077u * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return (x * (0xC2B2AE35u * 0x10001u)) & 0x10000u;
}

// One group of 32 keys, lane j holding `key`; `bits` (warp-uniform) marks
// the valid lanes.  Adds the valid keys' odd hashes of the lane's seeds
// (counted in bit 16 and up of `acc`: 32 keys cannot carry past bit 31).
template <int NS>
__device__ __forceinline__ void hash_group(uint32_t key, unsigned bits,
                                           const uint32_t (&s)[NS], int (&odd)[NS]) {
  const uint32_t h1 = mix32(key, 0x5EEDu);
  uint32_t acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0;
  if (bits == kFull) {
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const uint32_t h = __shfl_sync(kFull, h1, j);
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[k] += odd_bit16(h ^ s[k]);
    }
  } else {
    while (bits) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      const uint32_t h = __shfl_sync(kFull, h1, j);
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[k] += odd_bit16(h ^ s[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) odd[k] += (int)(acc[k] >> 16);
}

// The 32-key group at column g0 of one masked row: ballot on the mask, keys
// read only where some lane is valid.  Returns the group's valid count.
template <int NS>
__device__ __forceinline__ int masked_group(const uint32_t* row, const uint8_t* vrow,
                                            long long g0, long long E,
                                            const uint32_t (&s)[NS], int (&odd)[NS]) {
  const long long t = g0 + (threadIdx.x & 31);
  const bool on = t < E && (vrow == nullptr || vrow[t] != 0);
  const unsigned bits = __ballot_sync(kFull, on);
  if (bits == 0) return 0;
  hash_group<NS>(on ? row[t] : 0u, bits, s, odd);
  return __popc(bits);
}

// Rows of up to kWarpRowMax keys: warp per row (grid stride), direct store.
template <int NS>
__global__ void __launch_bounds__(kThreads)
tow_rows_warp_kernel(const uint32_t* __restrict__ elems,
                     const uint8_t* __restrict__ valid,   // null: all valid
                     const uint32_t* __restrict__ seeds,
                     int32_t* __restrict__ out, long long R, int E, int ell) {
  const int lane = threadIdx.x & 31;
  const long long w0 = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  for (int i0 = 0; i0 < ell; i0 += 32 * NS) {
    uint32_t s[NS];
    int odd[NS];
    for (long long r = w0; r < R; r += nw) {
      load_seeds<NS>(seeds, i0, ell, s, odd);
      const uint32_t* row = elems + (size_t)r * E;
      const uint8_t* vrow = valid ? valid + (size_t)r * E : nullptr;
      int n = 0;
      for (int g0 = 0; g0 < E; g0 += 32) n += masked_group<NS>(row, vrow, g0, E, s, odd);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int i = i0 + lane + 32 * k;
        if (i < ell) out[(size_t)r * ell + i] = n - 2 * odd[k];
      }
    }
  }
}

// Longer rows: bpr blocks a row (block b: row b / bpr, part b % bpr), each
// walking the row's groups part * 8 + warp, step bpr * 8; the block's warps
// are summed in shared memory, then stored (bpr == 1) or added.
template <int NS>
__global__ void __launch_bounds__(kThreads)
tow_rows_block_kernel(const uint32_t* __restrict__ elems,
                      const uint8_t* __restrict__ valid,
                      const uint32_t* __restrict__ seeds,
                      int32_t* __restrict__ out, long long E, int ell, int bpr) {
  __shared__ int part_y[kWarps][32 * NS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t r = blockIdx.x / bpr;
  const long long part = blockIdx.x % bpr;
  const uint32_t* row = elems + r * E;
  const uint8_t* vrow = valid ? valid + r * E : nullptr;
  const long long groups = (E + 31) / 32, step = (long long)bpr * kWarps;
  for (int i0 = 0; i0 < ell; i0 += 32 * NS) {
    uint32_t s[NS];
    int odd[NS];
    load_seeds<NS>(seeds, i0, ell, s, odd);
    int n = 0;
    for (long long g = part * kWarps + warp; g < groups; g += step)
      n += masked_group<NS>(row, vrow, g * 32, E, s, odd);
#pragma unroll
    for (int k = 0; k < NS; ++k) part_y[warp][lane + 32 * k] = n - 2 * odd[k];
    __syncthreads();
    for (int t = threadIdx.x; t < 32 * NS; t += kThreads) {
      const int i = i0 + t;
      if (i >= ell) continue;
      int y = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) y += part_y[w][t];
      if (bpr == 1) out[r * ell + i] = y;
      else if (y != 0) atomicAdd(&out[r * ell + i], y);
    }
    __syncthreads();
  }
}

// Ragged rows over one key array.  desc: lo (R), cnt (R), then X tail
// tiles of 3 ints (row, start, length); every length of a tail tile and
// every head (min(cnt, tile)) is at most `tile`.
template <int NS>
__global__ void __launch_bounds__(kThreads)
tow_ranges_kernel(const uint32_t* __restrict__ keys,
                  const int32_t* __restrict__ desc,
                  const uint32_t* __restrict__ seeds,
                  int32_t* __restrict__ out, int R, int X, int ell, int tile) {
  const int lane = threadIdx.x & 31;
  const long long w0 = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  const long long items = (long long)R + X;
  for (int i0 = 0; i0 < ell; i0 += 32 * NS) {
    uint32_t s[NS];
    int odd[NS];
    for (long long it = w0; it < items; it += nw) {
      load_seeds<NS>(seeds, i0, ell, s, odd);
      int row, start, len;
      bool whole;
      if (it < R) {
        row = (int)it;
        start = desc[row];
        const int cnt = desc[R + row];
        len = min(cnt, tile);
        whole = cnt <= tile;
      } else {
        const int32_t* e = desc + 2 * (size_t)R + 3 * (size_t)(it - R);
        row = e[0];
        start = e[1];
        len = e[2];
        whole = false;
      }
      const uint32_t* base = keys + start;
      for (int g0 = 0; g0 < len; g0 += 32) {
        const int left = len - g0;
        const unsigned bits = left >= 32 ? kFull : (1u << left) - 1u;
        const int t = g0 + lane;
        hash_group<NS>(t < len ? base[t] : 0u, bits, s, odd);
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int i = i0 + lane + 32 * k;
        if (i >= ell) continue;
        const int y = len - 2 * odd[k];
        int32_t* dst = out + (size_t)row * ell + i;
        if (whole) *dst = y;
        else if (y != 0) atomicAdd(dst, y);
      }
    }
  }
}

// NS: seeds a lane owns per span — 1 for ell <= 32 (the tree's), 2 for
// ell <= 64, else 4 (phase 0's 128 in one span; longer ell in spans of 128).
int seeds_per_lane(int ell) { return ell <= 32 ? 1 : ell <= 64 ? 2 : 4; }

template <int NS>
cudaError_t launch_rows(const uint32_t* elems, const uint8_t* valid, const uint32_t* seeds,
                        int32_t* out, long long R, long long E, int ell, cudaStream_t st) {
  if (E <= kWarpRowMax) {
    const long long blocks = std::min((R + kWarps - 1) / kWarps,
                                      (long long)sm_count() * kBlocksPerSM);
    tow_rows_warp_kernel<NS><<<(unsigned)blocks, kThreads, 0, st>>>(
        elems, valid, seeds, out, R, (int)E, ell);
    return cudaGetLastError();
  }
  const long long groups = (E + 31) / 32;
  const long long per_block = (long long)kWarps * kGroupsPerWarp;
  const long long bpr = std::max(1LL, std::min((groups + per_block - 1) / per_block,
                                               (long long)INT32_MAX / R));
  if (R * bpr > INT32_MAX) return cudaErrorInvalidValue;
  if (bpr > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)R * ell * sizeof(int32_t), st);
    if (e != cudaSuccess) return e;
  }
  tow_rows_block_kernel<NS><<<(unsigned)(R * bpr), kThreads, 0, st>>>(
      elems, valid, seeds, out, E, ell, (int)bpr);
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch_ranges(const uint32_t* keys, const int32_t* desc, const uint32_t* seeds,
                          int32_t* out, int R, int X, int ell, int tile, cudaStream_t st) {
  if (X > 0) {   // tail tiles add into their rows
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)R * ell * sizeof(int32_t), st);
    if (e != cudaSuccess) return e;
  }
  const long long items = (long long)R + X;
  const long long blocks = std::min((items + kWarps - 1) / kWarps,
                                    (long long)sm_count() * kBlocksPerSM);
  tow_ranges_kernel<NS><<<(unsigned)blocks, kThreads, 0, st>>>(
      keys, desc, seeds, out, R, X, ell, tile);
  return cudaGetLastError();
}

}  // namespace

// elems (R, E) uint32, valid (R, E) bytes or null, seeds (ell,) uint32,
// out (R, ell) int32, need not be initialised.  Returns the CUDA error code
// of the launch (0 = ok).
extern "C" int tow_sketch_launch(const void* elems, const void* valid,
                                 const void* seeds, void* out,
                                 long long R, long long E, int ell, void* stream) {
  if (R == 0 || ell == 0) return 0;
  auto st = (cudaStream_t)stream;
  if (E == 0) return (int)cudaMemsetAsync(out, 0, (size_t)R * ell * sizeof(int32_t), st);
  auto ke = (const uint32_t*)elems;
  auto kv = (const uint8_t*)valid;
  auto ks = (const uint32_t*)seeds;
  auto ko = (int32_t*)out;
  switch (seeds_per_lane(ell)) {
    case 1: return (int)launch_rows<1>(ke, kv, ks, ko, R, E, ell, st);
    case 2: return (int)launch_rows<2>(ke, kv, ks, ko, R, E, ell, st);
    default: return (int)launch_rows<4>(ke, kv, ks, ko, R, E, ell, st);
  }
}

// keys (N,) uint32 sorted; desc int32 [lo (R), cnt (R), X x (row, start,
// length)] (kernels/tree_digest.py::range_tiles); seeds (ell,) uint32; out
// (R, ell) int32, need not be initialised.  Returns the CUDA error code.
extern "C" int tow_ranges_launch(const void* keys, const void* desc, const void* seeds,
                                 void* out, int R, int X, int ell, int tile, void* stream) {
  if (R == 0 || ell == 0) return 0;
  if (tile <= 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto kk = (const uint32_t*)keys;
  auto kd = (const int32_t*)desc;
  auto ks = (const uint32_t*)seeds;
  auto ko = (int32_t*)out;
  switch (seeds_per_lane(ell)) {
    case 1: return (int)launch_ranges<1>(kk, kd, ks, ko, R, X, ell, tile, st);
    case 2: return (int)launch_ranges<2>(kk, kd, ks, ko, R, X, ell, tile, st);
    default: return (int)launch_ranges<4>(kk, kd, ks, ko, R, X, ell, tile, st);
  }
}
