// C = (A @ B) mod 2 on bit-packed 0/1 matrices, and the packing kernel.
//
// Replaces the TPU kernel `_kernel` / `gf2_matmul` of
// src/repro/kernels/gf2_matmul.py, which feeds int32 tiles to the matrix
// unit and masks the integer sums with `& 1`.  Over GF(2) the product needs
// no multiplier: with the reduction axis packed 32 entries to a word (entry
// k = bit k % 32 of word k / 32, LSB first, pad bits 0), a dot product is
// AND + XOR over words and one parity `__popc & 1` at the end.
//
// Operands arrive packed: A as (M, W) words (K1 writes the parity bitmaps so,
// `ops` packs anything else first), B per column as Bt (N, W) words (the
// syndrome and Chien matrices are packed once on the host and cached).
// W = ceil(K / 32).  Two regimes, chosen by the wrapper from the shape:
//
//   * tile (many rows, W <= 64): one block owns 64 rows and up to 256
//     columns.  It stages the A rows (128-bit loads where aligned) and Bt
//     (column stride W + 1 against bank conflicts) in shared memory once;
//     each warp then takes 8 rows x 32 columns, a lane one column, reads
//     its Bt word once per w and the 8 A words as broadcasts, and stores
//     each output once, coalesced along the row.  Columns come in chunks of
//     32, so at N = 90 six lanes of 96 idle, not 38 of 128.
//   * warp (few rows or long K): one warp per (column, 4 rows), spread
//     over the card.  Lanes walk the K words with 128-bit loads where
//     aligned, XOR-reduce across the warp with `__shfl_xor_sync`, then
//     popc & 1.  At (1, 8191) x (8191, 208) that is 208 warps each reading
//     1 KB of Bt, not two blocks streaming 3.4 MB of int32 B.
//
// Bound: at the serve shapes the int32 output C is the largest item
// (M x N x 4 bytes against M x W x 4 of packed A); the AND/XOR work is a
// few instructions per output word and stays off the tensor cores.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TM = 64;              // tile regime: rows per block
constexpr int RT = 8;               // rows per warp item
constexpr int RG = TM / RT;         // row groups per block
constexpr int kMaxChunks = 8;       // 32-column chunks per block (<= 256 columns)
constexpr int kTileMaxWords = 64;   // tile regime: K <= 2048
constexpr int RM = 4;               // warp regime: rows per warp
constexpr int kWarpThreads = 128;   // warp regime: block size

// bits (R, K) 0/1, entry (r, k) at bits[r * sr + k * sk] -> out (R, W) words
__global__ void __launch_bounds__(kThreads)
gf2_pack_kernel(const int32_t* __restrict__ bits, uint32_t* __restrict__ out,
                int R, int K, long long sr, long long sk) {
  const int lane = threadIdx.x & 31;
  const long long W = (K + 31) / 32;
  const long long total = (long long)R * W;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long item = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
       item < total; item += nwarps) {                 // warp-uniform
    const long long r = item / W;
    const int k = (int)(item % W) * 32 + lane;
    const int bit = k < K ? (bits[r * sr + (long long)k * sk] & 1) : 0;
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, bit);
    if (lane == 0) out[item] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
gf2_tile_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bt,
                int32_t* __restrict__ c, int M, int W, int N, int chunks) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* as = smem;                      // TM x W
  uint32_t* bs = smem + TM * W;             // (32 chunks) x (W + 1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TM;
  const int tn = 32 * chunks;
  const int col0 = blockIdx.y * tn;
  const int rows = min(TM, M - row0);

  const uint32_t* asrc = a + (size_t)row0 * W;
  const int na = rows * W;
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(asrc) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(asrc);
    uint4* d4 = reinterpret_cast<uint4*>(as);
    for (int i = threadIdx.x; i < na / 4; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < na; i += kThreads) as[i] = __ldg(asrc + i);
  }
  const uint32_t* bsrc = bt + (size_t)col0 * W;
  for (int i = threadIdx.x; i < tn * W; i += kThreads) {
    const int cc = i / W, w = i - cc * W;
    bs[cc * (W + 1) + w] = (col0 + cc < N) ? __ldg(bsrc + i) : 0u;
  }
  __syncthreads();

  for (int item = warp; item < RG * chunks; item += kWarps) {
    const int rg = item % RG, cc = (item / RG) * 32 + lane;
    if (rg * RT >= rows) continue;                     // warp-uniform
    const uint32_t* bcol = bs + cc * (W + 1);
    const uint32_t* arow = as + rg * RT * W;
    uint32_t acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0u;
    for (int w = 0; w < W; ++w) {
      const uint32_t bw = bcol[w];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] ^= arow[r * W + w] & bw;
    }
    const int gc = col0 + cc;
    if (gc < N) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int gr = row0 + rg * RT + r;
        if (gr < M) c[(size_t)gr * N + gc] = __popc(acc[r]) & 1;
      }
    }
  }
}

__global__ void __launch_bounds__(kWarpThreads)
gf2_warp_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bt,
                int32_t* __restrict__ c, int M, int W, int N, int vec) {
  const int lane = threadIdx.x & 31;
  const long long gw = ((long long)blockIdx.x * kWarpThreads + threadIdx.x) >> 5;
  const long long items = (long long)N * ((M + RM - 1) / RM);
  if (gw >= items) return;                             // warp-uniform
  const int col = (int)(gw % N);
  const int m0 = (int)(gw / N) * RM;
  const uint32_t* bcol = bt + (size_t)col * W;
  uint32_t acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0u;
  if (vec) {                     // W % 4 == 0 and both operands 16-byte aligned
    const uint4* b4 = reinterpret_cast<const uint4*>(bcol);
    for (int q = lane; q < W / 4; q += 32) {
      const uint4 bw = __ldg(b4 + q);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (m0 + r < M) {
          const uint4 aw = __ldg(reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * W) + q);
          acc[r] ^= (aw.x & bw.x) ^ (aw.y & bw.y) ^ (aw.z & bw.z) ^ (aw.w & bw.w);
        }
      }
    }
  } else {
    for (int w = lane; w < W; w += 32) {
      const uint32_t bw = __ldg(bcol + w);
#pragma unroll
      for (int r = 0; r < RM; ++r)
        if (m0 + r < M) acc[r] ^= __ldg(a + (size_t)(m0 + r) * W + w) & bw;
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    uint32_t v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, off);
    if (lane == r && m0 + r < M) c[(size_t)(m0 + r) * N + col] = __popc(v) & 1;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// bits (R, K) int32 0/1 with element strides (sr, sk); out (R, ceil(K/32))
// int32 words.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int gf2_pack_launch(const void* bits, void* out, int R, int K,
                               long long sr, long long sk, void* stream) {
  const long long total = (long long)R * ((K + 31) / 32);
  if (total == 0) return 0;
  const long long blocks = (total + kWarps - 1) / kWarps;
  gf2_pack_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int32_t*)bits, (uint32_t*)out, R, K, sr, sk);
  return (int)cudaGetLastError();
}

// a (M, W) and bt (N, W) int32 words, c (M, N) int32; regime 0 = tile
// (W <= 64), 1 = warp.  Returns the CUDA error code of the launch.
extern "C" int gf2_matmul_packed_launch(const void* a, const void* bt, void* c,
                                        int M, int W, int N, int regime, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (regime == 0) {
    if (W > kTileMaxWords) return (int)cudaErrorInvalidValue;
    const int chunks = min(kMaxChunks, (N + 31) / 32);
    const size_t smem = (size_t)(TM * W + 32 * chunks * (W + 1)) * sizeof(uint32_t);
    static bool attr_set = false;
    if (!attr_set) {
      const int most = (TM * kTileMaxWords + 32 * kMaxChunks * (kTileMaxWords + 1)) * 4;
      cudaError_t e = cudaFuncSetAttribute(
          gf2_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    dim3 grid((M + TM - 1) / TM, (N + 32 * chunks - 1) / (32 * chunks));
    gf2_tile_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)bt, (int32_t*)c, M, W, N, chunks);
  } else {
    const int vec = (W % 4 == 0) && aligned16(a) && aligned16(bt);
    const long long warps = (long long)N * ((M + RM - 1) / RM);
    const long long blocks = (warps * 32 + kWarpThreads - 1) / kWarpThreads;
    gf2_warp_kernel<<<(unsigned)blocks, kWarpThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)bt, (int32_t*)c, M, W, N, vec);
  }
  return (int)cudaGetLastError();
}
