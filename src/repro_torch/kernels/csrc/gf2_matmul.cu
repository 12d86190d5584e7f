// C = (A @ B) mod 2 for 0/1 int32 matrices.
//
// Replaces the TPU kernel `_kernel` / `gf2_matmul` of
// src/repro/kernels/gf2_matmul.py, which feeds int32 tiles to the matrix
// unit and masks the integer sums with `& 1`.  Over GF(2) the product needs
// no multiplier at all: pack 32 entries of the reduction axis into one
// word, and a dot product becomes AND + XOR over words with one parity
// (`__popc & 1`) at the end.
//
// Bound: memory.  A (M x K int32, the parity bitmaps of every unit) is read
// once per 128-column tile of B and dominates the bytes; the packed
// arithmetic is 1/32 of the scalar work.  One block owns a 64-row x
// 128-column output tile and walks K in slabs of 1024: warps pack the A
// slab with `__ballot_sync` over coalesced row reads, threads pack the B
// slab column-wise over coalesced column reads, both into shared memory
// (row stride padded to 33 words against bank conflicts); each thread then
// XOR-accumulates 32 outputs of one column in registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TM = 64;          // output rows per block
constexpr int TN = 128;         // output columns per block
constexpr int KW = 32;          // packed words per K slab (1024 bits)
constexpr int LD = KW + 1;      // padded shared row stride
constexpr int ROWS_PER_THREAD = TM * TN / kThreads;   // 32

__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  int32_t* __restrict__ c, int M, int K, int N) {
  __shared__ uint32_t a_pack[TM * LD];
  __shared__ uint32_t b_pack[TN * LD];
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int my_col = threadIdx.x % TN;          // this thread's output column
  const int my_row0 = threadIdx.x / TN;         // rows my_row0, +2, +4, ...
  constexpr int ROW_STEP = kThreads / TN;       // 2

  uint32_t acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0u;

  for (int k0 = 0; k0 < K; k0 += KW * 32) {
    // pack A: word (r, w) = bits of a[row0 + r, k0 + 32 w .. +31]
    for (int item = warp; item < TM * KW; item += kThreads / 32) {
      const int r = item / KW, w = item % KW;
      const int gr = row0 + r, gk = k0 + 32 * w + lane;
      const int bit = (gr < M && gk < K) ? (a[(size_t)gr * K + gk] & 1) : 0;
      const uint32_t word = __ballot_sync(0xFFFFFFFFu, bit);
      if (lane == 0) a_pack[r * LD + w] = word;
    }
    // pack B: word (col, w) = bits of b[k0 + 32 w .. +31, col0 + col]
    for (int item = threadIdx.x; item < TN * KW; item += kThreads) {
      const int col = item % TN, w = item / TN;
      const int gc = col0 + col;
      uint32_t word = 0u;
      if (gc < N) {
        const int kbase = k0 + 32 * w;
        const int kend = min(32, K - kbase);
        for (int kk = 0; kk < kend; ++kk)
          word |= (uint32_t)(b[(size_t)(kbase + kk) * N + gc] & 1) << kk;
      }
      b_pack[col * LD + w] = word;
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < KW; ++w) {
      const uint32_t bw = b_pack[my_col * LD + w];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        acc[i] ^= a_pack[(my_row0 + ROW_STEP * i) * LD + w] & bw;
    }
    __syncthreads();
  }

  const int gc = col0 + my_col;
  if (gc < N) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int gr = row0 + my_row0 + ROW_STEP * i;
      if (gr < M) c[(size_t)gr * N + gc] = __popc(acc[i]) & 1;
    }
  }
}

}  // namespace

// a (M, K), b (K, N), c (M, N): contiguous int32.  Returns the CUDA error
// code of the launch (0 = ok).
extern "C" int gf2_matmul_launch(const void* a, const void* b, void* c,
                                 int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  gf2_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)c, M, K, N);
  return (int)cudaGetLastError();
}
