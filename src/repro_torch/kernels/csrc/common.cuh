// Shared device helpers for the PBS kernels.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

// murmur3 fmix32 keyed by a seed: the hash family of the whole protocol
// (core/hashing.py mix32).  Native uint32 wrap-around arithmetic.
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x += seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}
