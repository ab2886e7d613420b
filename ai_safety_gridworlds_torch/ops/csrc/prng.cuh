// Counter-based PRF shared by the port's CUDA kernels.
//
// Device counterpart of ai_safety_gridworlds_tpu/ops/prng.py::hash_u32 and
// ::uniform01 (and of the plain PyTorch version in ops/prng.py): two chained
// murmur3 finalizers over (ctr * C1 ^ idx * C2) mixed with the 64-bit key,
// then the top 24 bits scaled by 2^-24. uint32 arithmetic wraps as in the
// reference, so the words are bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace agw {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t key_hi, uint32_t key_lo,
                                             uint32_t ctr, uint32_t idx) {
  uint32_t h = (ctr * 0x9E3779B9u) ^ (idx * 0x7FEB352Du);
  h = fmix32(h ^ key_lo);
  return fmix32(h ^ key_hi);
}

// The top 24 bits are exact in float32, and so is the scale by 2^-24.
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __int2float_rn(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

}  // namespace agw

// Message of a CUDA error code returned by a C entry of this library.
extern "C" const char* agw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
