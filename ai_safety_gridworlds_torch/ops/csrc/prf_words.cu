// K2: the counter-based PRF over a grid, for Hopper (sm_90a).
//
// Replaces the PRF of ai_safety_gridworlds_tpu/ops/prng.py (hash_u32 at :44,
// uniform01 at :63), which the TPU kernels inline. The rollout kernel
// (fused_firemaker.cu) inlines the same header; this standalone kernel writes
// words and uniforms for any (key_hi, key_lo, ctr, idx) grid so the device
// PRF can be held against the plain PyTorch version on its own.
//
// Bound: device memory. Each element reads 16 bytes and writes 8 against
// about 20 integer operations, far below the card's operations-per-byte
// balance, so the design is one thread per element with coalesced loads and
// stores and nothing else.
#include "prng.cuh"

__global__ void prf_words_kernel(const uint32_t* __restrict__ key_hi,
                                 const uint32_t* __restrict__ key_lo,
                                 const uint32_t* __restrict__ ctr,
                                 const uint32_t* __restrict__ idx,
                                 uint32_t* __restrict__ words,
                                 float* __restrict__ u, long long n) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  uint32_t w = agw::hash_u32(key_hi[i], key_lo[i], ctr[i], idx[i]);
  words[i] = w;
  u[i] = agw::uniform01(w);
}

extern "C" int prf_words(const void* key_hi, const void* key_lo,
                         const void* ctr, const void* idx, void* words,
                         void* u, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  prf_words_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_hi), static_cast<const uint32_t*>(key_lo),
      static_cast<const uint32_t*>(ctr), static_cast<const uint32_t*>(idx),
      static_cast<uint32_t*>(words), static_cast<float*>(u), n);
  return static_cast<int>(cudaGetLastError());
}
