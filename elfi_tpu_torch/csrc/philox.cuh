// Counter-based normals shared by the port's kernels: Philox4x32-10, an open
// uniform and Box-Muller.
//
// A kernel keys Philox with a node's 64-bit stream seed and uses the counter
// (simulation index, draw block), so its output depends neither on the block
// size nor on the grid.  Each call gives four 32-bit words, which make two
// Box-Muller pairs.  The streams differ from torch.randn's: a kernel agrees
// with its plain PyTorch version statistically, and exactly when both are fed
// the same normals.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace elfi {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
  const uint32_t lo0 = kPhiloxM0 * c.x;
  const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
  const uint32_t lo1 = kPhiloxM1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

// Philox4x32-10 (Salmon et al., SC'11): 10 rounds, key bumped between them.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    c = philox_round(c, k);
    k.x += kPhiloxW0;
    k.y += kPhiloxW1;
  }
  return philox_round(c, k);
}

// The four words of draw block `block` of simulation `sim` under `seed`.
__device__ __forceinline__ uint4 philox_block(uint64_t seed, int64_t sim,
                                             uint32_t block) {
  const uint64_t s = static_cast<uint64_t>(sim);
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32),
                 block, 0u),
      make_uint2(static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(seed >> 32)));
}

// The top 23 bits of x as (2m + 1) * 2^-24: exact in float and strictly
// inside (0, 1), so logf never sees 0 (the TPU kernels added 1e-7 instead).
__device__ __forceinline__ float open_uniform(uint32_t x) {
  return static_cast<float>((x >> 9) * 2u + 1u) * 5.9604644775390625e-8f;
}

// Both Box-Muller normals from two 32-bit words.
__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b) {
  const float r = sqrtf(-2.0f * logf(open_uniform(a)));
  float s, c;
  sincospif(2.0f * open_uniform(b), &s, &c);
  return make_float2(r * c, r * s);
}

}  // namespace elfi
