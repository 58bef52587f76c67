// Counter-based normals shared by the port's kernels: Philox4x32-10, open
// uniforms built from the bits of a float, and Box-Muller on the
// special-function units.
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

// The ten round keys of a 64-bit seed, made once on the host.  A kernel
// takes them as a __grid_constant__ parameter, which lives in the constant
// bank: the round's three-way XOR reads its key from there as an operand,
// so the key schedule costs no instruction on the card.  A kernel in a CUDA
// graph, whose seed changes from replay to replay, reads the seed from
// device memory instead and makes the same keys in registers.
struct PhiloxKey {
  uint32_t k[10][2];
};

__host__ __device__ inline PhiloxKey philox_key(uint64_t seed) {
  PhiloxKey key;
  uint32_t a = static_cast<uint32_t>(seed);
  uint32_t b = static_cast<uint32_t>(seed >> 32);
  for (int r = 0; r < 10; ++r) {
    key.k[r][0] = a;
    key.k[r][1] = b;
    a += kPhiloxW0;
    b += kPhiloxW1;
  }
  return key;
}

// a * b as one mul.wide.u32 (one IMAD.WIDE.U32), which gives both halves
// that a round needs.  Written in C++ as a 64-bit product, it also added a
// zero high part (an IADD3 per product in the SASS).
__device__ __forceinline__ uint64_t mul_wide(uint32_t a, uint32_t b) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(a), "r"(b));
  return p;
}

// One round.
__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0,
                                             uint32_t k1) {
  const uint64_t p0 = mul_wide(kPhiloxM0, c.x);
  const uint64_t p1 = mul_wide(kPhiloxM1, c.z);
  return make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ k0,
                    static_cast<uint32_t>(p1),
                    static_cast<uint32_t>(p0 >> 32) ^ c.w ^ k1,
                    static_cast<uint32_t>(p0));
}

// Philox4x32-10 (Salmon et al., SC'11): 10 rounds under the key schedule.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const PhiloxKey& key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) c = philox_round(c, key.k[r][0], key.k[r][1]);
  return c;
}

// Philox4x32-10 keyed by the halves (a, b) of a 64-bit seed, each round key
// made where the round uses it (a + r W0, b + r W1): for a kernel that reads
// its seed from memory, the compiler may recompute a round key rather than
// hold all twenty in registers.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int r = 0; r < 10; ++r)
    c = philox_round(c, a + static_cast<uint32_t>(r) * kPhiloxW0,
                     b + static_cast<uint32_t>(r) * kPhiloxW1);
  return c;
}

// The four words of draw block `block` of simulation `sim` under `key`.
__device__ __forceinline__ uint4 philox_block(const PhiloxKey& key,
                                             int64_t sim, uint32_t block) {
  const uint64_t s = static_cast<uint64_t>(sim);
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32),
                 block, 0u),
      key);
}

// The same words under the seed whose halves are (a, b).
__device__ __forceinline__ uint4 philox_block(uint32_t a, uint32_t b,
                                             int64_t sim, uint32_t block) {
  const uint64_t s = static_cast<uint64_t>(sim);
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32),
                 block, 0u),
      a, b);
}

// The float 1.m whose 23 mantissa bits m are the low 23 bits of x: one LOP3,
// and no int -> float conversion, which issues at a quarter of the FP32 rate.
__device__ __forceinline__ float one_point(uint32_t x) {
  return __uint_as_float((x & 0x007FFFFFu) | 0x3F800000u);
}

// (2m + 1) 2^-24, strictly inside (0, 1): 1.m - (1 - 2^-24) is exact
// (Sterbenz), so logf never sees 0 (the TPU kernels added 1e-7 instead).
__device__ __forceinline__ float open_uniform(uint32_t x) {
  return __fsub_rn(one_point(x), 0.99999994039535522f);
}

// Both Box-Muller normals from two 32-bit words, on the special-function
// units: the radius sqrt(-2 ln u) from MUFU.LG2 and MUFU.SQRT, the angle
// 2 pi (v - 1/2) in [-pi, pi) from MUFU.SIN and MUFU.COS, the range in which
// the intrinsics are accurate to about 2^-21.4.  u >= 2^-24 is never
// subnormal, so the .ftz forms skip the subnormal scaling.  LG2 may return
// a value just above 0 for u just below 1; the radius is then clamped to 0.
__device__ __forceinline__ float2 box_muller_fast(uint32_t a, uint32_t b) {
  float lg, r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(open_uniform(a)));
  const float v = fmaxf(-1.3862943611198906f * lg, 0.0f);
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  float s, c;
  // 1.m - 3/2 is exact, uniform on [-1/2, 1/2)
  __sincosf(6.2831853071795865f * __fsub_rn(one_point(b), 1.5f), &s, &c);
  return make_float2(r * c, r * s);
}

}  // namespace elfi
