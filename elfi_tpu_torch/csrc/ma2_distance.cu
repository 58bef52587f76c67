// Fused MA(2) simulate -> summarise -> distance kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel elfi_tpu/ops/pallas_kernels.py:_ma2_kernel.  Per
// simulation i it draws w_0 .. w_{n_obs+1} ~ N(0, 1), forms the MA(2)
// series x_j = w_{j+2} + t1 w_{j+1} + t2 w_j (j < n_obs), takes the lag-1
// and lag-2 autocovariances s1 = mean_j x_{j+1} x_j and s2 = mean_j
// x_{j+2} x_j, and writes sqrt((s1 - o1)^2 + (s2 - o2)^2).
//
// What bounds it on this card: each simulation reads 8 bytes (t1, t2) and
// writes 4 (12.6 MB, 7.5 us at 2^21 simulations), but at n_obs 100 it
// needs about 2,600 operations: 26 Philox4x32-10 calls (10 rounds of two
// IMAD.WIDE.U32 and two three-way LOP3), 51 Box-Muller pairs (14
// operations, four of them on the special-function units), the filter (4
// per value) and the 197 lag products (2 each), or 0.163 ms at 2^21 at
// the issue rate (128 lanes per SM per clock); the special-function units
// (16) would need 0.115 ms and HBM 0.004.  The loop body below compiles to
// 214 SASS instructions for eight values, about 2,970 a simulation.
//
// What the design does about it: ONE THREAD CARRIES ONE SIMULATION, with the
// recurrence streaming through registers (the two previous w, the two
// previous x, two running sums); nothing touches shared or device memory
// between the parameter loads and the distance store, so TMA, shared memory
// and wgmma have nothing to do.  The work is cut to what the pipes must do:
// - the lag products are summed in float32 over blocks of kBlock
//   consecutive terms and only the block sums are converted to double
//   (conversions to 64-bit issue at 16 per SM per clock): 26 conversions a
//   simulation where one per product made 197;
// - Box-Muller runs on the special-function units (philox.cuh,
//   box_muller_fast), and the uniforms are built from float bits with no
//   int -> float conversion;
// - Philox takes each product's halves from one mul.wide.u32;
// - the loop body covers eight values (two Philox calls, whose rounds
//   interleave) with the block ends at fixed places in it, so the body has
//   no branches and the state shifts are register renames.
//
// RNG: Philox4x32-10 keyed by the node's 64-bit stream seed (a launch
// argument, or in a CUDA graph read from device memory: the same keys), with counter
// (simulation index, draw block), so the result does not depend on the
// block size or the grid (philox.cuh, shared with the g-and-k kernel).
// The streams differ from torch.randn's; the kernel agrees with the plain
// PyTorch version statistically, and exactly when both are fed the same
// noise through the kNoiseIn entry below.
//
// Numerics: the filter and the lag products round each product and sum
// separately (no FMA contraction), the block sums add their terms left to
// right from 0 in float32, and the block sums are added in double in order:
// the order of ma2_distance_reference in ops/kernels/ma2.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using elfi::box_muller_fast;
using elfi::philox_block;
using elfi::PhiloxKey;

constexpr int kThreads = 256;
// Lag products summed in float32 per block of consecutive terms; the plain
// version (ops/kernels/_blocked.py, BLOCK) uses the same.
constexpr int kBlock = 8;

// The MA(2) filter and the two blocked autocovariance sums of one
// simulation, in the steady state: step(w_k) for k >= 4 forms x_{k-2} and
// adds lag-1 term k-3 and lag-2 term k-4.
struct Ma2Stats {
  float t1, t2;
  float w1, w2;              // w_{k-1}, w_{k-2}
  float x1, x2;              // x_{k-3}, x_{k-4}
  float a1 = 0.f, a2 = 0.f;  // open float32 blocks of the two sums
  double s1 = 0.0, s2 = 0.0;

  // The first four values: x_0, x_1 and lag-1 term 0.
  __device__ Ma2Stats(float a, float b, float4 w) : t1(a), t2(b) {
    x2 = filter(w.z, w.y, w.x);
    x1 = filter(w.w, w.z, w.y);
    a1 = __fadd_rn(a1, __fmul_rn(x1, x2));
    w1 = w.w;
    w2 = w.z;
  }

  __device__ __forceinline__ float filter(float w, float wm1,
                                          float wm2) const {
    return __fadd_rn(__fadd_rn(w, __fmul_rn(t1, wm1)), __fmul_rn(t2, wm2));
  }

  __device__ __forceinline__ void step(float w) {
    const float x = filter(w, w1, w2);
    a1 = __fadd_rn(a1, __fmul_rn(x, x1));
    a2 = __fadd_rn(a2, __fmul_rn(x, x2));
    x2 = x1;
    x1 = x;
    w2 = w1;
    w1 = w;
  }

  __device__ __forceinline__ void close1() {
    s1 = __dadd_rn(s1, static_cast<double>(a1));
    a1 = 0.f;
  }

  __device__ __forceinline__ void close2() {
    s2 = __dadd_rn(s2, static_cast<double>(a2));
    a2 = 0.f;
  }

  __device__ __forceinline__ float distance(float o1, float o2,
                                            int n_obs) {
    close1();
    close2();
    const double d1 = __dsub_rn(__ddiv_rn(s1, n_obs - 1), o1);
    const double d2 = __dsub_rn(__ddiv_rn(s2, n_obs - 2), o2);
    return static_cast<float>(
        sqrt(__dadd_rn(__dmul_rn(d1, d1), __dmul_rn(d2, d2))));
  }
};

// Normals w_{4q} .. w_{4q+3} from the kernel's own Philox stream.
struct PhiloxDraw {
  const PhiloxKey& key;
  int64_t sim;
  __device__ __forceinline__ float4 operator()(int q) const {
    const uint4 r = philox_block(key, sim, static_cast<uint32_t>(q));
    const float2 z0 = box_muller_fast(r.x, r.y);
    const float2 z1 = box_muller_fast(r.z, r.w);
    return make_float4(z0.x, z0.y, z1.x, z1.y);
  }
};

// Normals w_{4q} .. w_{4q+3} read from a (batch, n_w) row; past the row's
// end they are 0 and unused.
struct NoiseDraw {
  const float* row;
  int n_w;
  __device__ __forceinline__ float4 operator()(int q) const {
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      v[t] = 4 * q + t < n_w ? row[4 * q + t] : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Values w_k .. w_{k+7} for k = 4 (mod 8).  Lag-1 term j is added at
// k = j + 3 and lag-2 term j at k = j + 4, so the blocks [8b, 8b + 8) close
// after the values with k = 2 and k = 3 (mod 8): places 6 and 7 here.  With
// kTail, values past n_w are neither drawn nor added; a block closed early
// is the sum's last, and the closes after it add 0.
template <bool kTail, class Draw>
__device__ __forceinline__ void eight_values(Ma2Stats& st, const Draw& draw,
                                             int k, int n_w) {
  static_assert(kBlock == 8, "the blocks close at places 6 and 7");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 w = !kTail || k + 4 * h < n_w
                         ? draw((k >> 2) + h)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!kTail || k + 4 * h + t < n_w) st.step(v[t]);
      if (h == 1 && t == 2) st.close1();
      if (h == 1 && t == 3) st.close2();
    }
  }
}

// kSeedIn: the stream's seed is read from `seed` in device memory (a graph
// refills it before each replay) and its keys are made per thread.
template <bool kNoiseIn, bool kSeedIn>
__global__ void __launch_bounds__(kThreads)
ma2_distance_kernel(const float* __restrict__ t1,
                    const float* __restrict__ t2,
                    const float* __restrict__ obs,
                    const float* __restrict__ noise,
                    float* __restrict__ out, int64_t batch, int n_obs,
                    const __grid_constant__ PhiloxKey key,
                    const unsigned long long* __restrict__ seed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  const int n_w = n_obs + 2;
  auto run = [&](const auto& draw) {
    Ma2Stats st(t1[i], t2[i], draw(0));
    int k = 4;
    for (; k + 8 <= n_w; k += 8) eight_values<false>(st, draw, k, n_w);
    if (k < n_w) eight_values<true>(st, draw, k, n_w);
    return st.distance(obs[0], obs[1], n_obs);
  };
  if constexpr (kNoiseIn) {
    out[i] = run(NoiseDraw{noise + i * n_w, n_w});
  } else if constexpr (kSeedIn) {
    const PhiloxKey own = elfi::philox_key(__ldg(seed));
    out[i] = run(PhiloxDraw{own, i});
  } else {
    out[i] = run(PhiloxDraw{key, i});
  }
}

// The kernels' own normals: row i holds the first n normals of simulation
// i's stream under `seed`, as PhiloxDraw gives them.  For checking their
// distribution; not a path.
__global__ void __launch_bounds__(kThreads)
philox_normals_kernel(float* __restrict__ out, int64_t batch, int n,
                      const __grid_constant__ PhiloxKey key) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  const PhiloxDraw draw{key, i};
  for (int q = 0; 4 * q < n; ++q) {
    const float4 w = draw(q);
    const float v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * q + t < n) out[i * n + 4 * q + t] = v[t];
  }
}

template <bool kNoiseIn, bool kSeedIn>
int launch(const float* t1, const float* t2, const float* obs,
           const float* noise, float* out, long long batch, int n_obs,
           unsigned long long seed, const unsigned long long* seed_in,
           int device, void* stream) {
  if (batch < 1 || n_obs < 3 || (kSeedIn && seed_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (batch + kThreads - 1) / kThreads;
  ma2_distance_kernel<kNoiseIn, kSeedIn>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(t1, t2, obs, noise, out, batch,
                                              n_obs, elfi::philox_key(seed),
                                              seed_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w drawn in the kernel from Philox keyed by `seed`.
int elfi_ma2_distance(const float* t1, const float* t2, const float* obs,
                      float* out, long long batch, int n_obs,
                      unsigned long long seed, int device, void* stream) {
  return launch<false, false>(t1, t2, obs, nullptr, out, batch, n_obs, seed,
                              nullptr, device, stream);
}

// The same, with the seed read from `seed` in device memory when the kernel
// runs: how a CUDA graph that is replayed for many batches keys it.
int elfi_ma2_distance_seed_in(const float* t1, const float* t2,
                              const float* obs, float* out, long long batch,
                              int n_obs, const unsigned long long* seed,
                              int device, void* stream) {
  return launch<false, true>(t1, t2, obs, nullptr, out, batch, n_obs, 0ull,
                             seed, device, stream);
}

// w read from `noise`, (batch, n_obs + 2) row-major: the same filter,
// autocovariances and distance, for exact comparison with the plain
// version.  Its loads are strided across a warp; it is a check, not a path.
int elfi_ma2_distance_noise(const float* t1, const float* t2,
                            const float* obs, const float* noise, float* out,
                            long long batch, int n_obs, int device,
                            void* stream) {
  return launch<true, false>(t1, t2, obs, noise, out, batch, n_obs, 0ull,
                             nullptr, device, stream);
}

// The normals of philox_normals_kernel into `out`, (batch, n) row-major.
int elfi_philox_normals(float* out, long long batch, int n,
                        unsigned long long seed, int device, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  philox_normals_kernel<<<static_cast<unsigned>((batch + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, batch, n, elfi::philox_key(seed));
  return static_cast<int>(cudaGetLastError());
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
