// Fused MA(2) simulate -> summarise -> distance kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel elfi_tpu/ops/pallas_kernels.py:_ma2_kernel.  Per
// simulation i it draws w_0 .. w_{n_obs+1} ~ N(0, 1), forms the MA(2)
// series x_j = w_{j+2} + t1 w_{j+1} + t2 w_j (j < n_obs), takes the lag-1
// and lag-2 autocovariances s1 = mean_j x_{j+1} x_j and s2 = mean_j
// x_{j+2} x_j, and writes sqrt((s1 - o1)^2 + (s2 - o2)^2).
//
// What bounds it on this card: each simulation reads 8 bytes (t1, t2) and
// writes 4, but computes ~102 normals, each costing a share of a
// Philox4x32-10 call (10 rounds of 32-bit multiplies) and of a Box-Muller
// pair (logf, sqrtf, sincospif on the special-function units).  That is
// thousands of instructions per 12 bytes, so the kernel is bound by the
// integer/FP pipes and the SFUs, never by HBM bandwidth.
//
// What the design does about it: the TPU kernel laid a (time x 4096-lane)
// block out in VMEM; here the recurrence streams, so ONE THREAD CARRIES
// ONE SIMULATION with O(1) state in registers (the two previous w, the two
// previous x, two running sums) and nothing touches shared or device
// memory between the parameter load and the distance store.  Every
// Box-Muller draw yields both normals and every Philox call feeds two
// pairs.  The accurate logf/sqrtf/sincospif are used (no fast math yet).
//
// RNG: Philox4x32-10 keyed by the node's 64-bit stream seed, with counter
// (simulation index, draw block), so the result does not depend on the
// block size or the grid (philox.cuh, shared with the g-and-k kernel).
// The streams differ from torch.randn's; the kernel agrees with the plain
// PyTorch version statistically, and exactly (up to summation order) when
// both are fed the same noise through the kNoiseIn entry below.
//
// Numerics: the filter and the distance round each product and sum
// separately (no FMA contraction), as the plain version's elementwise ops
// do; the lag products are rounded to float and summed in double, as the
// plain version sums them, so the two agree to the last float bit or so
// even where the distance is a difference of nearly equal sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using elfi::box_muller;
using elfi::philox_block;

constexpr int kThreads = 256;

// Streaming MA(2) filter + lag-1/lag-2 autocovariances of one simulation.
struct Ma2Stats {
  float t1, t2;
  float w1 = 0.f, w2 = 0.f;  // w_{k-1}, w_{k-2}
  float x1 = 0.f, x2 = 0.f;  // x_{j-1}, x_{j-2}
  double s1 = 0.0, s2 = 0.0;
  int k = 0;                 // number of w pushed so far

  __device__ Ma2Stats(float a, float b) : t1(a), t2(b) {}

  __device__ __forceinline__ void push(float w) {
    if (k >= 2) {
      const float x = __fadd_rn(__fadd_rn(w, __fmul_rn(t1, w1)),
                                __fmul_rn(t2, w2));   // x_{k-2}
      if (k >= 3) s1 += static_cast<double>(__fmul_rn(x, x1));
      if (k >= 4) s2 += static_cast<double>(__fmul_rn(x, x2));
      x2 = x1;
      x1 = x;
    }
    w2 = w1;
    w1 = w;
    ++k;
  }

  __device__ __forceinline__ float distance(float o1, float o2,
                                            int n_obs) const {
    const double d1 = s1 / (n_obs - 1) - o1;
    const double d2 = s2 / (n_obs - 2) - o2;
    return static_cast<float>(
        sqrt(__dadd_rn(__dmul_rn(d1, d1), __dmul_rn(d2, d2))));
  }
};

template <bool kNoiseIn>
__global__ void __launch_bounds__(kThreads)
ma2_distance_kernel(const float* __restrict__ t1,
                    const float* __restrict__ t2,
                    const float* __restrict__ obs,
                    const float* __restrict__ noise,
                    float* __restrict__ out, int64_t batch, int n_obs,
                    uint64_t seed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  Ma2Stats st(t1[i], t2[i]);
  const int n_w = n_obs + 2;
  if constexpr (kNoiseIn) {
    const float* w = noise + i * n_w;
    for (int k = 0; k < n_w; ++k) st.push(w[k]);
  } else {
    for (int k = 0; k < n_w; k += 4) {
      const uint4 r = philox_block(seed, i, static_cast<uint32_t>(k >> 2));
      const float2 z0 = box_muller(r.x, r.y);
      st.push(z0.x);
      if (k + 1 < n_w) st.push(z0.y);
      if (k + 2 < n_w) {
        const float2 z1 = box_muller(r.z, r.w);
        st.push(z1.x);
        if (k + 3 < n_w) st.push(z1.y);
      }
    }
  }
  out[i] = st.distance(obs[0], obs[1], n_obs);
}

template <bool kNoiseIn>
int launch(const float* t1, const float* t2, const float* obs,
           const float* noise, float* out, long long batch, int n_obs,
           unsigned long long seed, int device, void* stream) {
  if (batch < 1 || n_obs < 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (batch + kThreads - 1) / kThreads;
  ma2_distance_kernel<kNoiseIn>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(t1, t2, obs, noise, out, batch,
                                              n_obs, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w drawn in the kernel from Philox keyed by `seed`.
int elfi_ma2_distance(const float* t1, const float* t2, const float* obs,
                      float* out, long long batch, int n_obs,
                      unsigned long long seed, int device, void* stream) {
  return launch<false>(t1, t2, obs, nullptr, out, batch, n_obs, seed, device,
                       stream);
}

// w read from `noise`, (batch, n_obs + 2) row-major: the same filter,
// autocovariances and distance, for exact comparison with the plain
// version.  Its loads are strided across a warp; it is a check, not a path.
int elfi_ma2_distance_noise(const float* t1, const float* t2,
                            const float* obs, const float* noise, float* out,
                            long long batch, int n_obs, int device,
                            void* stream) {
  return launch<true>(t1, t2, obs, noise, out, batch, n_obs, 0ull, device,
                      stream);
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
