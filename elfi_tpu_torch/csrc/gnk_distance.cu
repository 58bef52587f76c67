// Fused g-and-k simulate -> order statistics -> distance kernel for Hopper
// (sm_90a).
//
// Replaces the TPU kernel elfi_tpu/ops/pallas_kernels.py:_gnk_kernel (with
// its helpers _bitonic_sort_rows and _sincos_2pi).  Per simulation i it
// draws z_0 .. z_{n_obs-1} ~ N(0, 1), pushes each through the g-and-k
// quantile function
//     y = A + B (1 + c tanh(g z / 2)) exp(k log1p(z^2)) z
// (tanh in its overflow-stable form), sorts the n_obs values ascending, and
// writes the euclidean distance between them and the sorted observed sample.
//
// What bounds it on this card: each simulation reads 16 bytes (A, B, g, k)
// and writes 4, but computes n_obs normals (Philox + Box-Muller), two expf
// and a log1pf per value, and a 64-input sorting network of 672
// compare-exchanges.  That is thousands of instructions per 20 bytes: the
// kernel is bound by the FP32 pipes and the special-function units, never
// by HBM bandwidth.
//
// What the design does about it: the TPU kernel laid out a (64 rows x 2048
// lanes) block in VMEM and sorted over sublanes.  Here ONE THREAD CARRIES
// ONE SIMULATION: its 64 values live in a float[64] in registers, rows at
// or past n_obs hold +inf (so they sort to the end), and a bitonic network
// whose indices are all compile-time constants sorts them in place.  Every
// loop over the array is fully unrolled, which is what keeps it out of
// local memory (ptxas -v reports the spills).  Nothing touches shared or
// device memory between the parameter loads and the distance store.
//
// RNG: philox.cuh, keyed by the node's 64-bit stream seed with counter
// (simulation index, draw block), as in the MA2 kernel: ceil(n_obs / 2)
// Box-Muller pairs, four normals per Philox call.
//
// Numerics: the transform rounds each product, sum and quotient separately
// (no FMA contraction) with the accurate expf / log1pf, as the plain
// version's elementwise ops do; the squared differences to the observed
// sample are summed in double and rounded to float at the end, as the plain
// version sums them.  The sort's fminf / fmaxf agree with the JAX network's
// minimum / maximum on finite values and +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using elfi::box_muller;
using elfi::philox_block;

constexpr int kThreads = 128;
constexpr int kLogRows = 6;
constexpr int kRows = 1 << kLogRows;   // order-statistic rows; n_obs <= kRows

// The g-and-k quantile function at z, in the TPU kernel's form.
__device__ __forceinline__ float gnk_transform(float z, float A, float B,
                                               float g, float k, float c) {
  const float x = __fmul_rn(__fmul_rn(0.5f, g), z);
  const float e = expf(-2.0f * fabsf(x));
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float t = __fdiv_rn(__fmul_rn(sgn, __fsub_rn(1.0f, e)),
                            __fadd_rn(1.0f, e));
  const float p = expf(__fmul_rn(k, log1pf(__fmul_rn(z, z))));
  const float scale = __fmul_rn(B, __fadd_rn(1.0f, __fmul_rn(c, t)));
  return __fadd_rn(A, __fmul_rn(__fmul_rn(scale, p), z));
}

// Ascending bitonic sort of y in place.  All three loops have constant trip
// counts and unroll completely, so every index is a compile-time constant
// and y stays in registers.  Stage (k, j) compare-exchanges rows i and
// i | j for every i with bit j clear, ascending iff (i & k) == 0: the JAX
// network's order (a 2j-block at row r lies inside one k-aligned segment).
__device__ __forceinline__ void bitonic_sort(float (&y)[kRows]) {
#pragma unroll
  for (int ks = 1; ks <= kLogRows; ++ks) {
#pragma unroll
    for (int js = ks - 1; js >= 0; --js) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int j = 1 << js;
        if ((i & j) == 0) {
          const int l = i | j;
          const float lo = fminf(y[i], y[l]);
          const float hi = fmaxf(y[i], y[l]);
          const bool up = (i & (1 << ks)) == 0;
          y[i] = up ? lo : hi;
          y[l] = up ? hi : lo;
        }
      }
    }
  }
}

// Euclidean distance between the first n_obs sorted rows and obs, summed in
// double.
__device__ __forceinline__ float sorted_distance(const float (&y)[kRows],
                                                 const float* __restrict__ obs,
                                                 int n_obs) {
  double s = 0.0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < n_obs) {
      const double d = __dsub_rn(static_cast<double>(y[r]),
                                 static_cast<double>(obs[r]));
      s = __dadd_rn(s, __dmul_rn(d, d));
    }
  }
  return static_cast<float>(sqrt(s));
}

template <bool kNoiseIn>
__global__ void __launch_bounds__(kThreads)
gnk_distance_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ g, const float* __restrict__ k,
                    const float* __restrict__ obs,
                    const float* __restrict__ noise, float* __restrict__ out,
                    int64_t batch, int n_obs, float c, uint64_t seed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  const float a = A[i], b = B[i], gg = g[i], kk = k[i];
  float y[kRows];
  if constexpr (kNoiseIn) {
    const float* z = noise + i * n_obs;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      y[r] = r < n_obs ? gnk_transform(z[r], a, b, gg, kk, c) : INFINITY;
  } else {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int r = 4 * q;
      y[r] = y[r + 1] = y[r + 2] = y[r + 3] = INFINITY;
      if (r < n_obs) {
        const uint4 w = philox_block(seed, i, static_cast<uint32_t>(q));
        const float2 z0 = box_muller(w.x, w.y);
        y[r] = gnk_transform(z0.x, a, b, gg, kk, c);
        if (r + 1 < n_obs) y[r + 1] = gnk_transform(z0.y, a, b, gg, kk, c);
        if (r + 2 < n_obs) {
          const float2 z1 = box_muller(w.z, w.w);
          y[r + 2] = gnk_transform(z1.x, a, b, gg, kk, c);
          if (r + 3 < n_obs) y[r + 3] = gnk_transform(z1.y, a, b, gg, kk, c);
        }
      }
    }
  }
  bitonic_sort(y);
  out[i] = sorted_distance(y, obs, n_obs);
}

// The network alone on given rows, for exact comparison with torch.sort.
__global__ void __launch_bounds__(kThreads)
gnk_sort_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int64_t batch) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  float y[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) y[r] = in[i * kRows + r];
  bitonic_sort(y);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[i * kRows + r] = y[r];
}

unsigned blocks_for(long long batch) {
  return static_cast<unsigned>((batch + kThreads - 1) / kThreads);
}

template <bool kNoiseIn>
int launch(const float* A, const float* B, const float* g, const float* k,
           const float* obs, const float* noise, float* out, long long batch,
           int n_obs, float c, unsigned long long seed, int device,
           void* stream) {
  if (batch < 1 || n_obs < 1 || n_obs > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnk_distance_kernel<kNoiseIn>
      <<<blocks_for(batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          A, B, g, k, obs, noise, out, batch, n_obs, c, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z drawn in the kernel from Philox keyed by `seed`; obs holds the n_obs
// observed values in ascending order.
int elfi_gnk_distance(const float* A, const float* B, const float* g,
                      const float* k, const float* obs, float* out,
                      long long batch, int n_obs, float c,
                      unsigned long long seed, int device, void* stream) {
  return launch<false>(A, B, g, k, obs, nullptr, out, batch, n_obs, c, seed,
                       device, stream);
}

// z read from `noise`, (batch, n_obs) row-major: the same transform, sort
// and distance, for exact comparison with the plain version.  Its loads are
// strided across a warp; it is a check, not a path.
int elfi_gnk_distance_noise(const float* A, const float* B, const float* g,
                            const float* k, const float* obs,
                            const float* noise, float* out, long long batch,
                            int n_obs, float c, int device, void* stream) {
  return launch<true>(A, B, g, k, obs, noise, out, batch, n_obs, c, 0ull,
                      device, stream);
}

// The sorting network on `in`, (batch, 64) row-major, into `out`.
int elfi_gnk_sort_rows(const float* in, float* out, long long batch,
                       int device, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnk_sort_rows_kernel<<<blocks_for(batch), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(in, out, batch);
  return static_cast<int>(cudaGetLastError());
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
