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
// and writes 4 (42 MB, 12.5 us at 2^21 simulations), but at n_obs 50 it
// needs about 4,700 operations: 13 Philox4x32-10 calls and 25 Box-Muller
// pairs (philox.cuh), the transform (two expf, a log1pf and an IEEE
// divide, 57 a value in the SASS without the branches around their slow
// paths), 403 compare-exchanges (two FMNMX each, on the 64-lane pipe) and
// the distance: 0.294 ms at 2^21 at the issue rate (128 lanes per SM per
// clock); HBM would need 0.013.  The n_obs-50 instance compiles to 6,159
// SASS instructions, fully unrolled.
//
// What the design does about it: ONE THREAD CARRIES ONE SIMULATION, its
// rows in a float[kRows] in registers; nothing touches device memory
// between the parameter loads and the distance store.
// - The network is Batcher's odd-even merge sort, generated as straight
//   code (sort_network.cuh) per instance: kRows = 50 for the main path's
//   n_obs, pruned to the 403 comparators whose rows are all real, and
//   kRows = 64 for any other n_obs <= 64, whose rows >= n_obs hold +inf
//   (543 comparators).  Both sort exactly as torch.sort does.
// - Each group of four rows is drawn (one Philox call, two Box-Muller
//   pairs on the special-function units) and transformed straight into
//   the network's registers.  __launch_bounds__ caps the registers at
//   min_blocks blocks an SM: the 50-row instance needs 76 registers (6
//   blocks, 24 warps); capped at 7 blocks it spilled and gained 1 %.
// - The sorted observed sample is staged once per block in shared memory
//   as float32; the squared differences are summed in float32 over blocks
//   of kBlock rows, and only the block sums are converted to double.
// - The transform keeps the accurate expf / log1pf and the IEEE divide,
//   rounded op by op as the plain version rounds them; the sign of the
//   tanh is a copysign, which gives the same value as sign(x) * q.  With
//   __expf and __fdividef it ran 18 % faster but moved the distance by up
//   to 2.1e-6 relative (PERF.md, Findings).
//
// RNG: philox.cuh, keyed by the node's 64-bit stream seed with counter
// (simulation index, draw block), as in the MA2 kernel: ceil(n_obs / 2)
// Box-Muller pairs, four normals per Philox call.
//
// Numerics: the order of gnk_distance_reference in ops/kernels/gnk.py.
// The sort's fminf / fmaxf agree with the JAX network's minimum / maximum
// on finite values and +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "sort_network.cuh"

namespace {

using elfi::box_muller_fast;
using elfi::philox_block;
using elfi::PhiloxKey;
using elfi::sort_network;

constexpr int kThreads = 128;
constexpr int kMaxRows = 64;   // n_obs <= kMaxRows
constexpr int kMainRows = 50;  // the instance for n_obs == 50
// Squared differences summed in float32 per block of rows; the plain
// version (ops/kernels/_blocked.py, BLOCK) uses the same.
constexpr int kBlock = 8;

// Blocks of kThreads that each instance asks ptxas to fit on an SM.
constexpr int min_blocks(int rows) { return rows == kMainRows ? 6 : 5; }

// The g-and-k quantile function at z, in the TPU kernel's form; h = g / 2.
__device__ __forceinline__ float gnk_transform(float z, float A, float B,
                                               float h, float k, float c) {
  const float x = __fmul_rn(h, z);
  const float e = expf(-2.0f * fabsf(x));
  const float t = copysignf(__fdiv_rn(__fsub_rn(1.0f, e), __fadd_rn(1.0f, e)),
                            x);
  const float p = expf(__fmul_rn(k, log1pf(__fmul_rn(z, z))));
  const float scale = __fmul_rn(B, __fadd_rn(1.0f, __fmul_rn(c, t)));
  return __fadd_rn(A, __fmul_rn(__fmul_rn(scale, p), z));
}

// Euclidean distance between the first n rows of y and the observed sample
// in shared memory: float32 blocks of kBlock rows, added in double.
template <int kRows>
__device__ __forceinline__ float sorted_distance(const float (&y)[kRows],
                                                 const float* s_obs, int n) {
  double s = 0.0;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < n) {
      const float d = __fsub_rn(y[r], s_obs[r]);
      acc = __fadd_rn(acc, __fmul_rn(d, d));
    }
    if (r % kBlock == kBlock - 1 || r == kRows - 1) {
      s = __dadd_rn(s, static_cast<double>(acc));
      acc = 0.f;
    }
  }
  return static_cast<float>(sqrt(s));
}

// The seed of a launch keyed from device memory: the launcher copies it
// here from the caller's pointer, on the launch's stream, just before the
// launch (in a CUDA graph, a copy node before each kernel node).  Read
// from the constant bank, the seed and the round keys made from it are
// the same for every thread and stay out of the kernel's registers (held
// in registers, the 50-row instance spilled at 6 blocks an SM, and at 5
// it took 1.12 of the value path's time).
__constant__ unsigned long long c_seed;

// kSeedIn: the stream's seed is c_seed.
template <int kRows, bool kNoiseIn, bool kSeedIn>
__global__ void __launch_bounds__(kThreads, min_blocks(kRows))
gnk_distance_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ g, const float* __restrict__ k,
                    const float* __restrict__ obs,
                    const float* __restrict__ noise, float* __restrict__ out,
                    int64_t batch, int n_obs, float c,
                    const __grid_constant__ PhiloxKey key_arg) {
  __shared__ __align__(16) float s_obs[kRows];
  // the main instance's n_obs is a constant, so its guards fold away
  const int n = kRows == kMaxRows ? n_obs : kRows;
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    s_obs[r] = r < n ? obs[r] : 0.f;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  const float a = A[i], b = B[i], h = 0.5f * g[i], kk = k[i];
  float y[kRows];
  if constexpr (kNoiseIn) {
    const float* z = noise + i * n;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      y[r] = r < n ? gnk_transform(z[r], a, b, h, kk, c) : INFINITY;
  } else {
    // c_seed's round keys are made where each round uses them
    unsigned long long s = 0;
    if constexpr (kSeedIn) s = c_seed;
    const uint32_t sa = static_cast<uint32_t>(s);
    const uint32_t sb = static_cast<uint32_t>(s >> 32);
#pragma unroll
    for (int q = 0; q < (kRows + 3) / 4; ++q) {
      const int r = 4 * q;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (r + t < kRows) y[r + t] = INFINITY;
      if (r < n) {
        const uint4 w =
            kSeedIn ? philox_block(sa, sb, i, static_cast<uint32_t>(q))
                    : philox_block(key_arg, i, static_cast<uint32_t>(q));
        const float2 z0 = box_muller_fast(w.x, w.y);
        y[r] = gnk_transform(z0.x, a, b, h, kk, c);
        if (r + 1 < kRows && r + 1 < n)
          y[r + 1] = gnk_transform(z0.y, a, b, h, kk, c);
        if (r + 2 < kRows && r + 2 < n) {
          const float2 z1 = box_muller_fast(w.z, w.w);
          y[r + 2] = gnk_transform(z1.x, a, b, h, kk, c);
          if (r + 3 < kRows && r + 3 < n)
            y[r + 3] = gnk_transform(z1.y, a, b, h, kk, c);
        }
      }
    }
  }
  sort_network<kRows>(y);
  out[i] = sorted_distance<kRows>(y, s_obs, n);
}

// The network alone on given rows, for exact comparison with torch.sort.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
gnk_sort_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int64_t batch) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;
  float y[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) y[r] = in[i * kRows + r];
  sort_network<kRows>(y);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[i * kRows + r] = y[r];
}

unsigned blocks_for(long long batch) {
  return static_cast<unsigned>((batch + kThreads - 1) / kThreads);
}

template <bool kNoiseIn, bool kSeedIn>
int launch(const float* A, const float* B, const float* g, const float* k,
           const float* obs, const float* noise, float* out, long long batch,
           int n_obs, float c, unsigned long long seed,
           const unsigned long long* seed_in, int device, void* stream) {
  if (batch < 1 || n_obs < 1 || n_obs > kMaxRows ||
      (kSeedIn && seed_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const PhiloxKey key = elfi::philox_key(seed);
  if constexpr (kSeedIn) {
    err = cudaMemcpyToSymbolAsync(c_seed, seed_in, sizeof(c_seed), 0,
                                  cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_obs == kMainRows)
    gnk_distance_kernel<kMainRows, kNoiseIn, kSeedIn>
        <<<blocks_for(batch), kThreads, 0, s>>>(
            A, B, g, k, obs, noise, out, batch, n_obs, c, key);
  else
    gnk_distance_kernel<kMaxRows, kNoiseIn, kSeedIn>
        <<<blocks_for(batch), kThreads, 0, s>>>(
            A, B, g, k, obs, noise, out, batch, n_obs, c, key);
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
  return launch<false, false>(A, B, g, k, obs, nullptr, out, batch, n_obs, c,
                              seed, nullptr, device, stream);
}

// The same, with the seed read from `seed` in device memory on the stream
// (copied to c_seed before the kernel): how a CUDA graph that is replayed
// for many batches keys it.
int elfi_gnk_distance_seed_in(const float* A, const float* B, const float* g,
                              const float* k, const float* obs, float* out,
                              long long batch, int n_obs, float c,
                              const unsigned long long* seed, int device,
                              void* stream) {
  return launch<false, true>(A, B, g, k, obs, nullptr, out, batch, n_obs, c,
                             0ull, seed, device, stream);
}

// z read from `noise`, (batch, n_obs) row-major: the same transform, sort
// and distance, for exact comparison with the plain version.  Its loads are
// strided across a warp; it is a check, not a path.
int elfi_gnk_distance_noise(const float* A, const float* B, const float* g,
                            const float* k, const float* obs,
                            const float* noise, float* out, long long batch,
                            int n_obs, float c, int device, void* stream) {
  return launch<true, false>(A, B, g, k, obs, noise, out, batch, n_obs, c,
                             0ull, nullptr, device, stream);
}

// The network of the `rows`-row instance (50 or 64) on `in`, (batch, rows)
// row-major, into `out`.
int elfi_gnk_sort_rows(const float* in, float* out, long long batch,
                       int rows, int device, void* stream) {
  if (batch < 1 || (rows != kMainRows && rows != kMaxRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows == kMainRows)
    gnk_sort_rows_kernel<kMainRows><<<blocks_for(batch), kThreads, 0, s>>>(
        in, out, batch);
  else
    gnk_sort_rows_kernel<kMaxRows><<<blocks_for(batch), kThreads, 0, s>>>(
        in, out, batch);
  return static_cast<int>(cudaGetLastError());
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
