// Order statistics for Hopper (sm_90a): each row of a (batch, n) float32
// array sorted ascending, 1 <= n <= 64, values only.
//
// Replaces no Pallas kernel: the JAX package sorts its order-statistic
// summary with XLA, jnp.sort in elfi_tpu/models/gnk.py:43 ss_order.  The
// port's plain version is torch.sort(y, dim=1).values, a segmented radix
// sort that also writes an int64 index a value, which the summary drops.
//
// What bounds it on this card: bytes.  Each row is read once and written
// once, 8n bytes: at 2^21 rows of 50, 839 MB, 0.250 ms at 3.35 TB/s.  The
// network's 403 compare-exchanges a row (two FMNMX each, on the 64-lane
// pipe) take about 0.11 ms of the SMs' instruction throughput.
//
// What the design does about it: every byte moves once, coalesced, and no
// index is written.
// - A block of kThreads threads takes kThreads consecutive rows, one
//   contiguous span of kThreads * n values, and copies it into shared
//   memory with 16-byte loads, neighbouring threads on neighbouring
//   addresses.  The sorted span leaves the same way.
// - ONE THREAD SORTS ONE ROW, in registers, with the Batcher network that
//   the g-and-k kernel K2 runs (sort_network.cuh): the 50-row instance for
//   n 50 (403 comparators), the 64-row one with +inf pads for any other n.
// - Shared memory without bank conflicts.  At n 50 the rows lie packed and
//   a thread moves its row as float2 pairs: 25 words between rows, odd, so
//   a half-warp's 16 pairs fill the 32 banks.  The 64-row instance lays
//   its rows at an odd stride (n | 1) and moves them a value at a time.
//
// Same values as torch.sort.  fminf / fmaxf order finite values, +-inf and
// ties as a comparison sort does (-0 and +0 compare equal either way), but
// they would drop a NaN.  So a NaN enters the network as +inf, and the
// last (count of NaN) of the row's n places are written as NaN: torch.sort
// puts NaN last, after +inf, as jnp.sort does, and in a row shorter than
// its instance those places still come before the pads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sort_network.cuh"

namespace {

using elfi::sort_network;

constexpr int kThreads = 128;
constexpr int kMaxN = 64;   // n <= kMaxN
constexpr int kMainN = 50;  // the instance for n == 50

// Rows of kN values lie packed in shared memory, moved as float2 pairs,
// where kN / 2 is odd: then a half-warp's pairs lie on distinct banks.
__host__ __device__ constexpr bool packed(int kN) { return kN % 4 == 2; }
// Floats of shared memory a block uses: its rows at their stride.
__host__ __device__ constexpr int span_floats(int kN) {
  return kThreads * (packed(kN) ? kN : (kN | 1));
}

// Blocks of kThreads that each instance asks ptxas to fit on an SM.
constexpr int min_blocks(int kN) { return kN == kMainN ? 6 : 4; }

template <int kN>
__global__ void __launch_bounds__(kThreads, min_blocks(kN))
order_stats_sort_kernel(const float* __restrict__ in,
                        float* __restrict__ out, int64_t batch, int n_arg) {
  __shared__ __align__(16) float s[span_floats(kN)];
  // the main instance's n is a constant, so its guards and divisions fold
  const int n = kN == kMaxN ? n_arg : kN;
  const int stride = packed(kN) ? n : (n | 1);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(
      batch - row0 < kThreads ? batch - row0 : kThreads);
  const int count = rows * n;
  const float* src = in + row0 * n;
  float* dst = out + row0 * n;
  // a span starts 512 n bytes after the one before it, so every span is
  // 16-byte aligned where the arrays' starts are
  const bool vec =
      packed(kN) && ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst)) & 15) == 0;

  // the span into shared memory
  int done = 0;
  if (vec) {
    done = count & ~3;
#pragma unroll 4
    for (int q = threadIdx.x; q < count / 4; q += kThreads)
      reinterpret_cast<float4*>(s)[q] =
          __ldg(reinterpret_cast<const float4*>(src) + q);
  }
  for (int e = done + threadIdx.x; e < count; e += kThreads) {
    const int r = e / n;
    s[r * stride + (e - r * n)] = src[e];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    float y[kN];
    int nans = 0;
    if constexpr (packed(kN)) {
      const float2* row = reinterpret_cast<const float2*>(s + t * kN);
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) {
        const float2 v = row[j];
        y[2 * j] = v.x;
        y[2 * j + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        y[j] = j < n ? s[t * stride + j] : INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j < n && isnan(y[j])) {
        ++nans;
        y[j] = INFINITY;
      }
    }
    sort_network<kN>(y);
    const int keep = n - nans;
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (j >= keep) y[j] = nan;
    if constexpr (packed(kN)) {
      float2* row = reinterpret_cast<float2*>(s + t * kN);
#pragma unroll
      for (int j = 0; j < kN / 2; ++j)
        row[j] = make_float2(y[2 * j], y[2 * j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (j < n) s[t * stride + j] = y[j];
    }
  }
  __syncthreads();

  // the sorted span out
  if (vec) {
#pragma unroll 4
    for (int q = threadIdx.x; q < count / 4; q += kThreads)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(s)[q];
  }
  for (int e = done + threadIdx.x; e < count; e += kThreads) {
    const int r = e / n;
    dst[e] = s[r * stride + (e - r * n)];
  }
}

}  // namespace

extern "C" {

// Each row of `in`, (batch, n) row-major, sorted ascending into `out`.
int elfi_order_stats_sort(const float* in, float* out, long long batch,
                          int n, int device, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || in == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks =
      static_cast<unsigned>((batch + kThreads - 1) / kThreads);
  if (n == kMainN)
    order_stats_sort_kernel<kMainN><<<blocks, kThreads, 0, s>>>(in, out,
                                                                batch, n);
  else
    order_stats_sort_kernel<kMaxN><<<blocks, kThreads, 0, s>>>(in, out,
                                                               batch, n);
  return static_cast<int>(cudaGetLastError());
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
