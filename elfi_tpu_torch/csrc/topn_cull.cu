// Threshold-culled top-N merge for Hopper (sm_90a).
//
// Replaces elfi_tpu/ops/topk.py:merge_core_culled (XLA there, not Pallas):
// the merge of one batch of distances into the sorted running buffer of
// the N best rows, which keeps the rejection loop on the device.  The
// result is the flat merge's, bit for bit: the first N of a stable
// ascending sort of [buffer keys, batch keys], ties to the lower
// concatenation index, rejected rows (a distance column above its
// threshold, or NaN) keyed +inf.
//
// What bounds it on this card: the batch's distances are read once (8 MiB
// at 2^21 rows, 2.5 us at 3.35 TB/s); everything else touches O(N) rows.
// The flat merge sorts all B + N keys (a radix sort, several passes over
// 16 MiB of key-index pairs) and gathers through a concatenation of every
// column.  The cull needs only the rows that beat the buffer's N-th key
// kth, since the buffer is sorted and a batch key equal to kth loses its
// tie to the buffer row: after the first merges of a run that is O(N / t)
// rows at batch t.
//
// What the design does about it, in one host call (no host read):
// - cull_scan_kernel, one pass over the batch on the whole card: the
//   effective key, the acceptance count (one atomic a block) and the rows
//   whose key beats kth, appended through one atomic a warp as
//   (key, concatenation index) pairs packed into 64 bits, so that one
//   unsigned comparison orders them as the flat merge does.  The atomics
//   lose the rows' order; the packed index restores it.
// - cull_merge_kernel, one block of 1024 threads: reads the candidate
//   count on the device and takes the candidates in chunks of `width`
//   (a power of two; dynamic shared memory).  Each chunk keeps the pairs
//   that beat the running N-th pair, sorts them in shared memory (bitonic,
//   padded to the power of two above their count) and merges them with the
//   running buffer by merge path, keeping the first N (no two pairs are
//   equal: each index is unique).  A count above `width` takes several
//   chunks and stays exact; the host sends a buffer's first merges, where
//   every accepted row is a candidate, to the flat merge (ops/topk.py,
//   merge_scan).
// - gather_rows_kernel: each output row of every carried column, copied
//   from the buffer or the batch by the index map, columns of any dtype
//   and trailing shape (a row is bytes; a batch column may be strided).
//
// Keys are compared as their order-preserving unsigned images (negative
// floats flipped, positive ones with the sign bit set): the order of a
// radix sort, which puts NaN last as torch.sort does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanBlocksPerSm = 8;
constexpr int kMergeThreads = 1024;
constexpr int kMaxWidth = 1 << 14;  // 128 KiB of shared memory
constexpr int kGatherThreads = 256;
constexpr int kMaxColumns = 16;     // columns per gather launch
constexpr unsigned long long kPad = ~0ull;
constexpr int kMaxDevices = 64;

// Per device, read once: the SM count, and the dynamic shared memory the
// merge kernel has been allowed (both idempotent, so a race is harmless).
int g_sms[kMaxDevices];
size_t g_smem[kMaxDevices];

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key,
                                                   unsigned long long idx) {
  return (static_cast<unsigned long long>(key) << 32) | idx;
}

// counters[0]: rows accepted; counters[1]: candidates (rows beating kth),
// written to cand[0 .. counters[1]).
__global__ void __launch_bounds__(kScanThreads) cull_scan_kernel(
    const float* __restrict__ d, long long batch, int cols, long long ld,
    const float* __restrict__ thr_vec, int thr_len, float thr_scalar,
    const float* __restrict__ buf_keys, int n,
    unsigned long long* __restrict__ counters,
    unsigned long long* __restrict__ cand) {
  __shared__ unsigned long long warp_acc[kScanThreads / 32];
  const uint32_t kth = order_bits(buf_keys[n - 1]);
  const unsigned lane = threadIdx.x & 31u;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned long long accepted = 0;
  // the bound depends on the block only, so every lane of a warp takes the
  // same trips and the ballot below is warp-wide
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < batch; base += step) {
    const long long i = base + threadIdx.x;
    bool beats = false;
    uint32_t u = 0;
    if (i < batch) {
      const float* row = d + i * ld;
      bool ok = true;
      for (int c = 0; c < cols; ++c) {
        const float t = thr_len == 0 ? thr_scalar
                                     : thr_vec[thr_len == 1 ? 0 : c];
        ok = ok && row[c] <= t;
      }
      accepted += ok ? 1ull : 0ull;
      u = order_bits(ok ? row[cols - 1] : __int_as_float(0x7f800000));
      beats = u < kth;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, beats);
    if (mask != 0u) {
      const int leader = __ffs(mask) - 1;
      unsigned long long slot = 0;
      if (static_cast<int>(lane) == leader)
        slot = atomicAdd(&counters[1],
                         static_cast<unsigned long long>(__popc(mask)));
      slot = __shfl_sync(0xffffffffu, slot, leader);
      if (beats)
        cand[slot + __popc(mask & ((1u << lane) - 1u))] =
            pack(u, static_cast<unsigned long long>(n) + i);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    accepted += __shfl_down_sync(0xffffffffu, accepted, off);
  if (lane == 0) warp_acc[threadIdx.x >> 5] = accepted;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) total += warp_acc[w];
    if (total) atomicAdd(&counters[0], total);
  }
}

// Entry i of the running buffer: `run` once a chunk has been merged, the
// input buffer (row i, key buf_keys[i]) before.
__device__ __forceinline__ unsigned long long entry(
    const unsigned long long* run, const float* buf_keys, int i) {
  return run ? run[i] : pack(order_bits(buf_keys[i]),
                             static_cast<unsigned long long>(i));
}

__global__ void __launch_bounds__(kMergeThreads) cull_merge_kernel(
    const float* __restrict__ buf_keys, int n,
    const unsigned long long* __restrict__ counters,
    const unsigned long long* __restrict__ cand, int width,
    unsigned long long* run0, unsigned long long* run1,
    float* __restrict__ out_keys,
    long long* __restrict__ out_idx) {
  extern __shared__ unsigned long long chunk[];
  __shared__ unsigned survivors;
  const unsigned long long count = counters[1];
  const unsigned long long* src = nullptr;
  unsigned long long* dst = run0;
  for (unsigned long long start = 0; start < count; start += width) {
    const int m_raw = static_cast<int>(
        count - start < static_cast<unsigned long long>(width)
            ? count - start : static_cast<unsigned long long>(width));
    const unsigned long long last = entry(src, buf_keys, n - 1);
    if (threadIdx.x == 0) survivors = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < m_raw; t += blockDim.x) {
      const unsigned long long c = cand[start + t];
      if (c < last) chunk[atomicAdd(&survivors, 1u)] = c;
    }
    __syncthreads();
    const int m = static_cast<int>(survivors);
    __syncthreads();  // every thread has read it before the next reset
    if (m == 0) continue;

    int p = 1;
    while (p < m) p <<= 1;
    for (int t = m + threadIdx.x; t < p; t += blockDim.x) chunk[t] = kPad;
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < (p >> 1); t += blockDim.x) {
          const int lo = 2 * t - (t & (j - 1));
          const int hi = lo + j;
          const unsigned long long a = chunk[lo], b = chunk[hi];
          if ((a > b) == ((lo & k) == 0)) {
            chunk[lo] = b;
            chunk[hi] = a;
          }
        }
        __syncthreads();
      }
    }

    // merge path: thread t writes outputs [k0, k1) of merge(run, chunk)
    const int per = (n + kMergeThreads - 1) / kMergeThreads;
    const int k0 = min(n, static_cast<int>(threadIdx.x) * per);
    const int k1 = min(n, k0 + per);
    if (k0 < k1) {
      int lo = max(0, k0 - m), hi = min(k0, n);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (entry(src, buf_keys, mid) < chunk[k0 - 1 - mid])
          lo = mid + 1;
        else
          hi = mid;
      }
      int i = lo, j = k0 - lo;
      for (int k = k0; k < k1; ++k) {
        const unsigned long long a = i < n ? entry(src, buf_keys, i) : kPad;
        const unsigned long long b = j < m ? chunk[j] : kPad;
        if (a < b) {
          dst[k] = a;
          ++i;
        } else {
          dst[k] = b;
          ++j;
        }
      }
    }
    __syncthreads();
    src = dst;
    dst = dst == run0 ? run1 : run0;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const unsigned long long v = entry(src, buf_keys, k);
    out_keys[k] = from_order_bits(static_cast<uint32_t>(v >> 32));
    out_idx[k] = static_cast<long long>(v & 0xffffffffull);
  }
}

struct Column {
  const char* buf;         // (n, row_bytes), contiguous
  const char* batch;       // rows batch_stride bytes apart
  char* out;               // (n, row_bytes), contiguous
  long long row_bytes;
  long long batch_stride;
  int word;                // bytes per copy: 1, 2, 4 or 8
};

struct Columns {
  Column c[kMaxColumns];
};

template <typename T>
__device__ __forceinline__ void copy_row(const char* src, char* dst,
                                         long long bytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* o = reinterpret_cast<T*>(dst);
  const long long words = bytes / static_cast<long long>(sizeof(T));
  for (long long w = 0; w < words; ++w) o[w] = s[w];
}

// Column blockIdx.y, output row k: buffer row idx[k] if idx[k] < n, else
// batch row idx[k] - n.
__global__ void __launch_bounds__(kGatherThreads) gather_rows_kernel(
    Columns cols, const long long* __restrict__ idx, int n) {
  const Column col = cols.c[blockIdx.y];
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const long long s = idx[k];
    const char* src = s < n ? col.buf + s * col.row_bytes
                            : col.batch + (s - n) * col.batch_stride;
    char* o = col.out + static_cast<long long>(k) * col.row_bytes;
    switch (col.word) {
      case 8: copy_row<unsigned long long>(src, o, col.row_bytes); break;
      case 4: copy_row<unsigned int>(src, o, col.row_bytes); break;
      case 2: copy_row<unsigned short>(src, o, col.row_bytes); break;
      default: copy_row<unsigned char>(src, o, col.row_bytes); break;
    }
  }
}

}  // namespace

extern "C" {

// One merge: d (batch, cols) float32 with rows ld elements apart; the
// threshold thr_scalar (thr_len 0), thr_vec[0] (1) or thr_vec[c] (cols);
// buf_keys the sorted buffer's n keys.  Scratch: counters (2, zeroed
// here), cand (batch entries), run (2 n entries).  Out: the merged keys,
// the index map (row i < n of the buffer, or batch row i - n) and, per
// carried column, its merged rows; counters[0] is the acceptance count.
int elfi_topn_cull(const float* d, long long batch, int cols, long long ld,
                   const float* thr_vec, int thr_len, float thr_scalar,
                   const float* buf_keys, int n, int width,
                   unsigned long long* counters, unsigned long long* cand,
                   unsigned long long* run, float* out_keys,
                   long long* out_idx, int n_columns,
                   const void* const* col_buf, const void* const* col_batch,
                   void* const* col_out, const long long* row_bytes,
                   const long long* batch_stride, const int* word,
                   int device, void* stream) {
  if (batch < 1 || n < 1 || cols < 1 || n_columns < 0 ||
      width < 32 || width > kMaxWidth || (width & (width - 1)) != 0 ||
      static_cast<unsigned long long>(batch) + n >= 0xffffffffull ||
      (thr_len != 0 && thr_len != 1 && thr_len != cols))
    return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_sms[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device] = sms;
  }
  const int sms = g_sms[device];
  const auto s = static_cast<cudaStream_t>(stream);

  err = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks_needed = (batch + kScanThreads - 1) / kScanThreads;
  const long long blocks_max = static_cast<long long>(sms) * kScanBlocksPerSm;
  cull_scan_kernel<<<static_cast<unsigned>(blocks_needed < blocks_max
                                               ? blocks_needed : blocks_max),
                     kScanThreads, 0, s>>>(d, batch, cols, ld, thr_vec,
                                           thr_len, thr_scalar, buf_keys, n,
                                           counters, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = static_cast<size_t>(width) * sizeof(unsigned long long);
  if (g_smem[device] < smem) {
    err = cudaFuncSetAttribute(cull_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem[device] = smem;
  }
  cull_merge_kernel<<<1, kMergeThreads, smem, s>>>(
      buf_keys, n, counters, cand, width, run, run + n, out_keys, out_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int gather_blocks = (n + kGatherThreads - 1) / kGatherThreads;
  for (int c0 = 0; c0 < n_columns; c0 += kMaxColumns) {
    const int k = n_columns - c0 < kMaxColumns ? n_columns - c0 : kMaxColumns;
    Columns batch_cols;
    for (int c = 0; c < k; ++c) {
      batch_cols.c[c] = Column{static_cast<const char*>(col_buf[c0 + c]),
                               static_cast<const char*>(col_batch[c0 + c]),
                               static_cast<char*>(col_out[c0 + c]),
                               row_bytes[c0 + c], batch_stride[c0 + c],
                               word[c0 + c]};
    }
    gather_rows_kernel<<<dim3(gather_blocks, k), kGatherThreads, 0, s>>>(
        batch_cols, out_idx, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
