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
// Only the rows that beat the buffer's N-th key kth matter (the buffer is
// sorted, and a batch key equal to kth loses its tie to the buffer row):
// after the first merges of a run that is about N B / (rows seen) rows.  At
// such counts a merge is bound by latency: launches, dependent loads and
// barriers, not bytes.
//
// What the design does about it: two launches a merge, no memset, no host
// read; the merge is a programmatic dependent of the scan, so its launch
// and its staging of the buffer's keys overlap the scan's end.
// - cull_scan_vec_kernel, one pass over the batch on the whole card
//   (cull_scan_kernel for any other layout): the effective key, the
//   acceptance count (one atomic a block) and the rows whose key beats kth,
//   appended through one atomic a warp as (key, concatenation index) pairs
//   packed into 64 bits, so that one unsigned comparison orders them as the
//   flat merge does and no two pairs are equal.  The atomics lose the
//   rows' order; the packed index restores it.  The main path's distance,
//   one contiguous float32 column, is read as float4s, 16 rows in flight
//   per thread.
// - cull_merge_kernel, one cluster of kClusterBlocks blocks on as many SMs:
//   rank and scatter, with no global sort and no merge pass.  The count is
//   read on the device and taken in passes of kCapacity candidates, one
//   pass on the main path.  Each block sorts its share of a pass (at most
//   kTile; by counting up to kCountSort, bitonic above) in shared memory
//   and pushes it into every block's shared memory (up to kLocalTiles
//   entries in all; above that the tiles are searched where they are,
//   through distributed shared memory).  After one cluster barrier a
//   candidate lands at its rank among all tiles plus the buffer entries
//   below it, a buffer entry i at i plus the candidates below it, each
//   count a binary lifting over sorted entries in the block's own shared
//   memory (the other blocks' tiles through distributed shared memory
//   above kLocalTiles, and the buffer in device memory after the first
//   pass or above kKeyStage entries); both counts are exact because the
//   pairs are unique.  The buffer's keys are staged in shared memory while
//   the count arrives.  Every
//   entry whose place is below N writes its key, its index and its row of
//   every carried column (rows are bytes, of any dtype and trailing shape;
//   a batch column may be strided; single-word rows load together before
//   they store) at that place: the gather is part of the scatter.  A count
//   above kCapacity takes more passes through run buffers in device
//   memory, exact for any count.  After the cluster's last barrier its
//   first block zeroes the counters, so the next call on the stream finds
//   them zero.  Measured against the alternatives (PERF.md, Findings): a
//   bitonic network on a share of 39 candidates took 21 barrier stages
//   (about 2.5 us), counting takes one; lifting every buffer entry over
//   the other blocks' tiles through distributed shared memory cost about
//   10 us a merge at n/16 candidates, and pushing the tiles first removes
//   it.
// - gather_rows_kernel, only for columns beyond the kMaxColumns that the
//   merge kernel takes as its argument.
//
// Keys are compared as their order-preserving unsigned images (negative
// floats flipped, positive ones with the sign bit set): the order of a
// radix sort, which puts NaN last as torch.sort does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanVec = 4;            // float4s in flight per thread
constexpr int kScanBlocksPerSm = 8;
constexpr int kClusterBlocks = 8;      // the merge's cluster (portable size)
constexpr int kMergeThreads = 512;
constexpr int kTile = 4096;            // candidates a block sorts in a pass
constexpr int kCapacity = kClusterBlocks * kTile;  // candidates in one pass
constexpr int kCountSort = kMergeThreads;  // tiles sorted by counting
constexpr int kLocalTiles = 16384;     // tile entries copied to each block
constexpr int kKeyStage = 8192;        // the buffer's keys in smem
constexpr int kKeyBatch = 8;           // key loads in flight per thread
constexpr int kMaxColumns = 32;        // columns the merge kernel writes
constexpr int kColumnBatch = 4;        // single-word rows loaded together
constexpr int kGatherThreads = 256;
constexpr unsigned long long kPad = ~0ull;
constexpr int kMaxDevices = 64;
constexpr size_t kMergeSmem =
    static_cast<size_t>(kTile + kLocalTiles + kCountSort) *
        sizeof(unsigned long long) +
    static_cast<size_t>(kKeyStage) * sizeof(uint32_t);

// Per device, read once: the SM count, and whether the merge kernel has
// been allowed its shared memory (both idempotent, so a race is harmless).
int g_sms[kMaxDevices];
bool g_smem_set[kMaxDevices];

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

// Appends, through one atomic of the warp, the pair of every lane whose
// `beats` is set.  Every lane of the warp calls it.
__device__ __forceinline__ void append(bool beats, uint32_t key,
                                       unsigned long long idx,
                                       unsigned long long* counter,
                                       unsigned long long* cand) {
  const unsigned mask = __ballot_sync(0xffffffffu, beats);
  if (mask == 0u) return;
  const unsigned lane = threadIdx.x & 31u;
  const int leader = __ffs(mask) - 1;
  unsigned long long slot = 0;
  if (static_cast<int>(lane) == leader)
    slot = atomicAdd(counter, static_cast<unsigned long long>(__popc(mask)));
  slot = __shfl_sync(0xffffffffu, slot, leader);
  if (beats) cand[slot + __popc(mask & ((1u << lane) - 1u))] = pack(key, idx);
}

// Adds the block's acceptance count to counters[0]; every thread calls it.
__device__ __forceinline__ void add_accepted(unsigned long long accepted,
                                             unsigned long long* counters) {
  __shared__ unsigned long long warp_acc[kScanThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    accepted += __shfl_down_sync(0xffffffffu, accepted, off);
  if ((threadIdx.x & 31u) == 0) warp_acc[threadIdx.x >> 5] = accepted;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) total += warp_acc[w];
    if (total) atomicAdd(&counters[0], total);
  }
}

// Rows 4 q .. 4 q + 3 of a contiguous column; NaN (never accepted, never a
// candidate) past the batch's end.
__device__ __forceinline__ float4 load_quad(const float* d, long long q,
                                            long long batch) {
  const long long i = 4 * q;
  if (i + 4 <= batch) return __ldg(reinterpret_cast<const float4*>(d) + q);
  const float nan = __int_as_float(0x7fc00000);
  return make_float4(i < batch ? d[i] : nan, i + 1 < batch ? d[i + 1] : nan,
                     i + 2 < batch ? d[i + 2] : nan, nan);
}

// counters[0]: rows accepted; counters[1]: candidates, written to
// cand[0 .. counters[1]).  One contiguous, 16-byte aligned float32 column.
__global__ void __launch_bounds__(kScanThreads) cull_scan_vec_kernel(
    const float* __restrict__ d, long long batch,
    const float* __restrict__ thr_vec, int thr_len, float thr_scalar,
    const float* __restrict__ buf_keys, int n,
    unsigned long long* __restrict__ counters,
    unsigned long long* __restrict__ cand) {
  // the merge may start now: it stages the buffer's keys, then waits for
  // this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  const float thr = thr_len == 0 ? thr_scalar : thr_vec[0];
  const uint32_t kth = order_bits(buf_keys[n - 1]);
  const long long quads = (batch + 3) >> 2;
  const long long span = static_cast<long long>(blockDim.x) * kScanVec;
  unsigned long long accepted = 0;
  // the bound depends on the block only, so every lane of a warp takes the
  // same trips and the warp-wide votes below see every lane
  for (long long base = static_cast<long long>(blockIdx.x) * span;
       base < quads; base += static_cast<long long>(gridDim.x) * span) {
    float4 v[kScanVec];
#pragma unroll
    for (int u = 0; u < kScanVec; ++u)
      v[u] = load_quad(d, base + u * blockDim.x + threadIdx.x, batch);
    uint32_t keys[4 * kScanVec];
    uint32_t beats = 0;  // bit 4 u + c: row 4 q + c beats kth
#pragma unroll
    for (int u = 0; u < kScanVec; ++u) {
      const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = x[c] <= thr;
        accepted += ok ? 1ull : 0ull;
        keys[4 * u + c] =
            order_bits(ok ? x[c] : __int_as_float(0x7f800000));
        beats |= (keys[4 * u + c] < kth ? 1u : 0u) << (4 * u + c);
      }
    }
    if (__any_sync(0xffffffffu, beats != 0u)) {
#pragma unroll
      for (int b = 0; b < 4 * kScanVec; ++b) {
        const long long row =
            4 * (base + (b / 4) * blockDim.x + threadIdx.x) + (b % 4);
        append((beats >> b) & 1u, keys[b],
               static_cast<unsigned long long>(n + row), &counters[1], cand);
      }
    }
  }
  add_accepted(accepted, counters);
}

// The same for any layout: d (batch, cols) float32 with rows ld elements
// apart; the threshold thr_scalar (thr_len 0), thr_vec[0] (1) or
// thr_vec[c] (cols).  The key is the last column.
__global__ void __launch_bounds__(kScanThreads) cull_scan_kernel(
    const float* __restrict__ d, long long batch, int cols, long long ld,
    const float* __restrict__ thr_vec, int thr_len, float thr_scalar,
    const float* __restrict__ buf_keys, int n,
    unsigned long long* __restrict__ counters,
    unsigned long long* __restrict__ cand) {
  asm volatile("griddepcontrol.launch_dependents;");
  const uint32_t kth = order_bits(buf_keys[n - 1]);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned long long accepted = 0;
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
    append(beats, u, static_cast<unsigned long long>(n) + i, &counters[1],
           cand);
  }
  add_accepted(accepted, counters);
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
  int count;
};

template <typename T>
__device__ __forceinline__ void copy_row(const char* src, char* dst,
                                         long long bytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* o = reinterpret_cast<T*>(dst);
  const long long words = bytes / static_cast<long long>(sizeof(T));
  for (long long w = 0; w < words; ++w) o[w] = s[w];
}

// Row s of [buffer, batch] in a column: buffer row s if s < n, else batch
// row s - n.
__device__ __forceinline__ const char* source_row(const Column& col,
                                                  long long s, int n) {
  return s < n ? col.buf + s * col.row_bytes
               : col.batch + (s - n) * col.batch_stride;
}

// Output row k of a column, from row s of [buffer, batch].
__device__ __forceinline__ void copy_column_row(const Column& col,
                                                long long s, int n,
                                                long long k) {
  const char* src = source_row(col, s, n);
  char* o = col.out + k * col.row_bytes;
  switch (col.word) {
    case 8: copy_row<unsigned long long>(src, o, col.row_bytes); break;
    case 4: copy_row<unsigned int>(src, o, col.row_bytes); break;
    case 2: copy_row<unsigned short>(src, o, col.row_bytes); break;
    default: copy_row<unsigned char>(src, o, col.row_bytes); break;
  }
}

// Entry i of the running buffer: `run` after a pass, the input buffer (row
// i, key buf_keys[i]) before.
__device__ __forceinline__ unsigned long long buffer_entry(
    const unsigned long long* run, const float* buf_keys, int i) {
  return run ? run[i] : pack(order_bits(buf_keys[i]),
                             static_cast<unsigned long long>(i));
}

// Entries of the running buffer below candidate x.  The input buffer's
// entry i is (key i, i) and x's index is at least n, so that is the keys
// at or below x's: counted over their order bits staged in shared memory
// when `keys` is set, else over the entries in device memory.
__device__ __forceinline__ int buffer_rank(const uint32_t* keys,
                                           const unsigned long long* run,
                                           const float* buf_keys, int n,
                                           unsigned long long x) {
  int k = 0;
  const uint32_t xk = static_cast<uint32_t>(x >> 32);
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
    if (k + step > n) continue;
    const int i = k + step - 1;
    if (keys ? keys[i] <= xk : buffer_entry(run, buf_keys, i) < x)
      k += step;
  }
  return k;
}

// Entries below x over every tile of the cluster.  Each tile holds p
// sorted entries (kPad past its own), so one lifting over p serves all;
// the tiles' loads of a step are independent and issue together.  The
// tiles are the block's copies, or the blocks' own in distributed shared
// memory.
__device__ __forceinline__ int cluster_rank(
    const unsigned long long* const (&tiles)[kClusterBlocks], int p,
    unsigned long long x) {
  int k[kClusterBlocks];
#pragma unroll
  for (int r = 0; r < kClusterBlocks; ++r) k[r] = 0;
  for (int step = p; step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r)
      if (k[r] + step <= p && tiles[r][k[r] + step - 1] < x) k[r] += step;
  }
  int total = 0;
#pragma unroll
  for (int r = 0; r < kClusterBlocks; ++r) total += k[r];
  return total;
}

// One compare-exchange stage of a bitonic sort over a[0, p): pair t of
// `threads` threads from `first`.
__device__ __forceinline__ void bitonic_stage(unsigned long long* a, int p,
                                              int k, int j, int first,
                                              int threads) {
  for (int t = first; t < (p >> 1); t += threads) {
    const int lo = 2 * t - (t & (j - 1));
    const int hi = lo + j;
    const unsigned long long x = a[lo], y = a[hi];
    if ((x > y) == ((lo & k) == 0)) {
      a[lo] = y;
      a[hi] = x;
    }
  }
}

// Ascending bitonic sort of a[0, p), p a power of two: by warp 0 alone (no
// block barrier a stage) up to 64 entries, by the block above.  Every
// thread of the block calls it.
__device__ void bitonic_sort(unsigned long long* a, int p) {
  if (p <= 64) {
    if (threadIdx.x < 32) {
      for (int k = 2; k <= p; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          bitonic_stage(a, p, k, j, threadIdx.x, 32);
          __syncwarp();
        }
    }
  } else {
    for (int k = 2; k <= p; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        bitonic_stage(a, p, k, j, threadIdx.x, blockDim.x);
        __syncthreads();
      }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long load_word(const char* p,
                                                        int word) {
  switch (word) {
    case 8: return *reinterpret_cast<const unsigned long long*>(p);
    case 4: return *reinterpret_cast<const unsigned int*>(p);
    case 2: return *reinterpret_cast<const unsigned short*>(p);
    default: return *reinterpret_cast<const unsigned char*>(p);
  }
}

__device__ __forceinline__ void store_word(char* p, int word,
                                           unsigned long long v) {
  switch (word) {
    case 8: *reinterpret_cast<unsigned long long*>(p) = v; break;
    case 4: *reinterpret_cast<unsigned int*>(p) = static_cast<unsigned>(v);
            break;
    case 2: *reinterpret_cast<unsigned short*>(p) =
                static_cast<unsigned short>(v);
            break;
    default: *p = static_cast<char>(v); break;
  }
}

// Places entry e at k: the merged key, index and every column's row on the
// last pass, the run buffer before.  Rows of one word (the main path's)
// are loaded kColumnBatch columns at a time before any of them is stored.
__device__ __forceinline__ void place(int k, unsigned long long e, bool last,
                                      unsigned long long* dst, int n,
                                      float* out_keys, long long* out_idx,
                                      const Columns& cols) {
  if (!last) {
    dst[k] = e;
    return;
  }
  const long long s = static_cast<long long>(e & 0xffffffffull);
  out_keys[k] = from_order_bits(static_cast<uint32_t>(e >> 32));
  out_idx[k] = s;
  for (int c0 = 0; c0 < cols.count; c0 += kColumnBatch) {
    unsigned long long v[kColumnBatch];
#pragma unroll
    for (int j = 0; j < kColumnBatch; ++j) {
      const Column col = cols.c[min(c0 + j, cols.count - 1)];
      v[j] = c0 + j < cols.count && col.row_bytes == col.word
                 ? load_word(source_row(col, s, n), col.word) : 0;
    }
#pragma unroll
    for (int j = 0; j < kColumnBatch; ++j) {
      if (c0 + j >= cols.count) continue;
      const Column col = cols.c[c0 + j];
      if (col.row_bytes == col.word)
        store_word(col.out + k * col.row_bytes, col.word, v[j]);
      else
        copy_column_row(col, s, n, k);
    }
  }
}

// One cluster: reads the candidate count, merges the candidates in passes
// of kCapacity (one on the main path), writes the merged keys, the index
// map (buffer row i < n, or batch row i - n), every column's rows and the
// acceptance count, and zeroes the counters for the next call.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kMergeThreads, 1) cull_merge_kernel(
        const float* __restrict__ buf_keys, int n,
        unsigned long long* counters,
        const unsigned long long* __restrict__ cand,
        unsigned long long* run0, unsigned long long* run1,
        float* __restrict__ out_keys, long long* __restrict__ out_idx,
        long long* __restrict__ out_acc, const Columns cols) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* tile = smem;
  unsigned long long* copies = tile + kTile;         // every block's tile
  unsigned long long* raw = copies + kLocalTiles;    // a tile to count
  uint32_t* key_stage = reinterpret_cast<uint32_t*>(raw + kCountSort);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  // the input buffer's keys, loaded while the scan ends: the first pass's
  // candidates lift over them and its buffer entries are read there
  const bool keys_staged = n <= kKeyStage;
  if (keys_staged) {
    for (int i0 = 0; i0 < n; i0 += kKeyBatch * kMergeThreads) {
      float v[kKeyBatch];
#pragma unroll
      for (int u = 0; u < kKeyBatch; ++u) {
        const int i = i0 + u * kMergeThreads + threadIdx.x;
        v[u] = i < n ? buf_keys[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kKeyBatch; ++u) {
        const int i = i0 + u * kMergeThreads + threadIdx.x;
        if (i < n) key_stage[i] = order_bits(v[u]);
      }
    }
  }
  // launched as a programmatic dependent of the scan: its counts and
  // candidates are complete and visible after this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const unsigned long long m = counters[1];
  if (rank == 0 && threadIdx.x == 0)
    *out_acc = static_cast<long long>(counters[0]);
  const unsigned long long passes =
      m == 0 ? 1 : (m + kCapacity - 1) / kCapacity;
  // this block's slice of the buffer's entries
  const int per = (n + kClusterBlocks - 1) / kClusterBlocks;
  const int b0 = min(n, rank * per), b1 = min(n, b0 + per);
  const unsigned long long* src = nullptr;
  unsigned long long* dst = run0;
  for (unsigned long long pass = 0; pass < passes; ++pass) {
    const bool last = pass + 1 == passes;
    const unsigned long long start = pass * kCapacity;
    const int mc = static_cast<int>(
        m - start < kCapacity ? m - start : kCapacity);
    const int t = (mc + kClusterBlocks - 1) / kClusterBlocks;
    const int mine = max(0, min(t, mc - rank * t));
    int p = 1;
    while (p < t) p <<= 1;
    const bool local = p * kClusterBlocks <= kLocalTiles;
    const unsigned long long* own = cand + start + rank * t;

    // this block's tile, sorted
    if (t <= kCountSort) {
      // by counting: entry j's place is the entries below it (each unique)
      const unsigned long long c =
          static_cast<int>(threadIdx.x) < mine ? own[threadIdx.x] : kPad;
      raw[threadIdx.x] = c;
      __syncthreads();
      if (static_cast<int>(threadIdx.x) < mine) {
        int r = 0;
        for (int i = 0; i < mine; ++i) r += raw[i] < c ? 1 : 0;
        tile[r] = c;
      } else if (static_cast<int>(threadIdx.x) < p) {
        tile[threadIdx.x] = kPad;
      }
    } else {
#pragma unroll 4
      for (int j = threadIdx.x; j < p; j += blockDim.x)
        tile[j] = j < mine ? own[j] : kPad;
      __syncthreads();
      bitonic_sort(tile, p);
    }
    __syncthreads();
    if (local) {
      // pushed into every block's copies: after the barrier every tile is
      // searched in the block's own shared memory
      for (int j = threadIdx.x; j < p * kClusterBlocks; j += blockDim.x) {
        const int q = j / p;
        cluster.map_shared_rank(copies, q)[rank * p + j - q * p] =
            tile[j - q * p];
      }
    }
    cluster.sync();  // every tile sorted and visible

    const unsigned long long* tiles[kClusterBlocks];
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r)
      tiles[r] = local ? copies + r * p : cluster.map_shared_rank(tile, r);
    const uint32_t* keys = pass == 0 && keys_staged ? key_stage : nullptr;
    for (int j = threadIdx.x; j < mine; j += blockDim.x) {
      const unsigned long long c = tile[j];
      const int k = cluster_rank(tiles, p, c) +
                    buffer_rank(keys, src, buf_keys, n, c);
      if (k < n) place(k, c, last, dst, n, out_keys, out_idx, cols);
    }
    for (int i = b0 + threadIdx.x; i < b1; i += blockDim.x) {
      const unsigned long long e =
          keys ? pack(keys[i], static_cast<unsigned long long>(i))
               : buffer_entry(src, buf_keys, i);
      const int k = i + cluster_rank(tiles, p, e);
      if (k < n) place(k, e, last, dst, n, out_keys, out_idx, cols);
    }
    // another block's tile is read after the barrier only where it stays
    // (and its copies are pushed again only on the next pass)
    if (last && local) break;
    if (!last) __threadfence();  // the run, before the next pass reads it
    cluster.sync();
    if (last) break;
    src = dst;
    dst = dst == run0 ? run1 : run0;
  }
  if (rank == 0 && threadIdx.x == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

// Columns past the merge kernel's kMaxColumns: column blockIdx.y, output
// row k, by the index map.
__global__ void __launch_bounds__(kGatherThreads) gather_rows_kernel(
    const Columns cols, const long long* __restrict__ idx, int n) {
  const Column col = cols.c[blockIdx.y];
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x)
    copy_column_row(col, idx[k], n, k);
}

// The widest copy unit (8, 4, 2 or 1 bytes) dividing every value.
int copy_word(long long a, long long b, long long c, long long d,
              long long e) {
  for (int w = 8; w > 1; w >>= 1)
    if ((a | b | c | d | e) % w == 0) return w;
  return 1;
}

}  // namespace

extern "C" {

// One merge.  Every field is 8 bytes wide: the ctypes mirror in
// ops/kernels/topn.py (_CullCall) lists them in this order.
struct CullCall {
  const float* d;               // (batch, cols) float32, rows ld apart
  long long batch;
  long long cols;
  long long ld;
  const float* thr_vec;         // thr_len 1 or cols values
  long long thr_len;            // 0: thr_scalar
  double thr_scalar;
  const float* buf_keys;        // the sorted buffer's n keys
  long long n;
  unsigned long long* scratch;  // 2 counters (zero between calls), batch
                                // candidates, 2 n run entries
  float* out_keys;              // n merged keys
  long long* out_idx;           // n indices into [buffer, batch]
  long long* out_acc;           // the acceptance count
  long long n_columns;
  const void* const* col_buf;   // per column: the buffer's rows, contiguous
  const void* const* col_batch; // the batch's rows, batch_stride apart
  void* const* col_out;         // the merged rows, contiguous
  const long long* row_bytes;
  const long long* batch_stride;
  long long device;
  void* stream;
};

int elfi_topn_cull(const CullCall* a) {
  if (a->batch < 1 || a->n < 1 || a->cols < 1 || a->n_columns < 0 ||
      a->n > 0x7fffffffll ||
      static_cast<unsigned long long>(a->batch) + a->n >= 0xffffffffull ||
      (a->thr_len != 0 && a->thr_len != 1 && a->thr_len != a->cols))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->device < 0 || a->device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int device = static_cast<int>(a->device);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_sms[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device] = sms;
  }
  if (!g_smem_set[device]) {
    err = cudaFuncSetAttribute(cull_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMergeSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[device] = true;
  }
  const auto s = static_cast<cudaStream_t>(a->stream);
  const int n = static_cast<int>(a->n);
  const float thr = static_cast<float>(a->thr_scalar);
  const int thr_len = static_cast<int>(a->thr_len);
  unsigned long long* counters = a->scratch;
  unsigned long long* cand = a->scratch + 2;
  unsigned long long* run = cand + a->batch;
  const long long max_blocks =
      static_cast<long long>(g_sms[device]) * kScanBlocksPerSm;

  if (a->cols == 1 && a->ld == 1 &&
      reinterpret_cast<uintptr_t>(a->d) % 16 == 0) {
    const long long span = static_cast<long long>(kScanThreads) * kScanVec;
    const long long blocks = ((a->batch + 3) / 4 + span - 1) / span;
    cull_scan_vec_kernel<<<static_cast<unsigned>(
                               blocks < max_blocks ? blocks : max_blocks),
                           kScanThreads, 0, s>>>(
        a->d, a->batch, a->thr_vec, thr_len, thr, a->buf_keys, n, counters,
        cand);
  } else {
    const long long blocks = (a->batch + kScanThreads - 1) / kScanThreads;
    cull_scan_kernel<<<static_cast<unsigned>(
                           blocks < max_blocks ? blocks : max_blocks),
                       kScanThreads, 0, s>>>(
        a->d, a->batch, static_cast<int>(a->cols), a->ld, a->thr_vec,
        thr_len, thr, a->buf_keys, n, counters, cand);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Columns cols;
  const int nc = static_cast<int>(a->n_columns);
  for (int c0 = 0; c0 == 0 || c0 < nc; c0 += kMaxColumns) {
    cols.count = nc - c0 < kMaxColumns ? nc - c0 : kMaxColumns;
    for (int c = 0; c < cols.count; ++c) {
      const int i = c0 + c;
      const long long bp = reinterpret_cast<long long>(a->col_buf[i]);
      const long long sp = reinterpret_cast<long long>(a->col_batch[i]);
      const long long op = reinterpret_cast<long long>(a->col_out[i]);
      cols.c[c] = Column{static_cast<const char*>(a->col_buf[i]),
                         static_cast<const char*>(a->col_batch[i]),
                         static_cast<char*>(a->col_out[i]), a->row_bytes[i],
                         a->batch_stride[i],
                         copy_word(a->row_bytes[i], a->batch_stride[i], bp,
                                   sp, op)};
    }
    if (c0 == 0) {
      // a programmatic dependent launch: the merge's blocks are placed and
      // stage the buffer's keys while the scan runs
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kClusterBlocks);
      cfg.blockDim = dim3(kMergeThreads);
      cfg.dynamicSmemBytes = kMergeSmem;
      cfg.stream = s;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, cull_merge_kernel, a->buf_keys, n,
                               counters, cand, run, run + n, a->out_keys,
                               a->out_idx, a->out_acc, cols);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      gather_rows_kernel<<<dim3((n + kGatherThreads - 1) / kGatherThreads,
                                cols.count),
                           kGatherThreads, 0, s>>>(cols, a->out_idx, n);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
