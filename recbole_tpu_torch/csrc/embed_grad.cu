// Dense gradient of an embedding row gather, for NVIDIA Hopper (sm_90a):
//
//   out[v, :] = sum over r with ids[r] == id_base + v of g[r, :]      (fp32)
//
// out is (n_rows, D); every row is written exactly once, zero where no id
// hits. Two kernels compute this function:
//
// * onehot_grad_kernel replaces the Pallas kernel ``onehot_matmul_grad``
//   (recbole_tpu/ops/embed_grad.py:78), which feeds the TPU's matrix unit a
//   one-hot of the ids. It takes the ids unsorted.
// * windowed_grad_kernel replaces ``windowed_grad`` (:170), which sweeps a
//   large vocabulary in row windows over ids that were sorted outside the
//   kernel. It takes the sorted ids and the sort's permutation.
//
// Both are bound by bytes on this card: they read each id and cotangent row
// once and write the (n_rows, D) table once, with one add per cotangent
// element. At the CTR shapes the small-vocabulary call moves about 3 MB
// (about a microsecond of bandwidth, so its time is latency) and the
// large-vocabulary call writes 111 MB of mostly zero rows.
//
// Neither kernel uses float atomics: every output row has one owner warp at
// a time, which adds that row's cotangents in the order of r (the sorted
// kernel in chunks, each chunk's partial sum added in turn), so two runs
// give the same bits. Exact fp32 terms are added where the TPU kernel adds
// a bf16 hi + lo pair.
//
// Cotangent layout. Row r of g lives at g + (r / fs) * g_stride + (r % fs) * D
// and id r at ids + (r / fs) * ids_stride + (r % fs): a (B, fs) column block
// cut out of a (B, F) id matrix and a (B, F, D) cotangent is read in place.
// A contiguous (R,) / (R, D) pair is fs = 1, ids_stride = 1, g_stride = D.
//
// Column ranges. For such a column block the caller may pass col_off, fs + 1
// ascending global ids, and promise that column f holds only ids in
// [col_off[f], col_off[f + 1]) (the CTR family's per-field vocabularies). A
// block of the unsorted kernel then scans only the columns whose range meets
// its tile, B ids each instead of B * fs, which pays for much smaller tiles.
//
// Splits. A small vocabulary hit by many ids (the sequential family's
// (B, L) gather into a few thousand items, a third of the ids the [PAD] row)
// has few tiles and one of them takes most of the matches. The caller may
// then cut the ids into ``splits`` slices: blockIdx.y takes slice y and
// writes its own (n_rows, D) partial, and sum_splits_kernel adds the partials
// in slice order, so the result still does not depend on timing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdsPerThread = 8;                    // ids each thread reads per scan step
constexpr int kScanStep = kThreads * kIdsPerThread;
constexpr int kListCap = 2 * kScanStep;             // matches buffered between flushes
constexpr int kSmemFloats = 8 * 1024;               // 32 KB of tile + staging per block
constexpr int kWindowFloats = 6 * 1024;             // 24 KB window of the sorted kernel
constexpr int kStageFloats = 4 * 1024;              // 16 KB of staged rows in the sorted kernel
// Measured on an H100 at the CTR shapes (R = 34,816 into 35,692 rows; R =
// 18,432 into 2,530,000 rows; D = 11) against 16/64/128 and 128/512:
constexpr int kTile = 128;                          // tile rows, all ids scanned
constexpr int kTileRanged = 32;                     // tile rows, column ranges cut the scan
constexpr int kWindow = 256;                        // most rows in a window of the sorted kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename G>
__device__ __forceinline__ const G* g_row(const G* g, int r, int fs, int64_t g_stride, int D) {
  const int b = r / fs;
  const int f = r - b * fs;
  return g + (int64_t)b * g_stride + (int64_t)f * D;
}

// Copy the cotangent rows entries[0..nc) into stage (nc, D) with the whole
// block. Each thread issues kInFlight loads before it stores any of them, so
// a chunk costs a few round trips to memory, not one per element.
constexpr int kInFlight = 8;

template <typename G>
__device__ __forceinline__ void stage_rows(const G* __restrict__ g, int fs, int64_t g_stride,
                                           int D, int nc, const int* entries, float* stage) {
  const int nel = nc * D;
  for (int i0 = threadIdx.x; i0 < nel; i0 += kThreads * kInFlight) {
    float v[kInFlight] = {};
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nel) {
        const int e = i / D;
        v[u] = to_f32(g_row(g, entries[e], fs, g_stride, D)[i - e * D]);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nel) stage[i] = v[u];
    }
  }
}

// ---------------------------------------------------------------- unsorted ids
//
// A block owns a tile of T vocabulary rows, kept in shared memory. It scans
// the ids in order (all R of them, or only the columns whose range meets the
// tile), kScanStep at a time, and appends the ones that fall in its tile to
// a list, in the order of r (ballot and prefix sums, no atomics).
// When the list is full, and at the end, the list is flushed: C cotangent rows
// at a time are staged into shared memory with coalesced loads, then each warp
// adds the staged rows of the tile rows it owns (row % kWarps == warp), in
// list order, lanes across the D columns.

template <typename G>
__device__ __forceinline__ void flush_matches(const G* __restrict__ g, int fs, int64_t g_stride,
                                              int D, int C, int list_len, const int* list_r,
                                              const int* list_row, float* acc, float* stage) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the list and the zeroed tile are visible to every warp
  for (int c0 = 0; c0 < list_len; c0 += C) {
    const int nc = min(C, list_len - c0);
    stage_rows(g, fs, g_stride, D, nc, list_r + c0, stage);
    __syncthreads();
    // a row's running sum stays in a register (lane d holds column d) while
    // the warp's next entry hits the same row, which is the common case in
    // the hot rows of a skewed vocabulary
    int cur = -1;
    float run = 0.f;
    for (int e0 = 0; e0 < nc; e0 += 32) {
      const int e = e0 + lane;
      const int my_row = e < nc ? list_row[c0 + e] : -1;
      unsigned own = __ballot_sync(kFull, my_row >= 0 && (my_row % kWarps) == warp);
      while (own) {
        const int bit = __ffs(own) - 1;
        own &= own - 1;
        const int row = __shfl_sync(kFull, my_row, bit);
        const float* src = stage + (size_t)(e0 + bit) * D;
        float* dst = acc + (size_t)row * D;
        if (D <= 32) {
          if (row != cur) {
            if (cur >= 0 && lane < D) acc[(size_t)cur * D + lane] = run;
            cur = row;
            run = lane < D ? dst[lane] : 0.f;
          }
          if (lane < D) run += src[lane];
        } else {
          for (int d = lane; d < D; d += 32) dst[d] += src[d];
        }
      }
    }
    if (cur >= 0 && lane < D) acc[(size_t)cur * D + lane] = run;
    __syncthreads();  // the staging buffer is free for the next chunk
  }
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
onehot_grad_kernel(const int64_t* __restrict__ ids, int64_t ids_stride, int fs,
                   const int64_t* __restrict__ col_off, const G* __restrict__ g,
                   int64_t g_stride, int R, int D, int64_t id_base, int n_rows, int T, int C,
                   int b_chunk, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);        // T * D
  float* stage = acc + (size_t)T * D;                     // C * D
  int* list_r = reinterpret_cast<int*>(stage + (size_t)C * D);
  int* list_row = list_r + kListCap;
  __shared__ int warp_cnt[kIdsPerThread][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the last tiles first: schemas list their small, densely hit vocabularies
  // last, and those tiles take longest
  const int v0 = (gridDim.x - 1 - blockIdx.x) * T;
  const int rows = min(T, n_rows - v0);
  for (int i = tid; i < rows * D; i += kThreads) acc[i] = 0.f;
  int list_len = 0;  // the same in every thread

  // the columns [f_lo, f_lo + nf) whose id range meets this tile
  int f_lo = 0, nf = fs;
  if (col_off != nullptr) {
    // every thread tests some columns; two block-wide counts give the first
    // and the last column that meets the tile (the ranges ascend, so the
    // columns that end at or before the tile come first, and those that
    // start at or after its end come last)
    const int64_t lo = id_base + v0, hi = lo + rows;
    int ends_before = 0, starts_after = 0;
    for (int f = tid; f < fs; f += kThreads) {
      ends_before += col_off[f + 1] <= lo;
      starts_after += col_off[f] >= hi;
    }
    for (int off = 16; off > 0; off >>= 1) {
      ends_before += __shfl_xor_sync(kFull, ends_before, off);
      starts_after += __shfl_xor_sync(kFull, starts_after, off);
    }
    if (lane == 0) {
      warp_cnt[0][warp] = ends_before;
      warp_cnt[1][warp] = starts_after;
    }
    __syncthreads();
    ends_before = starts_after = 0;
    for (int w = 0; w < kWarps; ++w) {
      ends_before += warp_cnt[0][w];
      starts_after += warp_cnt[1][w];
    }
    __syncthreads();  // warp_cnt is free for the scan
    f_lo = ends_before;
    nf = max(fs - starts_after - f_lo, 0);
  }
  // ids to scan: position q is (q / nf, f_lo + q % nf); slice blockIdx.y takes
  // the rows [b_lo, b_hi) of the (R / fs, fs) id matrix
  const int b_lo = blockIdx.y * b_chunk, b_hi = min(R / fs, b_lo + b_chunk);
  const int nq = b_hi * nf;

  for (int base = b_lo * nf; base < nq; base += kScanStep) {
    int row[kIdsPerThread];
    int hits = 0;
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int q = base + k * kThreads + tid;
      row[k] = -1;
      if (q < nq) {
        const int b = q / nf;
        const int f = f_lo + (q - b * nf);
        const int64_t local = ids[(int64_t)b * ids_stride + f] - id_base - v0;
        if (local >= 0 && local < rows) row[k] = (int)local;
      }
      hits += row[k] >= 0;
    }
    // a barrier and a count in one: most steps find nothing for this tile
    const int any = __syncthreads_count(hits);
    if (any == 0) continue;
    unsigned bal[kIdsPerThread];
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      bal[k] = __ballot_sync(kFull, row[k] >= 0);
      if (lane == 0) warp_cnt[k][warp] = __popc(bal[k]);
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k)
      for (int w = 0; w < kWarps; ++w) total += warp_cnt[k][w];
    if (list_len + total > kListCap) {
      flush_matches(g, fs, g_stride, D, C, list_len, list_r, list_row, acc, stage);
      list_len = 0;
    }
    // position of (k, warp, lane) in the order of r: r grows with k, then
    // with the warp, then with the lane
    int before = list_len;
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      int pos = before + __popc(bal[k] & ((1u << lane) - 1u));
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_cnt[k][w];
        if (w < warp) pos += c;
        before += c;
      }
      if (row[k] >= 0) {
        const int q = base + k * kThreads + tid;
        const int b = q / nf;
        list_r[pos] = b * fs + f_lo + (q - b * nf);
        list_row[pos] = row[k];
      }
    }
    list_len += total;
    // warp_cnt is rewritten only after the next step's __syncthreads_count
  }
  flush_matches(g, fs, g_stride, D, C, list_len, list_r, list_row, acc, stage);
  __syncthreads();
  float* o = out + ((size_t)blockIdx.y * n_rows + v0) * D;
  for (int i = tid; i < rows * D; i += kThreads) o[i] = acc[i];
}

// out[i] = sum of the slices' partials, in slice order
__global__ void sum_splits_kernel(const float* __restrict__ partials, int splits, size_t n,
                                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int y = 0; y < splits; ++y) s += partials[(size_t)y * n + i];
  out[i] = s;
}

// ------------------------------------------------------------------ sorted ids
//
// sids is ids sorted ascending by a stable sort and order its permutation
// (sids[k] == ids[order[k]]), so the entries of one output row are adjacent
// and in the order of r. A block owns a window of W output rows. It finds the
// window's entries [lo, hi) by a block-wide search. Most windows of a large
// vocabulary hold none and are streamed out as zeros. Otherwise the window is
// built in shared memory, C entries at a time: their cotangent rows are
// staged with the whole block's loads in flight together, then each run of
// equal ids within the chunk has one owner warp, which adds the run's staged
// rows in order, lanes across the D columns, and adds the sum to the window
// row (a run that spans chunks is continued by the next chunk, after a
// barrier). Last the window is written out once, coalesced.

// First position of the sorted a[0..n) that is not below x0, and the same
// for x1, found by the whole block: each round the threads probe kThreads
// evenly spaced positions of what is left, and a block-wide count of the
// probes below x picks the gap to search next. Two or three rounds of one
// load each, where a binary search by one thread is 15 to 30 loads in a row.
__device__ __forceinline__ void block_lower_bounds(const int64_t* __restrict__ a, int n,
                                                   int64_t x0, int64_t x1, int* out0,
                                                   int* out1) {
  int lo0 = 0, len0 = n, lo1 = 0, len1 = n;
  while (len0 > 0 || len1 > 0) {
    const int step0 = (len0 + kThreads - 1) / kThreads;
    const int step1 = (len1 + kThreads - 1) / kThreads;
    const int p0 = lo0 + threadIdx.x * step0;
    const int p1 = lo1 + threadIdx.x * step1;
    const bool b0 = len0 > 0 && p0 < lo0 + len0 && a[p0] < x0;
    const bool b1 = len1 > 0 && p1 < lo1 + len1 && a[p1] < x1;
    const int less0 = __syncthreads_count(b0);
    const int less1 = __syncthreads_count(b1);
    if (len0 > 0) {
      if (less0 == 0) {
        len0 = 0;
      } else {
        const int end = lo0 + len0;
        lo0 += (less0 - 1) * step0 + 1;
        len0 = min(lo0 + step0 - 1, end) - lo0;
      }
    }
    if (len1 > 0) {
      if (less1 == 0) {
        len1 = 0;
      } else {
        const int end = lo1 + len1;
        lo1 += (less1 - 1) * step1 + 1;
        len1 = min(lo1 + step1 - 1, end) - lo1;
      }
    }
  }
  *out0 = lo0;
  *out1 = lo1;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
windowed_grad_kernel(const int64_t* __restrict__ sids, const int64_t* __restrict__ order,
                     const G* __restrict__ g, int fs, int64_t g_stride, int R, int D,
                     int64_t id_base, int64_t n_rows, int W, int C, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);       // W * D
  float* stage = tile + (size_t)W * D;                    // C * D
  int* ent_row = reinterpret_cast<int*>(stage + (size_t)C * D);  // C: row in the window
  int* ent_ord = ent_row + C;                                    // C: row of g

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t v0 = (int64_t)blockIdx.x * W;
  const int64_t left = n_rows - v0;
  const int rows = left < W ? (int)left : W;
  const int n = rows * D;
  int lo, hi;
  block_lower_bounds(sids, R, id_base + v0, id_base + v0 + rows, &lo, &hi);
  float* o = out + (size_t)v0 * D;
  if (lo == hi) {
    for (int i = tid; i < n; i += kThreads) o[i] = 0.f;
    return;
  }
  for (int i = tid; i < n; i += kThreads) tile[i] = 0.f;

  for (int c0 = lo; c0 < hi; c0 += C) {
    const int nc = min(C, hi - c0);
    for (int e = tid; e < nc; e += kThreads) {
      ent_row[e] = (int)(sids[c0 + e] - id_base - v0);
      ent_ord[e] = (int)order[c0 + e];
    }
    __syncthreads();  // also: the zeroed tile, and the previous chunk's sums
    stage_rows(g, fs, g_stride, D, nc, ent_ord, stage);
    __syncthreads();
    for (int e0 = warp * 32; e0 < nc; e0 += kThreads) {
      const int e = e0 + lane;
      const int row = e < nc ? ent_row[e] : -1;
      unsigned heads = __ballot_sync(kFull, e < nc && (e == 0 || ent_row[e - 1] != row));
      while (heads) {
        const int bit = __ffs(heads) - 1;
        heads &= heads - 1;
        const int eh = e0 + bit;
        const int hrow = __shfl_sync(kFull, row, bit);
        int end = eh + 1;  // the run within this chunk is [eh, end)
        while (end < nc && ent_row[end] == hrow) ++end;
        for (int d = lane; d < D; d += 32) {
          float sum = 0.f;
#pragma unroll 4
          for (int k = eh; k < end; ++k) sum += stage[(size_t)k * D + d];
          tile[(size_t)hrow * D + d] += sum;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads) o[i] = tile[i];
}

// Rows of a one-hot tile, 0 when no tile of this width fits. With column
// ranges a block scans a fraction of the ids, so tiles can be small and the
// hot rows of a skewed vocabulary spread over more blocks.
inline int onehot_tile(int D, bool ranged) {
  const int per = D > 0 ? kSmemFloats / D : 0;
  return per < 2 ? 0 : min(ranged ? kTileRanged : kTile, per / 2);
}

template <typename G>
int launch_onehot(const int64_t* ids, int64_t ids_stride, int fs, const int64_t* col_off,
                  const G* g, int64_t g_stride, int R, int D, int64_t id_base, int n_rows,
                  int splits, float* partials, float* out, cudaStream_t stream) {
  const int per = kSmemFloats / D;  // tile rows + staged rows that fit
  const int T = onehot_tile(D, col_off != nullptr);
  if (T < 1) return (int)cudaErrorInvalidValue;
  const int C = min(256, per - T);
  const size_t smem = sizeof(float) * (size_t)(T + C) * D + sizeof(int) * 2 * kListCap;
  cudaError_t err = cudaFuncSetAttribute(onehot_grad_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + T - 1) / T;
  if (splits < 1 || splits > 65535 || (splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nb = R / fs;
  const int b_chunk = max((nb + splits - 1) / splits, 1);
  onehot_grad_kernel<G><<<dim3(grid, splits), kThreads, smem, stream>>>(
      ids, ids_stride, fs, col_off, g, g_stride, R, D, id_base, n_rows, T, C, b_chunk,
      splits > 1 ? partials : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)n_rows * D;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partials, splits, n, out);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_windowed(const int64_t* sids, const int64_t* order, const G* g, int fs,
                    int64_t g_stride, int R, int D, int64_t id_base, int64_t n_rows, float* out,
                    cudaStream_t stream) {
  if (D > kStageFloats) return (int)cudaErrorInvalidValue;
  const int W = min(kWindow, kWindowFloats / D);
  const int C = min(256, kStageFloats / D);
  const int64_t grid = (n_rows + W - 1) / W;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(W + C) * D + sizeof(int) * 2 * C;
  windowed_grad_kernel<G><<<(unsigned)grid, kThreads, smem, stream>>>(
      sids, order, g, fs, g_stride, R, D, id_base, n_rows, W, C, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Into how many slices embed_grad_onehot's caller cuts the ids. A vocabulary
// of few tiles hit by many ids (a sequential model's (B, L) gather) leaves
// most SMs idle and one tile with most of the matches, so the ids are cut into
// slices of about 4,096 rows, each with its own partial result, summed in
// slice order. Many tiles, or a batch of a few thousand rows, stay at one
// slice. A function of the shapes only, so the result's bits do not change
// from run to run. Returns 0 for a D no tile fits.
extern "C" int embed_grad_onehot_splits(int R, int fs, int n_rows, int D, int ranged) {
  const int T = onehot_tile(D, ranged != 0);
  if (T < 1) return 0;
  if ((n_rows + T - 1) / T >= 512) return 1;
  return max(1, min(32, R / max(fs, 1) / 4096));
}

// ids int64, R of them (0 <= R < 2^30, a multiple of fs) in the layout
// described at the top; col_off null or fs + 1 int64 column ranges; g float32
// (g_is_bf16 == 0) or bfloat16, 1 <= D <= 4096; out (n_rows, D) float32
// contiguous, 1 <= n_rows < 2^31. Ids outside [id_base, id_base + n_rows)
// match no row. splits >= 1 slices of the ids, with partials (splits, n_rows,
// D) float32 scratch when splits > 1. Returns the CUDA error code.
extern "C" int embed_grad_onehot(const void* ids, long long ids_stride, int fs,
                                 const void* col_off, const void* g, long long g_stride,
                                 int g_is_bf16, int R, int D, long long id_base, int n_rows,
                                 int splits, float* partials, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* i64 = static_cast<const int64_t*>(ids);
  const int64_t* co = static_cast<const int64_t*>(col_off);
  if (g_is_bf16)
    return launch_onehot(i64, ids_stride, fs, co, static_cast<const __nv_bfloat16*>(g),
                         g_stride, R, D, id_base, n_rows, splits, partials, out, s);
  return launch_onehot(i64, ids_stride, fs, co, static_cast<const float*>(g), g_stride, R, D,
                       id_base, n_rows, splits, partials, out, s);
}

// sids int64 (R,) sorted ascending by a stable sort, order int64 (R,) its
// permutation into the rows of g (layout as above, ids not read through it);
// out (n_rows, D) float32 contiguous, 1 <= D <= 4096, n_rows >= 1. Row
// offsets are formed in 64 bits, so n_rows * D may pass 2^31.
extern "C" int embed_grad_windowed(const void* sids, const void* order, const void* g, int fs,
                                   long long g_stride, int g_is_bf16, int R, int D,
                                   long long id_base, long long n_rows, float* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* si = static_cast<const int64_t*>(sids);
  const int64_t* od = static_cast<const int64_t*>(order);
  if (g_is_bf16)
    return launch_windowed(si, od, static_cast<const __nv_bfloat16*>(g), fs, g_stride, R, D,
                           id_base, n_rows, out, s);
  return launch_windowed(si, od, static_cast<const float*>(g), fs, g_stride, R, D, id_base,
                         n_rows, out, s);
}
