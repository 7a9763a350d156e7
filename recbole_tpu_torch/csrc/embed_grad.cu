// Dense gradient of an embedding row gather, for NVIDIA Hopper (sm_90a):
//
//   out[v, :] = sum over r with ids[r] == id_base + v of g[r, :]      (fp32)
//
// out is (n_rows, D); every row is written, zero where no id hits. Ids
// outside [id_base, id_base + n_rows) are dropped. Two paths compute this
// function, both from unsorted ids bucketed on the device:
//
// * the one-hot path replaces the Pallas kernel ``onehot_matmul_grad``
//   (recbole_tpu/ops/embed_grad.py:78), which feeds the TPU's matrix unit a
//   one-hot of the ids: at most kMaxTiles tiles of kTile rows (four
//   launches, below).
// * the windowed path replaces ``windowed_grad`` (:170), which sweeps a
//   large vocabulary in row windows over ids sorted by XLA outside the
//   kernel. Here the ids are bucketed by window on the device instead (a
//   stable sort by window, no library sort), and the table's zero fill runs
//   under the bucketing (three or four launches, below).
//
// Both are bound by bytes on this card: each id and cotangent row is read
// once and the (n_rows, D) table written once, one add per cotangent
// element. At the CTR shapes the small-vocabulary call moves about 3 MB
// (about a microsecond of bandwidth, so its time is latency and launches)
// and the large-vocabulary call writes 111 MB of mostly zero rows.
//
// Neither path uses float atomics: every output element is a sum in an
// order fixed by the ids and the shapes alone, so two runs give the same
// bits. Exact fp32 terms are added where the TPU kernel adds a bf16 hi + lo
// pair. Every grid is sized from the shapes (and the card's size); blocks
// past a device-built table's end return, so nothing waits for the host.
//
// Cotangent layout. Row r of g lives at g + (r / fs) * g_stride + (r % fs) * D
// and id r at ids + (r / fs) * ids_stride + (r % fs): a (B, fs) column block
// cut out of a (B, F) id matrix and a (B, F, D) cotangent is read in place.
// A contiguous (R,) / (R, D) pair is fs = 1, ids_stride = 1, g_stride = D.
//
// Bucketing, shared by both paths. The output rows are cut into buckets of
// 2^shift rows (the one-hot path's tiles of kTile rows; the windowed path's
// windows, at most kMaxTiles of them) and the ids into chunks of K (kChunk,
// more for a long id list), in the order of r:
//   1. bucket_count_kernel: a block per chunk counts the chunk's ids per
//      bucket (shared-memory integer atomics: an order-free count).
//   2. a one-block scan: each bucket's first list position, each (chunk,
//      bucket)'s first position, and the path's piece table.
//   3. bucket_scatter_kernel: a block per chunk writes each id's (r, row in
//      the bucket) into its bucket's range, in the order of r (each warp owns
//      a contiguous eighth of the chunk; ranks within 32 ids from one ballot
//      per bit of the bucket), so the list is the stable sort of the ids by
//      bucket. Ids are read twice and the (r, row) list written and read once
//      (8 bytes an entry).
//
// The one-hot path, stage 2 (onehot_scan_kernel): the pieces in tile order:
// a group of kGroup tiles whose entries fit one staging is one piece (most
// tiles of a sparse vocabulary), any other tile is cut into pieces of at
// most P entries (kPiece, kNarrowPiece for D < 32); a tile with no entries
// still has a piece, which writes its zeros. Stage 4, onehot_piece_kernel:
// a block per piece stages the piece's cotangent rows into shared memory,
// kStageRows at a time (16 bytes a load where D % 4 == 0), then every thread
// owns one column d and one residue j of the entries: it sums the entries j,
// j + J, ... (J = 256 / D) of each row into its own shared-memory slot, and
// the J slots of a (row, d) are added in order of j. So a hot row is summed
// by all 256 threads at once, no chain longer than P / J adds. A group's
// tiles are summed one after the other from one staging. A tile of one piece
// writes its rows to out; a tile of several writes a (kTile, D) partial per
// piece, and the last of its pieces to finish (an integer atomic count per
// tile) adds the partials in piece order. The piece grid is sized at the
// bound n_tiles + ceil(R / P).
//
// The windowed path. A window is 2^shift rows, the fewest (at least kTile)
// that keep the windows within kMaxTiles. Up to kScanCountIds ids the scan
// block counts them itself (no stage 1: three launches); past it, the count
// kernel. Stage 2, windowed_scan_kernel: a window of n entries is
// ceil(n / P) pieces of at most P entries (kWindowedPiece, or
// kWindowedNarrowPiece for D < 32, and P D within kWindowedStageFloats, so P
// falls below 32 past D 512), in the order of its list; the first piece
// belongs to the window's own block, the others are listed in an extra
// table. Stage 4, windowed_piece_kernel:
// a grid of as many blocks as the card holds at once; block b owns the
// windows b, b + grid, ... It first zeroes its windows' rows with 16-byte
// evict-first stores. That fill is the bound and depends on nothing before
// it, so under Hopper's programmatic dependent launch it runs while the
// bucketing does, and only then does the block wait for the scatter
// (griddepcontrol.wait). Then, hot windows first: its extra pieces, then
// the first piece of each owned window of more than min(32, P) entries (a
// block each), then its windows of at most min(32, P) entries (a warp each,
// 8 at once; such a window is one piece, so no partials are left over).
// A block piece ranks its entries by row in the window, stably (each entry
// counts the entries with a smaller row, or the same row and an earlier
// position), stages their cotangent rows in that order (16-byte loads where
// D % 4 == 0), and every thread owns a column and a residue j of the
// positions: it sums its positions of each row's run and leaves the sum at
// its first position of the run, so a run's partials lie at its first J
// positions and are added in order of position. A warp ranks its <= 32
// entries with shuffles and adds each run in order of position, a lane a
// column. Only the touched rows are written. A window of one piece writes
// them to out; a window of several writes its runs' partials, and the last
// piece to finish (an integer ticket) adds them into the zeroed rows in
// piece order. The stages after the first launch with programmatic stream
// serialization, so each starts as the one before it starts and waits for
// its completion where it first reads its output: a CUDA graph captures
// them as programmatic edges.
//
// The launchers ask the runtime about a kernel (its shared-memory limit
// raised past 48 KB, the blocks an SM holds, the SM count) once per device,
// kernel and shared-memory size, and keep the answer: past its first call
// at a shape, a launcher asks the runtime only for the current device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInFlight = 8;                        // loads a thread has in flight
// the one-hot path
constexpr int kTile = 32;                           // output rows of a tile
constexpr int kMaxTiles = 2048;                     // tiles of a call (counters in shared memory)
constexpr int kChunk = 2048;                        // ids of a count / scatter block
constexpr int kScanInts = 48 * 1024;                // the count table the scan holds in shared memory
constexpr int kBatch = 8;                           // 32-id groups a warp loads at once
constexpr int kStageRows = 256;                     // most rows a piece block stages at once
constexpr int kPiece = 1024;                        // most entries of a piece at D >= 32
constexpr int kNarrowPiece = 256;                   // ... and below
constexpr int kGroup = 4;                           // tiles a piece may hold when they are small
constexpr int kPieceStageFloats = 8 * 1024;         // 32 KB of staged rows in a piece block
constexpr int kScanThreads = 1024;
constexpr int kTileShift = 5;                       // log2(kTile)
// the windowed path: windows of at least kTile rows, at most kMaxTiles of
// them; a piece stages at most kWindowedStageFloats (64 KB) of cotangent rows
constexpr int kWindowedStageFloats = 16 * 1024;
// most entries of a windowed piece at D >= 32, and below: narrow rows stage
// fast, so a hot window is cut finer and spread over more blocks (measured
// on an H100 against 256 and 512 at Criteo's shape, D 11)
constexpr int kWindowedPiece = 256;
constexpr int kWindowedNarrowPiece = 128;
// ids the windowed scan block counts itself, in place of a count kernel
constexpr int kScanCountIds = 8 * 1024;

template <typename G>
__device__ __forceinline__ const G* g_row(const G* g, int r, int fs, int64_t g_stride, int D) {
  const int b = r / fs;
  const int f = r - b * fs;
  return g + (int64_t)b * g_stride + (int64_t)f * D;
}

// V consecutive elements of a cotangent row as floats: one load (16 bytes
// of fp32, 8 of bf16) for V = 4
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// Copy the cotangent rows ent[0..nc) into stage (nc, D) with the whole
// block, V elements a load (V = 4 needs D % 4 == 0 and rows on a 4-element
// boundary). Each thread issues kInFlight loads before it stores any of
// them, so a chunk costs a few round trips to memory, not one per element.
template <typename G, int V>
__device__ __forceinline__ void stage_rows(const G* __restrict__ g, int fs, int64_t g_stride,
                                            int D, int nc, const int* ent, float* stage) {
  const int DV = D / V, nel = nc * DV;
  for (int i0 = threadIdx.x; i0 < nel; i0 += kThreads * kInFlight) {
    float v[kInFlight][V];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nel) {
        const int e = i / DV;
        load_vec<V>(g_row(g, ent[e], fs, g_stride, D) + (i - e * DV) * V, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nel) {
#pragma unroll
        for (int c = 0; c < V; ++c) stage[i * V + c] = v[u][c];
      }
    }
  }
}

// Programmatic dependent launch (Hopper). A kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has called launch_dependents (or exited);
// griddep_wait then waits for that kernel's completion and its memory. In a
// kernel launched without the attribute both are no-ops.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ------------------------------------------------------------------ bucketing

// The buckets (and rows within them) of the ids r0 + 32 u + lane, u <
// kBatch, for buckets of 2^shift rows: -1 past hi or outside [id_base,
// id_base + n_rows). All loads are issued before any result is used.
__device__ __forceinline__ void load_batch(const int64_t* __restrict__ ids, int64_t ids_stride,
                                           int fs, int r0, int hi, int64_t id_base,
                                           int64_t n_rows, int shift, int (&tile)[kBatch],
                                           int (&row)[kBatch]) {
  const int lane = threadIdx.x & 31;
  const int64_t mask = ((int64_t)1 << shift) - 1;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int r = r0 + 32 * u + lane;
    tile[u] = -1;
    row[u] = 0;
    if (r < hi) {
      const int b = r / fs;
      const int64_t local = ids[(int64_t)b * ids_stride + (r - b * fs)] - id_base;
      if (local >= 0 && local < n_rows) {
        tile[u] = (int)(local >> shift);
        row[u] = (int)(local & mask);
      }
    }
  }
}

// The lanes of the warp whose key equals this lane's, for keys in [-1,
// 2^bits - 1): one ballot per bit of key + 1 (cheaper than __match_any_sync
// when the 32 keys are mostly distinct)
__device__ __forceinline__ unsigned match_key(int key, int bits) {
  const unsigned k = (unsigned)(key + 1);
  unsigned peers = kFull;
  for (int b = 0; b < bits; ++b) {
    const bool on = (k >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, on);
    peers &= on ? set : ~set;
  }
  return peers;
}

// counts[c * n_tiles + t] = the ids of chunk c (positions [c K, c K + K))
// that fall in bucket t (shared-memory integer atomics: an order-free count)
__global__ void __launch_bounds__(kThreads)
bucket_count_kernel(const int64_t* __restrict__ ids, int64_t ids_stride, int fs, int R, int K,
                    int64_t id_base, int64_t n_rows, int shift, int n_tiles,
                    int* __restrict__ counts) {
  extern __shared__ int cnt[];
  griddep_launch_dependents();
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int t = tid; t < n_tiles; t += kThreads) cnt[t] = 0;
  __syncthreads();
  const int S = K / kWarps;  // a warp's share of the chunk, a multiple of 32
  const int lo = blockIdx.x * K + warp * S, hi = min(R, lo + S);
  for (int r0 = lo; r0 < hi; r0 += 32 * kBatch) {
    int tile[kBatch], row[kBatch];
    load_batch(ids, ids_stride, fs, r0, hi, id_base, n_rows, shift, tile, row);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (tile[u] >= 0) atomicAdd(&cnt[tile[u]], 1);
  }
  __syncthreads();
  for (int t = tid; t < n_tiles; t += kThreads) counts[(size_t)blockIdx.x * n_tiles + t] = cnt[t];
}

// Exclusive prefix sum of a[0..n) in shared memory, in place, by the whole
// block (blockDim.x a multiple of 32); returns the total. sums: 33 ints of
// shared memory.
__device__ int block_exclusive_scan(int* a, int n, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (int)(blockDim.x >> 5) ? sums[lane] : 0;
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += v;
    }
    sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  int run = sums[warp] + incl - own;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = sums[32];
  __syncthreads();  // a and sums are free for the next scan
  return total;
}

// One block. offsets[c * n_tiles + t]: the first list position of chunk c's
// ids in tile t; tile_start[t]: tile t's first list position (t <= n_tiles).
// The pieces, in tile order, for k < max_pieces: a group of kGroup tiles
// whose entries together fit one staging (at most Pg) is one piece (tile
// t0, first position, entries, -tiles); any other tile is cut into pieces of
// at most P entries (tile, first position, entries, pieces of the tile),
// with tile_first[t] its first piece and done[t] = 0; past the table's end
// tile -1. The count table (n_chunks n_tiles <= kScanInts) is read into
// shared memory at once.
__global__ void __launch_bounds__(kScanThreads)
onehot_scan_kernel(const int* __restrict__ counts, int n_chunks, int n_tiles, int P, int Pg,
                   int max_pieces, int* __restrict__ offsets, int* __restrict__ tile_start,
                   int4* __restrict__ pieces, int* __restrict__ tile_first,
                   int* __restrict__ done) {
  extern __shared__ int sh[];
  int* total = sh;                // [n_tiles]: entries of a tile
  int* start = sh + n_tiles;      // [n_tiles]: its first list position
  int* first = sh + 2 * n_tiles;  // [n_groups]: pieces of a group, then its first piece
  int* cnt = sh + 3 * n_tiles;    // [n_chunks][n_tiles]
  __shared__ int sums[33];
  const int tid = threadIdx.x, n = n_chunks * n_tiles;
  const int n_groups = (n_tiles + kGroup - 1) / kGroup;
  for (int i0 = tid; i0 < n; i0 += kScanThreads * kBatch) {
    int v[kBatch];  // the loads in flight together
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kScanThreads;
      v[u] = i < n ? counts[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kScanThreads;
      if (i < n) cnt[i] = v[u];
    }
  }
  __syncthreads();
  for (int t = tid; t < n_tiles; t += kScanThreads) {
    int sum = 0;
    for (int c = 0; c < n_chunks; ++c) sum += cnt[c * n_tiles + t];
    total[t] = start[t] = sum;
  }
  __syncthreads();
  for (int gi = tid; gi < n_groups; gi += kScanThreads) {
    const int t0 = gi * kGroup, t1 = min(n_tiles, t0 + kGroup);
    int sum = 0, np = 0;
    for (int t = t0; t < t1; ++t) {
      sum += total[t];
      np += max(1, (total[t] + P - 1) / P);
    }
    first[gi] = t1 - t0 > 1 && sum <= Pg ? 1 : np;
  }
  __syncthreads();
  const int n_in = block_exclusive_scan(start, n_tiles, sums);
  const int n_pieces = block_exclusive_scan(first, n_groups, sums);
  for (int t = tid; t < n_tiles; t += kScanThreads) {
    int run = start[t];
    for (int c = 0; c < n_chunks; ++c) {
      offsets[(size_t)c * n_tiles + t] = run;
      run += cnt[c * n_tiles + t];
    }
    tile_start[t] = start[t];
    done[t] = 0;
  }
  if (tid == 0) tile_start[n_tiles] = n_in;
  for (int gi = tid; gi < n_groups; gi += kScanThreads) {
    const int t0 = gi * kGroup, t1 = min(n_tiles, t0 + kGroup);
    const int sum = (t1 < n_tiles ? start[t1] : n_in) - start[t0];
    int k = first[gi];
    if (t1 - t0 > 1 && sum <= Pg) {
      pieces[k] = make_int4(t0, start[t0], sum, t0 - t1);
      continue;
    }
    for (int t = t0; t < t1; ++t) {
      const int np = max(1, (total[t] + P - 1) / P);
      tile_first[t] = k;
      for (int q = 0; q < np; ++q)
        pieces[k++] = make_int4(t, start[t] + q * P, min(P, total[t] - q * P), np);
    }
  }
  for (int k = n_pieces + tid; k < max_pieces; k += kScanThreads)
    pieces[k] = make_int4(-1, 0, 0, 0);
}

// list[offsets of its chunk and bucket + its rank among them] = (r, row in
// the bucket), in the order of r within a chunk: the stable sort by bucket
__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int64_t* __restrict__ ids, int64_t ids_stride, int fs, int R, int K,
                      int64_t id_base, int64_t n_rows, int shift, int n_tiles,
                      const int* __restrict__ offsets, int2* __restrict__ list) {
  extern __shared__ int run[];  // [kWarps][n_tiles]
  griddep_launch_dependents();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * n_tiles; i += kThreads) run[i] = 0;
  __syncthreads();
  const int S = K / kWarps;
  const int lo = blockIdx.x * K + warp * S, hi = min(R, lo + S);
  int* mine = run + warp * n_tiles;
  const int bits = 32 - __clz(n_tiles);  // of a tile + 1
  // this warp's ids per tile (an order-free count)
  for (int r0 = lo; r0 < hi; r0 += 32 * kBatch) {
    int tile[kBatch], row[kBatch];
    load_batch(ids, ids_stride, fs, r0, hi, id_base, n_rows, shift, tile, row);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (tile[u] >= 0) atomicAdd(&mine[tile[u]], 1);
  }
  __syncthreads();
  griddep_wait();  // the scan's offsets
  // each warp's first position per tile: the chunk's, then the earlier warps'
  for (int t0 = tid; t0 < n_tiles; t0 += kThreads * kBatch) {
    int first[kBatch];  // the loads in flight together
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kThreads;
      first[u] = t < n_tiles ? __ldcg(offsets + (size_t)blockIdx.x * n_tiles + t) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kThreads;
      if (t >= n_tiles) continue;
      int s = first[u];
      for (int w = 0; w < kWarps; ++w) {
        const int v = run[w * n_tiles + t];
        run[w * n_tiles + t] = s;
        s += v;
      }
    }
  }
  __syncthreads();
  for (int r0 = lo; r0 < hi; r0 += 32 * kBatch) {
    int tile[kBatch], row[kBatch];
    load_batch(ids, ids_stride, fs, r0, hi, id_base, n_rows, shift, tile, row);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned peers = match_key(tile[u], bits);
      if (tile[u] >= 0)
        list[mine[tile[u]] + __popc(peers & ((1u << lane) - 1u))] =
            make_int2(r0 + 32 * u + lane, row[u]);
      __syncwarp();
      if (tile[u] >= 0 && lane == __ffs(peers) - 1) mine[tile[u]] += __popc(peers);
      __syncwarp();
    }
  }
}

// A block per piece: the sums of the piece's entries per (row, column), into
// out (a group of tiles, or a tile of one piece) or into the piece's
// partial, which the tile's last piece to finish adds in piece order.
template <typename G, int V>
__global__ void __launch_bounds__(kThreads)
onehot_piece_kernel(const int4* __restrict__ pieces, const int* __restrict__ tile_start,
                    const int* __restrict__ tile_first, const int2* __restrict__ list,
                    const G* __restrict__ g, int fs, int64_t g_stride, int D, int n_rows, int P,
                    int C, float* __restrict__ partials, int* __restrict__ done,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);             // [kTile][J W]
  float* stage = part + kTile * kThreads;                        // [C][D]
  int* ent_r = reinterpret_cast<int*>(stage + (size_t)C * D);    // [P]
  int* ent_row = ent_r + P;                                      // [P]
  __shared__ int is_last;
  const int4 pc = pieces[blockIdx.x];
  const int t0 = pc.x, p0 = pc.y, n = pc.z;
  if (t0 < 0) return;
  const int n_tiles = pc.w < 0 ? -pc.w : 1, np = pc.w < 0 ? 1 : pc.w;
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) {
    const int2 e = list[p0 + i];
    ent_r[i] = e.x;
    ent_row[i] = e.y;
  }
  // a piece that fits one staging (every group) is staged once for all its
  // tiles and slabs
  const bool staged = n <= C;
  if (staged) {
    __syncthreads();
    stage_rows<G, V>(g, fs, g_stride, D, n, ent_r, stage);
  }
  // thread tid = j W + dd (tid < J W): column s0 + dd of a slab of W
  // columns, entries j, j + J, ... of a tile; part[row][tid] is its own sum
  // for that row
  const int W = min(D, kThreads);
  const int J = kThreads / W, JW = J * W;
  const int j = tid / W, dd = tid - j * W;
  float* mine = part + tid;
  for (int q = 0; q < n_tiles; ++q) {
    const int t = t0 + q;
    // this tile's entries [e0, e1) of the piece
    const int e0 = n_tiles == 1 ? 0 : tile_start[t] - p0;
    const int e1 = n_tiles == 1 ? n : tile_start[t + 1] - p0;
    const int v0 = t * kTile, rows = min(kTile, n_rows - v0);
    float* dest = np == 1 ? out + (size_t)v0 * D : partials + (size_t)blockIdx.x * kTile * D;
    for (int s0 = 0; s0 < D; s0 += W) {
      const int w = min(W, D - s0);
      const bool active = j < J && dd < w;
      if (tid < JW)
        for (int r = 0; r < kTile; ++r) mine[r * JW] = 0.f;
      // a run of one row among this thread's entries stays in a register
      int cur = -1, i = e0 + j;
      float acc = 0.f;
      for (int c0 = e0; c0 < e1; c0 += C) {
        const int nc = min(C, e1 - c0), base = staged ? 0 : c0;
        __syncthreads();  // the entries are loaded and staged; the last chunk is consumed
        if (!staged) {
          stage_rows<G, V>(g, fs, g_stride, D, nc, ent_r + c0, stage);
          __syncthreads();
        }
        if (!active) continue;
        const float* col = stage + s0 + dd;
        // four entries' loads in flight, then their adds in order
        for (; i + 3 * J < c0 + nc; i += 4 * J) {
          int rw[4];
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            rw[u] = ent_row[i + u * J];
            x[u] = col[(size_t)(i + u * J - base) * D];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (rw[u] != cur) {
              if (cur >= 0) mine[cur * JW] += acc;
              cur = rw[u];
              acc = 0.f;
            }
            acc += x[u];
          }
        }
        for (; i < c0 + nc; i += J) {
          const int row = ent_row[i];
          if (row != cur) {
            if (cur >= 0) mine[cur * JW] += acc;
            cur = row;
            acc = 0.f;
          }
          acc += col[(size_t)(i - base) * D];
        }
      }
      if (cur >= 0) mine[cur * JW] += acc;
      __syncthreads();
      for (int idx = tid; idx < rows * w; idx += kThreads) {
        const int row = idx / w, d = idx - row * w;
        const float* p = part + row * JW + d;
        float s = 0.f;
        for (int r = 0; r < J; ++r) s += p[r * W];
        dest[(size_t)row * D + s0 + d] = s;
      }
      __syncthreads();  // part is zeroed again for the next slab or tile
    }
  }
  const int t = t0, v0 = t * kTile, rows = min(kTile, n_rows - v0);
  if (np == 1) return;
  __threadfence();  // this piece's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&done[t], 1) == np - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the tile's partials in piece order, 16 bytes and kInFlight pieces a load
  // round (a partial is kTile D floats, a multiple of 4)
  const int n4 = kTile * D / 4, n_out = rows * D;
  const float4* src = reinterpret_cast<const float4*>(partials + (size_t)tile_first[t] * kTile * D);
  float* o = out + (size_t)v0 * D;
  for (int f = tid; f < n4; f += kThreads) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < np; q0 += kInFlight) {
      float4 x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (q0 + u < np) x[u] = __ldcg(src + (size_t)(q0 + u) * n4 + f);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (q0 + u < np) {
          sum[0] += x[u].x;
          sum[1] += x[u].y;
          sum[2] += x[u].z;
          sum[3] += x[u].w;
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * f + c < n_out) o[4 * f + c] = sum[c];
  }
}

// ------------------------------------------------------------------- windowed

// One block. offsets[c * nw + w]: the first list position of chunk c's ids
// in window w; win_start[w]: window w's first list position (w <= nw). A
// window of n entries is ceil(n / P) pieces of at most P entries; the first
// is its own block's, the others are listed in window order: ext[k] =
// (window, piece) for k < meta[0]. done[w] = 0.
// With ids (a short id list), the block counts the ids per (chunk, window)
// itself (shared-memory integer atomics); otherwise it reads the count
// kernel's table. The table (n_chunks nw <= kScanInts) lives in shared
// memory.
__global__ void __launch_bounds__(kScanThreads)
windowed_scan_kernel(const int64_t* __restrict__ ids, int64_t ids_stride, int fs, int R, int K,
                     int64_t id_base, int64_t n_rows, int shift, const int* __restrict__ counts,
                     int n_chunks, int nw, int P, int* __restrict__ offsets,
                     int* __restrict__ win_start, int2* __restrict__ ext,
                     int* __restrict__ done, int* __restrict__ meta) {
  extern __shared__ int sh[];
  int* start = sh;            // [nw]: entries of a window, then its first position
  int* extra = sh + nw;       // [nw]: its pieces past the first, then their first index
  int* cnt = sh + 2 * nw;     // [n_chunks][nw]
  __shared__ int sums[33];
  griddep_launch_dependents();
  const int tid = threadIdx.x, n = n_chunks * nw;
  // the tickets were last read by the previous call's piece kernel, which
  // ended before this call's first kernel began
  for (int w = tid; w < nw; w += kScanThreads) done[w] = 0;
  if (ids) {
    for (int i = tid; i < n; i += kScanThreads) cnt[i] = 0;
    __syncthreads();
    for (int r0 = tid; r0 < R; r0 += kScanThreads * kBatch) {
      int64_t local[kBatch];  // the loads in flight together
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * kScanThreads, b = r / fs;
        local[u] = r < R ? ids[(int64_t)b * ids_stride + (r - b * fs)] - id_base : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (local[u] >= 0 && local[u] < n_rows)
          atomicAdd(&cnt[(r0 + u * kScanThreads) / K * nw + (int)(local[u] >> shift)], 1);
    }
  } else {
    griddep_wait();  // the counts
    for (int i0 = tid; i0 < n; i0 += kScanThreads * kBatch) {
      int v[kBatch];  // the loads in flight together
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kScanThreads;
        v[u] = i < n ? __ldcg(counts + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kScanThreads;
        if (i < n) cnt[i] = v[u];
      }
    }
  }
  __syncthreads();
  for (int w = tid; w < nw; w += kScanThreads) {
    int sum = 0;
    for (int c = 0; c < n_chunks; ++c) sum += cnt[c * nw + w];
    start[w] = sum;
    extra[w] = sum > P ? (sum - 1) / P : 0;
  }
  __syncthreads();
  const int n_in = block_exclusive_scan(start, nw, sums);
  const int n_extra = block_exclusive_scan(extra, nw, sums);
  for (int w = tid; w < nw; w += kScanThreads) {
    int run = start[w];
    for (int c = 0; c < n_chunks; ++c) {
      offsets[(size_t)c * nw + w] = run;
      run += cnt[c * nw + w];
    }
    win_start[w] = start[w];
    const int np = 1 + (w + 1 < nw ? extra[w + 1] : n_extra) - extra[w];
    for (int q = 1; q < np; ++q) ext[extra[w] + q - 1] = make_int2(w, q);
  }
  if (tid == 0) {
    win_start[nw] = n_in;
    meta[0] = n_extra;
  }
}

// Zero rows [v0, v1) of the (., D) fp32 table out: 16-byte stores between
// a scalar head and tail, marked evict-first, so that the table streaming
// through L2 does not push out the bucketing's ids and tables, which run
// beside it.
__device__ __forceinline__ void zero_rows(float* out, int64_t v0, int64_t v1, int D) {
  float* p = out + v0 * D;
  const int64_t n = (v1 - v0) * D;
  const int64_t head = min(n, (int64_t)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4));
  if (threadIdx.x < head) __stcs(p + threadIdx.x, 0.f);
  float4* q = reinterpret_cast<float4*>(p + head);
  const int64_t n4 = (n - head) / 4;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = threadIdx.x; i < n4; i += kThreads) __stcs(q + i, z);
  for (int64_t i = head + 4 * n4 + threadIdx.x; i < n; i += kThreads) __stcs(p + i, 0.f);
}

// One piece of window w (rows from v0 = w 2^shift; list range [s, s + n_w),
// np pieces of at most P entries): its n entries at list positions [p0, p0 +
// n) are ranked by row, stably, their cotangent rows staged in that order,
// each run of one row summed, and the sum written to out (np == 1) or, with
// the runs numbered in order, to the piece's partial slots p0, p0 + 1, ...;
// the last piece to finish adds all partials into the window's zeroed rows
// in piece order. Shared memory: stage [P4][D] f32, then er, ek, sr, sk
// [P4 + 4] int each (P4: P rounded up to 4).
template <typename G, int V>
__device__ void sum_piece(float* stage, int* er, int* ek, int* sr, int* sk, int* sums,
                          const int2* __restrict__ list, int p0, int n, int64_t v0, int np, int w,
                          int s, int n_w, int P, const G* __restrict__ g, int fs,
                          int64_t g_stride, int D, int* __restrict__ part_key,
                          float* __restrict__ part_val, int* __restrict__ done,
                          float* __restrict__ out, int* is_last, int* runs_of) {
  const int tid = threadIdx.x, n4 = (n + 3) / 4;
  for (int i = tid; i < 4 * n4; i += kThreads) {
    int2 e = make_int2(0, INT_MAX);  // padding ranks after every entry
    if (i < n) e = __ldcg(list + p0 + i);
    er[i] = e.x;
    ek[i] = e.y;
  }
  __syncthreads();
  // stable rank by row: the entries with a smaller row, or the same row and
  // an earlier position (four keys a shared-memory load)
  for (int i = tid; i < n; i += kThreads) {
    const int key = ek[i];
    const int4* k4 = reinterpret_cast<const int4*>(ek);
    int rank = 0;
    for (int q = 0; q < n4; ++q) {
      const int4 o = k4[q];
      const int j = 4 * q;
      rank += (o.x < key || (o.x == key && j < i)) + (o.y < key || (o.y == key && j + 1 < i)) +
              (o.z < key || (o.z == key && j + 2 < i)) + (o.w < key || (o.w == key && j + 3 < i));
    }
    sr[rank] = er[i];
    sk[rank] = key;
  }
  __syncthreads();
  stage_rows<G, V>(g, fs, g_stride, D, n, sr, stage);
  __syncthreads();
  // thread tid = j W + dd (tid < J W): column s0 + dd of a slab of W
  // columns and the positions j, j + J, ...: it sums its positions of each
  // run and leaves the sum at its first position of the run, so a run's
  // partials lie at its first (at most J) positions, one per residue
  const int W = min(D, kThreads), J = kThreads / W;
  const int j = tid / W, dd = tid - j * W;
  for (int s0 = 0; s0 < D; s0 += W) {
    if (j < J && dd < min(W, D - s0)) {
      float* col = stage + s0 + dd;
      int cur = -1, first = 0;
      float acc = 0.f;
      for (int i = j; i < n; i += J) {
        const int key = sk[i];
        if (key != cur) {
          if (cur >= 0) col[(size_t)first * D] = acc;
          cur = key;
          first = i;
          acc = 0.f;
        }
        acc += col[(size_t)i * D];
      }
      if (cur >= 0) col[(size_t)first * D] = acc;
    }
  }
  // the runs in order: er[h] = the first position of run h, er[n_runs] = n
  for (int i = tid; i < n; i += kThreads) ek[i] = i == 0 || sk[i - 1] != sk[i];
  __syncthreads();
  const int n_runs = block_exclusive_scan(ek, n, sums);
  for (int i = tid; i < n; i += kThreads)
    if (i == 0 || sk[i - 1] != sk[i]) er[ek[i]] = i;
  if (tid == 0) er[n_runs] = n;
  __syncthreads();
  // run h's sum, its partials (the run's first J positions) added in order
  // of position: thread (j, dd) takes runs j, j + J, ... of column s0 + dd
  for (int s0 = 0; s0 < D; s0 += W) {
    if (j >= J || dd >= min(W, D - s0)) continue;
    const int d = s0 + dd;
    for (int h = j; h < n_runs; h += J) {
      const int a = er[h], e = min(er[h + 1], a + J);
      float sum = 0.f;
      for (int q = a; q < e; ++q) sum += stage[(size_t)q * D + d];
      if (np == 1)
        out[(v0 + sk[a]) * D + d] = sum;
      else
        part_val[(size_t)(p0 + h) * D + d] = sum;
    }
  }
  if (np == 1) return;
  for (int h = tid; h < n; h += kThreads) part_key[p0 + h] = h < n_runs ? sk[er[h]] : -1;
  __threadfence();  // this piece's partials are visible before it is counted
  __syncthreads();
  if (tid == 0) *is_last = atomicAdd(&done[w], 1) == np - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  // the pieces' partials in piece order, added into the zeroed rows (a
  // piece's runs have distinct rows); kCombine elements a thread in flight
  constexpr int kCombine = 8;
  for (int pq = 0; pq < np; ++pq) {
    const int a = s + pq * P, m = min(P, n_w - pq * P);
    __syncthreads();  // the keys and the run count of the last piece are consumed
    if (tid == 0) *runs_of = 0;
    __syncthreads();
    int mine = 0;
    for (int i = tid; i < m; i += kThreads) {
      ek[i] = __ldcg(part_key + a + i);
      mine += ek[i] >= 0;
    }
    if (mine) atomicAdd(runs_of, mine);
    __syncthreads();
    const int runs = *runs_of;
    for (int i0 = tid; i0 < runs * D; i0 += kThreads * kCombine) {
      float x[kCombine], o[kCombine];
      int64_t at[kCombine];
#pragma unroll
      for (int u = 0; u < kCombine; ++u) {
        const int idx = i0 + u * kThreads, i = idx / D, d = idx - i * D;
        at[u] = -1;
        if (idx < runs * D) {
          at[u] = (v0 + ek[i]) * D + d;
          x[u] = __ldcg(part_val + (size_t)(a + i) * D + d);
          o[u] = __ldcg(out + at[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kCombine; ++u)
        if (at[u] >= 0) __stcg(out + at[u], o[u] + x[u]);
    }
  }
}

// A window of at most 32 entries by one warp: lane i takes entry i, ranks
// it by row, stably (32 shuffles), and the sorted (r, row) pairs go to the
// warp's shared arrays; then lane c owns column c0 + c and walks the sorted
// entries, kInFlight loads in flight, adding each run of one row in order
// of position and writing its sum to out row v0 + row.
template <typename G>
__device__ void sum_small_window(int* wr, int* wk, const int2* __restrict__ list, int s, int n,
                                 int64_t v0, const G* __restrict__ g, int fs, int64_t g_stride,
                                 int D, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  int r = 0, key = 0;
  if (lane < n) {
    const int2 e = __ldcg(list + s + lane);
    r = e.x;
    key = e.y;
  }
  int rank = 0;
  for (int j = 0; j < n; ++j) {
    const int o = __shfl_sync(kFull, key, j);
    rank += o < key || (o == key && j < lane);
  }
  if (lane < n) {
    wr[rank] = r;
    wk[rank] = key;
  }
  __syncwarp();
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < D;
    int cur = wk[0];
    float acc = 0.f;
    for (int k0 = 0; k0 < n; k0 += kInFlight) {
      float x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        float v = 0.f;
        if (on && k0 + u < n) load_vec<1>(g_row(g, wr[k0 + u], fs, g_stride, D) + c, &v);
        x[u] = v;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (k0 + u >= n) break;
        if (wk[k0 + u] != cur) {
          if (on) out[(v0 + cur) * D + c] = acc;
          cur = wk[k0 + u];
          acc = 0.f;
        }
        acc += x[u];
      }
    }
    if (on) out[(v0 + cur) * D + c] = acc;
  }
  __syncwarp();  // the shared arrays are free for the warp's next window
}

// Block b owns the windows b, b + grid, ... (n_own of them). It zeroes
// their rows with 16-byte stores first, then waits for the scatter (and so
// the scan) and reads its windows' list ranges at once. Then, so that a hot
// window's pieces start first: the extra pieces t - nw for the work indices
// t = nw, ..., nw + meta[0] - 1 that fall to it (t mod grid == b), the first
// piece of each owned window of more than min(32, P) entries (the whole
// block), and last the owned windows of at most min(32, P), a warp each: a
// window the scan cut into pieces (more than P entries) is always the
// block's.
template <typename G, int V>
__global__ void __launch_bounds__(kThreads, 4)
windowed_piece_kernel(const int* __restrict__ win_start, const int2* __restrict__ ext,
                      const int* __restrict__ meta, const int2* __restrict__ list,
                      const G* __restrict__ g, int fs, int64_t g_stride, int D, int64_t n_rows,
                      int shift, int nw, int P, int* __restrict__ part_key,
                      float* __restrict__ part_val, int* __restrict__ done,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P4 = (P + 3) & ~3;
  float* stage = reinterpret_cast<float*>(smem_raw);         // [P4][D]
  int* er = reinterpret_cast<int*>(stage + (size_t)P4 * D);   // r in list order; run starts
  int* ek = er + P4 + 4;                                      // its row in the window
  int* sr = ek + P4 + 4;                                      // r, by row (stable)
  int* sk = sr + P4 + 4;                                      // the rows, sorted
  int* own = sk + P4 + 4;                                     // [2 n_own]: list bounds
  __shared__ int warp_r[kWarps][32], warp_k[kWarps][32];
  __shared__ int sums[33];
  __shared__ int is_last, runs_of;
  const int b = blockIdx.x, G_ = gridDim.x, tid = threadIdx.x, warp = tid >> 5;
  const int small = min(32, P);  // the most entries of a warp's window
  const int n_own = b < nw ? (nw - 1 - b) / G_ + 1 : 0;
  for (int i = 0; i < n_own; ++i) {
    const int w = b + i * G_;
    zero_rows(out, (int64_t)w << shift, min(n_rows, (int64_t)(w + 1) << shift), D);
  }
  griddep_wait();  // the scatter's list (and so the scan's tables)
  // the tables of kernels that may have run beside this one: read past L1
  for (int i = tid; i < 2 * n_own; i += kThreads)
    own[i] = __ldcg(win_start + b + (i >> 1) * G_ + (i & 1));
  const int n_extra = __ldcg(meta);
  __syncthreads();  // also: the zeros land before any thread of the block adds to them
  for (int t = nw + (b - nw % G_ + G_) % G_; t < nw + n_extra; t += G_) {
    const int2 e = __ldcg(ext + t - nw);
    const int s = __ldcg(win_start + e.x), n_w = __ldcg(win_start + e.x + 1) - s;
    sum_piece<G, V>(stage, er, ek, sr, sk, sums, list, s + e.y * P, min(P, n_w - e.y * P),
                    (int64_t)e.x << shift, (n_w + P - 1) / P, e.x, s, n_w, P, g, fs, g_stride,
                    D, part_key, part_val, done, out, &is_last, &runs_of);
    __syncthreads();  // the shared arrays are free for the next piece
  }
  for (int i = 0; i < n_own; ++i) {
    const int w = b + i * G_, s = own[2 * i], n_w = own[2 * i + 1] - s;
    if (n_w <= small) continue;
    sum_piece<G, V>(stage, er, ek, sr, sk, sums, list, s, min(P, n_w), (int64_t)w << shift,
                    (n_w + P - 1) / P, w, s, n_w, P, g, fs, g_stride, D, part_key, part_val,
                    done, out, &is_last, &runs_of);
    __syncthreads();
  }
  for (int i = warp; i < n_own; i += kWarps) {
    const int s = own[2 * i], n_w = own[2 * i + 1] - s;
    if (n_w > 0 && n_w <= small)
      sum_small_window<G>(warp_r[warp], warp_k[warp], list, s, n_w,
                          (int64_t)(b + i * G_) << shift, g, fs, g_stride, D, out);
  }
}

// ------------------------------------------------------------------- launch

int onehot_tiles(int n_rows) { return (n_rows + kTile - 1) / kTile; }
// most entries of a piece: narrow rows stage fast, so their hot tiles are
// cut finer and spread over more blocks
int onehot_piece(int D) { return D >= 32 ? kPiece : kNarrowPiece; }
// ids of a chunk: kChunk, or a multiple of it that keeps the count table
// (chunks x buckets) within the scan's kScanInts
int bucket_chunk(int R, int n_buckets) {
  const int most = kScanInts / n_buckets;
  const int per = (R + most - 1) / most;
  return kChunk * max(1, (per + kChunk - 1) / kChunk);
}
int bucket_chunks(int R, int n_buckets) {
  const int K = bucket_chunk(R, n_buckets);
  return (R + K - 1) / K;
}
int onehot_chunk(int R, int n_rows) { return bucket_chunk(R, onehot_tiles(n_rows)); }
int onehot_chunks(int R, int n_rows) { return bucket_chunks(R, onehot_tiles(n_rows)); }
int onehot_max_pieces(int R, int D, int n_rows) {
  return onehot_tiles(n_rows) + (R + onehot_piece(D) - 1) / onehot_piece(D);
}
// staged rows of a piece block
int onehot_stage_rows(int D) { return min(kStageRows, kPieceStageFloats / D); }

bool onehot_shape_ok(int R, int D, int n_rows) {
  return R >= 0 && R < (1 << 30) && D >= 1 && D <= 4096 && n_rows >= 1 &&
         onehot_tiles(n_rows) <= kMaxTiles;
}

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// the scratch layout: pieces (int4), partials (max_pieces, kTile, D) f32, list
// (R int2), counts and offsets (n_chunks, n_tiles) int, tile_first and done
// (n_tiles) int, tile_start (n_tiles + 1) int
struct OnehotScratch {
  int4* pieces;
  float* partials;
  int2* list;
  int *counts, *offsets, *tile_first, *done, *tile_start;
  size_t bytes;
};

OnehotScratch carve(unsigned char* base, int R, int D, int n_rows) {
  const size_t nt = onehot_tiles(n_rows), nc = onehot_chunks(R, n_rows);
  const size_t mp = onehot_max_pieces(R, D, n_rows);
  OnehotScratch k;
  size_t at = 0;
  k.pieces = reinterpret_cast<int4*>(base + at);
  at += align16(sizeof(int4) * mp);
  k.partials = reinterpret_cast<float*>(base + at);
  at += align16(sizeof(float) * mp * kTile * D);
  k.list = reinterpret_cast<int2*>(base + at);
  at += align16(sizeof(int2) * (size_t)R);
  k.counts = reinterpret_cast<int*>(base + at);
  k.offsets = k.counts + nc * nt;
  k.tile_first = k.offsets + nc * nt;
  k.done = k.tile_first + nt;
  k.tile_start = k.done + nt;
  at += sizeof(int) * (2 * nc * nt + 3 * nt + 1);
  k.bytes = at;
  return k;
}

// What the runtime says of a kernel on the current device with smem bytes
// of dynamic shared memory: the SM count, and how many blocks of threads an
// SM holds, its limit raised past 48 KB first (err: the first failure).
// These depend on the device, the kernel and the bytes alone, so each is
// asked once and kept. The limit only rises, to the most bytes the kernel
// has been asked for on the device, so every size kept stays allowed.
struct Fit {
  int dev;
  const void* kernel;
  size_t smem;
  int err, sms, per_sm;
};

Fit fit(const void* kernel, int threads, size_t smem) {
  static std::mutex mu;
  static std::vector<Fit> seen;
  Fit f = {0, kernel, smem, 0, 0, 0};
  f.err = (int)cudaGetDevice(&f.dev);
  if (f.err) return f;
  std::lock_guard<std::mutex> hold(mu);
  size_t most = 48 * 1024;
  for (const Fit& o : seen)
    if (o.dev == f.dev && o.kernel == kernel) {
      if (o.smem == smem) return o;
      most = std::max(most, o.smem);
    }
  if (smem > most)
    f.err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (!f.err) f.err = (int)cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, f.dev);
  if (!f.err)
    f.err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel, threads, smem);
  if (!f.err) seen.push_back(f);
  return f;
}

// Let kernel take bytes of dynamic shared memory (nothing to do up to 48 KB)
template <typename K>
int allow_smem(K kernel, int threads, size_t bytes) {
  return bytes <= 48 * 1024 ? 0 : fit((const void*)kernel, threads, bytes).err;
}

template <typename G, int V>
int launch_pieces(const OnehotScratch& k, int mp, const G* g, int fs, int64_t g_stride, int D,
                  int n_rows, float* out, cudaStream_t s) {
  const int C = onehot_stage_rows(D), P = onehot_piece(D);
  const size_t smem = sizeof(float) * ((size_t)kTile * kThreads + (size_t)C * D) +
                      sizeof(int) * 2 * P;
  const int err = allow_smem(onehot_piece_kernel<G, V>, kThreads, smem);
  if (err) return err;
  onehot_piece_kernel<G, V><<<mp, kThreads, smem, s>>>(k.pieces, k.tile_start, k.tile_first,
                                                       k.list, g, fs, g_stride, D, n_rows, P, C,
                                                       k.partials, k.done, out);
  return 0;
}

template <typename G>
int launch_onehot(const int64_t* ids, int64_t ids_stride, int fs, const G* g, int64_t g_stride,
                  int R, int D, int64_t id_base, int n_rows, unsigned char* scratch,
                  float* out, cudaStream_t s) {
  if (!onehot_shape_ok(R, D, n_rows) || fs < 1) return (int)cudaErrorInvalidValue;
  const int nt = onehot_tiles(n_rows), K = onehot_chunk(R, n_rows);
  const int nc = onehot_chunks(R, n_rows);
  const int mp = onehot_max_pieces(R, D, n_rows);
  const OnehotScratch k = carve(scratch, R, D, n_rows);
  const size_t tile_ints = sizeof(int) * nt;
  const size_t scan_smem = sizeof(int) * (3 + (size_t)nc) * nt;
  int err = allow_smem(bucket_scatter_kernel, kThreads, kWarps * tile_ints);
  if (!err) err = allow_smem(onehot_scan_kernel, kScanThreads, scan_smem);
  if (err) return err;
  if (nc > 0)
    bucket_count_kernel<<<nc, kThreads, tile_ints, s>>>(ids, ids_stride, fs, R, K, id_base,
                                                        n_rows, kTileShift, nt, k.counts);
  const int P = onehot_piece(D);
  onehot_scan_kernel<<<1, kScanThreads, scan_smem, s>>>(
      k.counts, nc, nt, P, min(P, onehot_stage_rows(D)), mp, k.offsets, k.tile_start, k.pieces,
      k.tile_first, k.done);
  if (nc > 0)
    bucket_scatter_kernel<<<nc, kThreads, kWarps * tile_ints, s>>>(
        ids, ids_stride, fs, R, K, id_base, n_rows, kTileShift, nt, k.offsets, k.list);
  // rows of 4-element loads when every row starts on a 4-element boundary
  const bool vec = D % 4 == 0 && g_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(G)) == 0;
  err = vec ? launch_pieces<G, 4>(k, mp, g, fs, g_stride, D, n_rows, out, s)
            : launch_pieces<G, 1>(k, mp, g, fs, g_stride, D, n_rows, out, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The windowed path's shape: windows of 2^shift rows, the fewest (at least
// kTile) that keep them within kMaxTiles; pieces of at most P entries
struct WindowedShape {
  int shift, nw, K, nc, P, max_extra;
};

WindowedShape windowed_shape(int R, int D, int64_t n_rows) {
  WindowedShape w;
  w.shift = kTileShift;
  while ((n_rows + ((int64_t)1 << w.shift) - 1) >> w.shift > kMaxTiles) ++w.shift;
  w.nw = (int)((n_rows + ((int64_t)1 << w.shift) - 1) >> w.shift);
  w.K = bucket_chunk(R, w.nw);
  w.nc = bucket_chunks(R, w.nw);
  w.P = max(1, min(D >= 32 ? kWindowedPiece : kWindowedNarrowPiece, kWindowedStageFloats / D));
  w.max_extra = (R + w.P - 1) / w.P;
  return w;
}

// a row in a window is an int, so a window holds at most 2^30 rows
bool windowed_shape_ok(int R, int D, int64_t n_rows) {
  return R >= 0 && R < (1 << 30) && D >= 1 && D <= 4096 && n_rows >= 1 &&
         n_rows <= ((int64_t)kMaxTiles << 30);
}

// the scratch layout: ext (max_extra int2), list (R int2), part_val (R, D)
// f32, part_key (R) int, counts and offsets (n_chunks, nw) int, done (nw)
// int, win_start (nw + 1) int, meta (1) int
struct WindowedScratch {
  int2 *ext, *list;
  float* part_val;
  int *part_key, *counts, *offsets, *done, *win_start, *meta;
  size_t bytes;
};

WindowedScratch carve_windowed(unsigned char* base, int R, int D, const WindowedShape& w) {
  WindowedScratch k;
  size_t at = 0;
  k.ext = reinterpret_cast<int2*>(base + at);
  at += align16(sizeof(int2) * (size_t)w.max_extra);
  k.list = reinterpret_cast<int2*>(base + at);
  at += align16(sizeof(int2) * (size_t)R);
  k.part_val = reinterpret_cast<float*>(base + at);
  at += align16(sizeof(float) * (size_t)R * D);
  k.part_key = reinterpret_cast<int*>(base + at);
  k.counts = k.part_key + R;
  k.offsets = k.counts + (size_t)w.nc * w.nw;
  k.done = k.offsets + (size_t)w.nc * w.nw;
  k.win_start = k.done + w.nw;
  k.meta = k.win_start + w.nw + 1;
  at += sizeof(int) * ((size_t)R + 2 * (size_t)w.nc * w.nw + 2 * (size_t)w.nw + 2);
  k.bytes = at;
  return k;
}

// Launch kernel on stream s; if dependent, under programmatic stream
// serialization (it may start while the kernel before it runs, and waits for
// it in griddep_wait).
template <typename... KArgs, typename... Args>
int launch(bool dependent, void (*kernel)(KArgs...), int grid, int threads, size_t smem,
           cudaStream_t s, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

template <typename G, int V>
int launch_windowed_pieces(const WindowedScratch& k, const WindowedShape& w, const G* g, int fs,
                           int64_t g_stride, int D, int64_t n_rows, float* out,
                           cudaStream_t s) {
  auto kernel = windowed_piece_kernel<G, V>;
  // the staged rows, the four entry arrays, and the owned windows' list
  // bounds (a grid of at least the card's SMs owns at most 16 of kMaxTiles
  // windows a block: kOwnInts is room for 64)
  constexpr int kOwnInts = 128;
  const size_t P4 = (w.P + 3) & ~3;
  const size_t smem = sizeof(float) * P4 * D + sizeof(int) * (4 * (P4 + 4) + kOwnInts);
  const Fit f = fit((const void*)kernel, kThreads, smem);
  if (f.err) return f.err;
  // no more blocks than the card holds at once, so that all of the zero
  // fill runs under stages 1-3
  const int grid = (int)min((int64_t)max(1, f.sms * f.per_sm), (int64_t)w.nw + w.max_extra);
  if (2 * ((w.nw + grid - 1) / grid) > kOwnInts) return (int)cudaErrorInvalidConfiguration;
  return launch(true, kernel, grid, kThreads, smem, s, k.win_start, k.ext, k.meta, k.list, g, fs,
                g_stride, D, n_rows, w.shift, w.nw, w.P, k.part_key, k.part_val, k.done, out);
}

template <typename G>
int launch_windowed(const int64_t* ids, int64_t ids_stride, int fs, const G* g,
                    int64_t g_stride, int R, int D, int64_t id_base, int64_t n_rows,
                    unsigned char* scratch, float* out, cudaStream_t s) {
  if (!windowed_shape_ok(R, D, n_rows) || fs < 1) return (int)cudaErrorInvalidValue;
  const WindowedShape w = windowed_shape(R, D, n_rows);
  const WindowedScratch k = carve_windowed(scratch, R, D, w);
  const size_t win_ints = sizeof(int) * w.nw;
  const size_t scan_smem = sizeof(int) * (2 + (size_t)w.nc) * w.nw;
  int err = allow_smem(bucket_scatter_kernel, kThreads, kWarps * win_ints);
  if (!err) err = allow_smem(windowed_scan_kernel, kScanThreads, scan_smem);
  if (err) return err;
  // the first kernel waits for the caller's kernels as any launch does; the
  // rest follow it under programmatic serialization. A short id list is
  // counted by the scan block itself.
  const bool count = R > kScanCountIds;
  if (count)
    bucket_count_kernel<<<w.nc, kThreads, win_ints, s>>>(ids, ids_stride, fs, R, w.K, id_base,
                                                         n_rows, w.shift, w.nw, k.counts);
  err = launch(count, windowed_scan_kernel, 1, kScanThreads, scan_smem, s,
               count ? nullptr : ids, ids_stride, fs, R, w.K, id_base, n_rows, w.shift,
               (const int*)k.counts, w.nc, w.nw, w.P, k.offsets, k.win_start, k.ext, k.done,
               k.meta);
  if (!err && w.nc > 0)
    err = launch(true, bucket_scatter_kernel, w.nc, kThreads, kWarps * win_ints, s, ids,
                 ids_stride, fs, R, w.K, id_base, n_rows, w.shift, w.nw,
                 (const int*)k.offsets, k.list);
  if (err) return err;
  const bool vec = D % 4 == 0 && g_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(G)) == 0;
  err = vec ? launch_windowed_pieces<G, 4>(k, w, g, fs, g_stride, D, n_rows, out, s)
            : launch_windowed_pieces<G, 1>(k, w, g, fs, g_stride, D, n_rows, out, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace


// The most rows a one-hot call takes (kMaxTiles tiles of kTile rows).
extern "C" int embed_grad_onehot_max_rows() { return kMaxTiles * kTile; }

// Bytes of device scratch embed_grad_onehot needs for (R, D, n_rows); -1 for
// a shape it does not take.
extern "C" long long embed_grad_onehot_scratch_bytes(int R, int D, int n_rows) {
  if (!onehot_shape_ok(R, D, n_rows)) return -1;
  return (long long)carve(nullptr, R, D, n_rows).bytes;
}

// ids int64, R of them (0 <= R < 2^30, a multiple of fs) in the layout
// described at the top; g float32 (g_is_bf16 == 0) or bfloat16, 1 <= D <=
// 4096; out (n_rows, D) float32 contiguous, 1 <= n_rows <=
// embed_grad_onehot_max_rows(); scratch embed_grad_onehot_scratch_bytes
// bytes, 16-byte aligned. Ids outside [id_base, id_base + n_rows) match no
// row. Four launches on the stream (two when R == 0). Returns the CUDA
// error code.
extern "C" int embed_grad_onehot(const void* ids, long long ids_stride, int fs, const void* g,
                                 long long g_stride, int g_is_bf16, int R, int D,
                                 long long id_base, int n_rows, void* scratch, float* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* i64 = static_cast<const int64_t*>(ids);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (g_is_bf16)
    return launch_onehot(i64, ids_stride, fs, static_cast<const __nv_bfloat16*>(g), g_stride, R,
                         D, id_base, n_rows, sc, out, s);
  return launch_onehot(i64, ids_stride, fs, static_cast<const float*>(g), g_stride, R, D,
                       id_base, n_rows, sc, out, s);
}

// Bytes of device scratch embed_grad_windowed needs for (R, D, n_rows); -1
// for a shape it does not take.
extern "C" long long embed_grad_windowed_scratch_bytes(int R, int D, long long n_rows) {
  if (!windowed_shape_ok(R, D, n_rows)) return -1;
  return (long long)carve_windowed(nullptr, R, D, windowed_shape(R, D, n_rows)).bytes;
}

// ids and g as for embed_grad_onehot; out (n_rows, D) float32 contiguous,
// 1 <= D <= 4096, 1 <= n_rows <= 2^41 (row offsets are formed in 64 bits,
// so n_rows * D may pass 2^31); scratch embed_grad_windowed_scratch_bytes
// bytes, 16-byte aligned. Ids outside [id_base, id_base + n_rows) are
// dropped. Three launches on the stream (four past kScanCountIds ids, two
// when R == 0), all but the first under programmatic stream serialization,
// so the table's zero fill runs under the bucketing. Returns the CUDA error
// code.
extern "C" int embed_grad_windowed(const void* ids, long long ids_stride, int fs, const void* g,
                                   long long g_stride, int g_is_bf16, int R, int D,
                                   long long id_base, long long n_rows, void* scratch,
                                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* i64 = static_cast<const int64_t*>(ids);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (g_is_bf16)
    return launch_windowed(i64, ids_stride, fs, static_cast<const __nv_bfloat16*>(g), g_stride,
                           R, D, id_base, n_rows, sc, out, s);
  return launch_windowed(i64, ids_stride, fs, static_cast<const float*>(g), g_stride, R, D,
                         id_base, n_rows, sc, out, s);
}
