// Dense gradient of an embedding row gather, for NVIDIA Hopper (sm_90a):
//
//   out[v, :] = sum over r with ids[r] == id_base + v of g[r, :]      (fp32)
//
// out is (n_rows, D); every row is written exactly once, zero where no id
// hits. Two kernels compute this function:
//
// * the one-hot path replaces the Pallas kernel ``onehot_matmul_grad``
//   (recbole_tpu/ops/embed_grad.py:78), which feeds the TPU's matrix unit a
//   one-hot of the ids. It takes the ids unsorted and buckets them on the
//   device (four launches, below).
// * windowed_grad_kernel replaces ``windowed_grad`` (:170), which sweeps a
//   large vocabulary in row windows over ids that were sorted outside the
//   kernel. It takes the sorted ids and the sort's permutation.
//
// Both are bound by bytes on this card: each id and cotangent row is read
// once and the (n_rows, D) table written once, one add per cotangent
// element. At the CTR shapes the small-vocabulary call moves about 3 MB
// (about a microsecond of bandwidth, so its time is latency and launches)
// and the large-vocabulary call writes 111 MB of mostly zero rows.
//
// Neither kernel uses float atomics: every output element is a sum in an
// order fixed by the ids and the shapes alone, so two runs give the same
// bits. Exact fp32 terms are added where the TPU kernel adds a bf16 hi + lo
// pair.
//
// Cotangent layout. Row r of g lives at g + (r / fs) * g_stride + (r % fs) * D
// and id r at ids + (r / fs) * ids_stride + (r % fs): a (B, fs) column block
// cut out of a (B, F) id matrix and a (B, F, D) cotangent is read in place.
// A contiguous (R,) / (R, D) pair is fs = 1, ids_stride = 1, g_stride = D.
//
// The one-hot path. The output rows are cut into tiles of kTile rows and the
// ids into chunks of K (kChunk, more for a long id list), in the order of r.
// Ids outside [id_base, id_base + n_rows) belong to no tile and are dropped.
// Four launches on the caller's stream (two when R == 0):
//   1. onehot_count_kernel: a block per chunk counts the chunk's ids per tile
//      (shared-memory integer atomics: an order-free count).
//   2. onehot_scan_kernel (one block): each tile's first position, each
//      (chunk, tile)'s first position, and the piece table, in tile order: a
//      group of kGroup tiles whose entries fit one staging is one piece (most
//      tiles of a sparse vocabulary), any other tile is cut into pieces of at
//      most P entries (kPiece, kNarrowPiece for D < 32); a tile with no
//      entries still has a piece, which writes its zeros.
//   3. onehot_scatter_kernel: a block per chunk writes each id's (r, row in
//      the tile) into its tile's range, in the order of r (each warp owns a
//      contiguous eighth of the chunk; ranks within 32 ids from one ballot
//      per bit of the tile), so the list is the stable sort of the ids by
//      tile.
//   4. onehot_piece_kernel: a block per piece stages the piece's cotangent
//      rows into shared memory, kStageRows at a time (16 bytes a load where
//      D % 4 == 0), then every thread owns one column d and one residue j of
//      the entries: it sums the entries j, j + J, ... (J = 256 / D) of each
//      row into its own shared-memory slot, and the J slots of a (row, d) are
//      added in order of j. So a hot row is summed by all 256 threads at
//      once, no chain longer than P / J adds. A group's tiles are summed one
//      after the other from one staging. A tile of one piece writes its
//      rows to out; a tile of several writes a (kTile, D) partial per piece,
//      and the last of its pieces to finish (an integer atomic count per
//      tile) adds the partials in piece order.
// Every grid is sized from the shapes (the piece grid at the bound
// n_tiles + ceil(R / P)); blocks past the piece table's end return, so
// nothing waits for the host. Ids are read twice and the (r, row) list
// written and read once (8 bytes an entry).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// the sorted kernel
constexpr int kWindowFloats = 6 * 1024;             // 24 KB window of the sorted kernel
constexpr int kStageFloats = 4 * 1024;              // 16 KB of staged rows in the sorted kernel
// Measured on an H100 at the CTR shape (R = 18,432 into 2,530,000 rows,
// D = 11) against 128 and 512:
constexpr int kWindow = 256;                        // most rows in a window of the sorted kernel

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

// ---------------------------------------------------------------- unsorted ids

// The tiles (and rows within them) of the ids r0 + 32 u + lane, u < kBatch:
// -1 past hi or outside [id_base, id_base + n_rows). All loads are issued
// before any result is used.
__device__ __forceinline__ void load_batch(const int64_t* __restrict__ ids, int64_t ids_stride,
                                           int fs, int r0, int hi, int64_t id_base, int n_rows,
                                           int (&tile)[kBatch], int (&row)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int r = r0 + 32 * u + lane;
    tile[u] = -1;
    row[u] = 0;
    if (r < hi) {
      const int b = r / fs;
      const int64_t local = ids[(int64_t)b * ids_stride + (r - b * fs)] - id_base;
      if (local >= 0 && local < n_rows) {
        tile[u] = (int)local / kTile;
        row[u] = (int)local % kTile;
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
// that fall in tile t (shared-memory integer atomics: an order-free count)
__global__ void __launch_bounds__(kThreads)
onehot_count_kernel(const int64_t* __restrict__ ids, int64_t ids_stride, int fs, int R, int K,
                    int64_t id_base, int n_rows, int n_tiles, int* __restrict__ counts) {
  extern __shared__ int cnt[];
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int t = tid; t < n_tiles; t += kThreads) cnt[t] = 0;
  __syncthreads();
  const int S = K / kWarps;  // a warp's share of the chunk, a multiple of 32
  const int lo = blockIdx.x * K + warp * S, hi = min(R, lo + S);
  for (int r0 = lo; r0 < hi; r0 += 32 * kBatch) {
    int tile[kBatch], row[kBatch];
    load_batch(ids, ids_stride, fs, r0, hi, id_base, n_rows, tile, row);
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

// list[offsets of its chunk and tile + its rank among them] = (r, row in
// the tile), in the order of r within a chunk: the stable sort by tile
__global__ void __launch_bounds__(kThreads)
onehot_scatter_kernel(const int64_t* __restrict__ ids, int64_t ids_stride, int fs, int R, int K,
                      int64_t id_base, int n_rows, int n_tiles, const int* __restrict__ offsets,
                      int2* __restrict__ list) {
  extern __shared__ int run[];  // [kWarps][n_tiles]
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
    load_batch(ids, ids_stride, fs, r0, hi, id_base, n_rows, tile, row);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (tile[u] >= 0) atomicAdd(&mine[tile[u]], 1);
  }
  __syncthreads();
  // each warp's first position per tile: the chunk's, then the earlier warps'
  for (int t0 = tid; t0 < n_tiles; t0 += kThreads * kBatch) {
    int first[kBatch];  // the loads in flight together
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kThreads;
      first[u] = t < n_tiles ? offsets[(size_t)blockIdx.x * n_tiles + t] : 0;
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
    load_batch(ids, ids_stride, fs, r0, hi, id_base, n_rows, tile, row);
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
    stage_rows<G, 1>(g, fs, g_stride, D, nc, ent_ord, stage);
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

// ------------------------------------------------------------------- launch

int onehot_tiles(int n_rows) { return (n_rows + kTile - 1) / kTile; }
// most entries of a piece: narrow rows stage fast, so their hot tiles are
// cut finer and spread over more blocks
int onehot_piece(int D) { return D >= 32 ? kPiece : kNarrowPiece; }
// ids of a chunk: kChunk, or a multiple of it that keeps the count table
// (chunks x tiles) within the scan's kScanInts
int onehot_chunk(int R, int n_rows) {
  const int most = kScanInts / onehot_tiles(n_rows);
  const int per = (R + most - 1) / most;
  return kChunk * max(1, (per + kChunk - 1) / kChunk);
}
int onehot_chunks(int R, int n_rows) {
  const int K = onehot_chunk(R, n_rows);
  return (R + K - 1) / K;
}
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

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename G, int V>
int launch_pieces(const OnehotScratch& k, int mp, const G* g, int fs, int64_t g_stride, int D,
                  int n_rows, float* out, cudaStream_t s) {
  const int C = onehot_stage_rows(D), P = onehot_piece(D);
  const size_t smem = sizeof(float) * ((size_t)kTile * kThreads + (size_t)C * D) +
                      sizeof(int) * 2 * P;
  const int err = allow_smem(onehot_piece_kernel<G, V>, smem);
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
  int err = allow_smem(onehot_scatter_kernel, kWarps * tile_ints);
  if (!err) err = allow_smem(onehot_scan_kernel, scan_smem);
  if (err) return err;
  if (nc > 0)
    onehot_count_kernel<<<nc, kThreads, tile_ints, s>>>(ids, ids_stride, fs, R, K, id_base,
                                                        n_rows, nt, k.counts);
  const int P = onehot_piece(D);
  onehot_scan_kernel<<<1, kScanThreads, scan_smem, s>>>(
      k.counts, nc, nt, P, min(P, onehot_stage_rows(D)), mp, k.offsets, k.tile_start, k.pieces,
      k.tile_first, k.done);
  if (nc > 0)
    onehot_scatter_kernel<<<nc, kThreads, kWarps * tile_ints, s>>>(
        ids, ids_stride, fs, R, K, id_base, n_rows, nt, k.offsets, k.list);
  // rows of 4-element loads when every row starts on a 4-element boundary
  const bool vec = D % 4 == 0 && g_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(G)) == 0;
  err = vec ? launch_pieces<G, 4>(k, mp, g, fs, g_stride, D, n_rows, out, s)
            : launch_pieces<G, 1>(k, mp, g, fs, g_stride, D, n_rows, out, s);
  if (err) return err;
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
