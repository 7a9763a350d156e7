// Packed-bit row and column products of the restricted LightGCN step, for
// NVIDIA Hopper (sm_90a).
//
// bits is a binary matrix packed (n_major, nbytes) uint8, natural column
// order: column c of a row is bit (c % 8) of its byte c / 8. rows (R,) int64
// picks R of its rows, repeats allowed; the kernels read the picked rows in
// place, so the gathered (R, nbytes) copy is never written.
//
// * bit_rows_kernel replaces the Pallas kernel ``bit_rows_matmul``
//   (recbole_tpu/ops/bit_kernels.py:56):
//       out[r, :] = sum over set bits c of bits[rows[r]] of v[c, :]    (R, D) fp32
//   v is (n_v, D) bf16; a set bit at c >= n_v adds nothing (the zero rows
//   the JAX package pads v with).
// * bit_cols_kernel replaces ``bit_cols_matmul`` (:95), its transpose:
//       out[c, :] = sum over r with bit c of bits[rows[r]] set of g[r, :]
//   for every c < nbytes * 8, (nbytes * 8, D) fp32, written in full.
//
// What bounds them. The TPU kernels unpack 8 shift planes and feed the matrix
// unit a dense 0/1 operand: 26-54 GFLOP a call at the Yelp shape, for about
// 28 set bits in a row of 100,000. Here the work follows the set bits: each
// kernel streams the picked rows' packed bytes once (25.7 MB for 2,048 rows,
// 52.4 MB for 4,096) and touches a row of v or g per set bit, so both are
// bound by bytes: 0.009-0.023 ms on an H100 at a Yelp step's shapes.
//
// bit_rows_kernel: a block of 8 warps owns an output row, so that the rows
// of popular items (thousands of set bits) are walked by 8 warps at once.
// Warp w streams the row's 512-byte chunks w, w + 8, ... in 16-byte loads,
// four chunks in flight. A chunk's set bits are numbered across the warp (a
// prefix sum of the lanes' popcounts); in rounds of up to 32, lane L finds
// the column of the round's L-th set bit (the owning lane's 128 bits come by
// shuffles, a popcount search selects the bit) and appends it to a queue of
// 32 columns held one per lane. Whenever the queue is full, and once at the
// end, the whole warp loads those rows of v together (each lane a bf16 pair
// of every row; at the end as many as are queued, in batches of 16, 8, 4
// or 1) and adds them in ascending c into its fp32 sums: a sparse row costs
// each warp one round trip for its bits and one for its rows of v. The 8
// warps' partial sums are added in warp order. The order of every add is
// fixed by the shapes and the data, so two runs give the same bits.
//
// bit_cols_kernel: deterministic like the port's other gradient kernels (no
// float atomics). A strip is 32 bytes of every picked row (one sector; 256
// output rows). A thread-block cluster of C blocks owns a strip: block k of
// the cluster takes the k-th of C equal slices of the picked rows and sums
// them into its own (256, D) fp32 copy of the strip in shared memory, each of
// its 16 warps owning 16 output rows (half a 4-byte word of the strip). The
// block stages its rows kTileRows at a time by cp.async: the bits three tiles
// ahead of the adds (two threads a row, 16 bytes each; a thread reads a
// tile's ids two iterations before it stages it), and, once a tile's bits
// have landed, those of its g rows that hold a set bit in the strip, a tile
// ahead. So the adds never wait on device memory. A warp takes 32 staged rows
// at a time, finds by a ballot those whose half-word holds a set bit and, in
// ascending r, adds the row's g into its set columns. After a cluster barrier
// block k adds the C copies of its 256 / C rows of the strip in rank order
// (distributed shared memory) and writes them, zeros included, coalesced.
// Every output row is summed in the order of r within a slice and of the
// slices after, so two runs give the same bits. C comes from the host
// (ops/bit_kernels.py, bit_cols_plan) by R, nbytes and the card: the row
// split shortens the warps that own popular columns (at the Yelp shape the
// top items' word holds 1,452 of a user batch's 60,655 set bits) and fills
// the card when there are few strips (ml-100k: 8). Its bytes are the picked
// rows' sectors, scattered 32-byte reads that stream below the card's peak
// rate, and the output.
//
// D is even: a lane reads v and g as bf16 pairs. The shapes the kernels take
// are reported by bit_kernels_limits; the wrapper raises on any other shape,
// nothing falls back.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// both kernels: D even, at most kMaxD (a lane holds kMaxPairs bf16 pairs)
constexpr int kMaxD = 128;
constexpr int kMaxPairs = kMaxD / 64;

// bit_rows_kernel
constexpr int kRowsThreads = 256;                 // a block of 8 warps per output row
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kChunkBytes = 32 * 16;              // one 16-byte load a lane
constexpr int kChunksInFlight = 4;

// bit_cols_kernel
constexpr int kWarpCols = 16;                     // output rows a warp owns
constexpr int kColsThreads = 32 * 256 / kWarpCols;
constexpr int kStripBytes = 32;                   // a sector of every picked row
constexpr int kStripWords = kStripBytes / 4;
constexpr int kStripCols = 8 * kStripBytes;       // 256 output rows a strip
constexpr int kTileRows = 128;                    // picked rows staged at a time
constexpr int kBitStages = 4;                     // tiles of bits staged: the one added, the
                                                  // next (its g in flight) and two more
constexpr int kGThreads = kColsThreads / kTileRows;  // threads that copy a row of g
constexpr int kMaxCluster = 16;                   // blocks a strip (above 8: non-portable)

// every row's bytes start 16-byte aligned, and a strip holds whole 16-byte loads
constexpr int kNbytesMultiple = kStripBytes;

static_assert(kColsThreads / 32 * kWarpCols == kStripCols, "the warps own the strip's columns");
static_assert(2 * kTileRows <= kColsThreads, "two threads stage a row's sector");
static_assert(kTileRows % 32 == 0 && kGThreads * kTileRows == kColsThreads &&
              (kGThreads == 2 || kGThreads == 4), "two or four threads copy a g row");

// the strip's sums, the ring of staged bits and two tiles of g rows
size_t cols_smem_bytes(int D) {
  return sizeof(float) * (size_t)kStripCols * D + (size_t)kBitStages * kTileRows * kStripBytes +
         sizeof(__nv_bfloat16) * 2 * (size_t)kTileRows * D;
}

__device__ __forceinline__ float2 pair(const __nv_bfloat162* p) {
  return __bfloat1622float2(*p);
}

// Position of the r-th (from 0) set bit of w, which has more than r set bits.
__device__ __forceinline__ int select32(unsigned w, int r) {
  int pos = 0;
  int c = __popc(w & 0xffffu);
  if (r >= c) { r -= c; w >>= 16; pos += 16; }
  c = __popc(w & 0xffu);
  if (r >= c) { r -= c; w >>= 8; pos += 8; }
  c = __popc(w & 0xfu);
  if (r >= c) { r -= c; w >>= 4; pos += 4; }
  c = __popc(w & 0x3u);
  if (r >= c) { r -= c; w >>= 2; pos += 2; }
  return pos + (r >= (int)(w & 1u) ? 1 : 0);
}

// Position of the r-th set bit of the 128 bits of g (bit t of word q is 32 q + t).
__device__ __forceinline__ int select128(uint4 g, int r) {
  int c = __popc(g.x);
  if (r < c) return select32(g.x, r);
  r -= c;
  c = __popc(g.y);
  if (r < c) return 32 + select32(g.y, r);
  r -= c;
  c = __popc(g.z);
  if (r < c) return 64 + select32(g.z, r);
  return 96 + select32(g.w, r - c);
}

// Add the rows of v at the first NB columns of the queue (lane j holds
// column j; -1 for none) into acc, in queue order, all NB loads in flight.
template <int NB, int P>
__device__ __forceinline__ void add_v_rows(float2 (&acc)[P], long long qcol, int first,
                                           const __nv_bfloat162* __restrict__ v, long long n_v,
                                           int np, int lane) {
  float2 x[NB][P];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const long long c = __shfl_sync(kFull, qcol, first + b);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int d2 = lane + 32 * p;
      x[b][p] = (c >= 0 && c < n_v && d2 < np) ? pair(v + c * np + d2) : make_float2(0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p].x += x[b][p].x;
      acc[p].y += x[b][p].y;
    }
  }
}

template <int P>  // bf16 pairs a lane: D <= 64 * P
__global__ void __launch_bounds__(kRowsThreads)
bit_rows_kernel(const uint8_t* __restrict__ bits, long long n_major, int nbytes,
                const int64_t* __restrict__ rows, const __nv_bfloat162* __restrict__ v,
                long long n_v, int D, float* __restrict__ out) {
  constexpr int kFull32 = 32 / P;  // rows of v in flight when the queue is full
  __shared__ float2 part[kRowsWarps][32 * P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = D / 2;
  const long long r = blockIdx.x;
  float* dst = out + r * D;
  const long long m = rows[r];
  if (m < 0 || m >= n_major) {
    // a row outside the matrix: a NaN row, loud, in place of a wild read
    for (int d = threadIdx.x; d < D; d += kRowsThreads) dst[d] = nanf("");
    return;  // the whole block leaves together
  }
  const uint8_t* row = bits + m * (long long)nbytes;
  float2 acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = make_float2(0.0f, 0.0f);
  long long qcol = -1;  // the queue: lane j holds its j-th column
  int q = 0;            // queued columns

  for (int c0 = warp; c0 * kChunkBytes < nbytes; c0 += kRowsWarps * kChunksInFlight) {
    uint4 w[kChunksInFlight];
#pragma unroll
    for (int k = 0; k < kChunksInFlight; ++k) {
      const int off = (c0 + k * kRowsWarps) * kChunkBytes + lane * 16;
      w[k] = off < nbytes ? __ldg(reinterpret_cast<const uint4*>(row + off))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kChunksInFlight; ++k) {
      // number the chunk's set bits across the warp: this lane's are pre .. pre + cnt - 1
      const int cnt = __popc(w[k].x) + __popc(w[k].y) + __popc(w[k].z) + __popc(w[k].w);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      const int pre = incl - cnt;
      const long long col0 = 8LL * (c0 + k * kRowsWarps) * kChunkBytes;
      for (int base = 0; base < total; base += 32) {
        // lane L finds the column of set bit base + L
        long long col = -1;
        unsigned owners = __ballot_sync(kFull, cnt > 0 && pre < base + 32 && pre + cnt > base);
        while (owners) {
          const int o = __ffs(owners) - 1;
          owners &= owners - 1;
          const int rel = base + lane - __shfl_sync(kFull, pre, o);
          const int ocnt = __shfl_sync(kFull, cnt, o);
          const uint4 ow = make_uint4(__shfl_sync(kFull, w[k].x, o), __shfl_sync(kFull, w[k].y, o),
                                      __shfl_sync(kFull, w[k].z, o), __shfl_sync(kFull, w[k].w, o));
          if (rel >= 0 && rel < ocnt) col = col0 + 128 * o + select128(ow, rel);
        }
        // append the round's n columns (lanes 0..n-1 of col) to the queue
        const int n = min(32, total - base);
        const long long up = __shfl_up_sync(kFull, col, q);
        if (lane >= q) qcol = lane - q < n ? up : -1;
        if (q + n >= 32) {
#pragma unroll
          for (int first = 0; first < 32; first += kFull32)
            add_v_rows<kFull32, P>(acc, qcol, first, v, n_v, np, lane);
          const int rest = q + n - 32;
          const long long down = __shfl_down_sync(kFull, col, 32 - q);
          qcol = lane < rest ? down : -1;
          q = rest;
        } else {
          q += n;
        }
      }
    }
  }
  // the columns still queued, in batches that fit their number
  int first = 0;
  while (first < q) {
    const int left = q - first;
    if (left >= 16 && P == 1) {
      add_v_rows<16, P>(acc, qcol, first, v, n_v, np, lane);
      first += 16;
    } else if (left >= 8) {
      add_v_rows<8, P>(acc, qcol, first, v, n_v, np, lane);
      first += 8;
    } else if (left >= 4) {
      add_v_rows<4, P>(acc, qcol, first, v, n_v, np, lane);
      first += 4;
    } else {
      add_v_rows<1, P>(acc, qcol, first, v, n_v, np, lane);
      first += 1;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) part[warp][lane + 32 * p] = acc[p];
  __syncthreads();
  float2* dst2 = reinterpret_cast<float2*>(dst);
  for (int d2 = threadIdx.x; d2 < np; d2 += kRowsThreads) {
    float2 sum = part[0][d2];
#pragma unroll
    for (int wi = 1; wi < kRowsWarps; ++wi) {
      sum.x += part[wi][d2].x;
      sum.y += part[wi][d2].y;
    }
    dst2[d2] = sum;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes: the first `bytes` (16 or 0) from src, the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Word w of staged row r in a tile of bits: the row's two 16-byte halves
// swap places every 4 rows, so a warp reading one word of 32 rows meets 4-way
// bank conflicts, not 8-way.
__device__ __forceinline__ int tile_word(int r, int w) {
  return r * kStripWords + ((((w >> 2) ^ (r >> 2)) & 1) << 2) + (w & 3);
}

// P: bf16 pairs a lane (D <= 64 P). VEC: g's rows are copied in 16-byte
// pieces (D a multiple of 8, g 16-byte aligned), else in 4-byte ones.
template <int P, bool VEC>
__global__ void __launch_bounds__(kColsThreads, 2)
bit_cols_kernel(const uint8_t* __restrict__ bits, long long n_major, int nbytes,
                const int64_t* __restrict__ rows, int R, const __nv_bfloat16* __restrict__ g,
                int D, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // (kStripCols, D)
  float2* acc2 = reinterpret_cast<float2*>(smem);
  // [kBitStages][kTileRows * kStripWords] staged bits, then [2][kTileRows][D] g rows
  uint32_t* ring = reinterpret_cast<uint32_t*>(acc + (size_t)kStripCols * D);
  __nv_bfloat16* gring =
      reinterpret_cast<__nv_bfloat16*>(ring + kBitStages * kTileRows * kStripWords);
  __shared__ int any_bad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = D / 2;
  const int strip = blockIdx.x / C;
  const int byte0 = strip * kStripBytes;
  // this block's slice of the picked rows
  const int lo = (int)((long long)R * rank / C);
  const int hi = (int)((long long)R * (rank + 1) / C);
  const int tiles = (hi - lo + kTileRows - 1) / kTileRows;

  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = threadIdx.x; i < kStripCols * D / 4; i += kColsThreads)
    acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) any_bad = 0;
  bool bad = false;

  // Threads 2 r and 2 r + 1 stage the two halves of row r of each tile. A
  // thread reads tile t's id two iterations before it stages t's bits, into
  // id_even or id_odd by t's parity, so no iteration waits on a read of the
  // one before.
  const int sr = threadIdx.x >> 1, sh = threadIdx.x & 1;
  auto id_of = [&](int t) -> long long {
    const int r = lo + t * kTileRows + sr;
    return sr < kTileRows && t < tiles && r < hi ? rows[r] : -1;
  };
  long long id_even = id_of(0), id_odd = id_of(1);
  // the bits of tile t (id m), zeros past the slice and for an id outside the
  // matrix (flagged)
  auto stage = [&](int t, long long m) {
    if (sr >= kTileRows || t >= tiles) return;
    const bool in = lo + t * kTileRows + sr < hi;
    const bool ok = in && m >= 0 && m < n_major;
    bad |= in && !ok;
    cp_async16(ring + (t % kBitStages) * kTileRows * kStripWords + tile_word(sr, 4 * sh),
               ok ? bits + m * nbytes + byte0 + 16 * sh : bits, ok ? 16 : 0);
  };
  // g rows: kGThreads threads copy the 16-byte (or 4-byte) pieces of row gr of a tile
  const int gr = threadIdx.x / kGThreads, gq = threadIdx.x % kGThreads;

  // iteration i stages the bits of tile i + 3 and, once tile i + 1's have
  // landed, those of its g rows that hold a set bit in the strip; then it adds
  // tile i
  for (int i = -3; i < tiles; ++i) {
    if (i >= -1) {
      cp_async_wait<1>();  // g of tile i and bits of tile i + 1 have landed
      __syncthreads();     // for every thread; and tile i - 1 has been read
    }
    if (i + 1 >= 0 && i + 1 < tiles) {
      const uint32_t* tn = ring + ((i + 1) % kBitStages) * kTileRows * kStripWords;
      int any = 0;
#pragma unroll
      for (int k = 0; k < kStripWords / kGThreads; ++k)
        any |= tn[gr * kStripWords + gq + kGThreads * k] != 0u;
#pragma unroll
      for (int o = 1; o < kGThreads; o <<= 1) any |= __shfl_xor_sync(kFull, any, o);
      if (any) {  // row gr holds a set bit in the strip
        const __nv_bfloat16* src = g + ((long long)lo + (long long)(i + 1) * kTileRows + gr) * D;
        __nv_bfloat16* dst = gring + ((size_t)((i + 1) & 1) * kTileRows + gr) * D;
        if (VEC) {
          for (int c = 8 * gq; c < D; c += 8 * kGThreads) cp_async16(dst + c, src + c, 16);
        } else {
          for (int c = 2 * gq; c < D; c += 2 * kGThreads) cp_async4(dst + c, src + c);
        }
      }
    }
    cp_async_commit();
    if ((i + 3) & 1) {
      stage(i + 3, id_odd);
      id_odd = id_of(i + 5);
    } else {
      stage(i + 3, id_even);
      id_even = id_of(i + 5);
    }
    cp_async_commit();
    if (i >= 0) {
      // this warp's kWarpCols columns of the strip, in word `word` of each staged row
      const uint32_t* tb = ring + (i % kBitStages) * kTileRows * kStripWords;
      const __nv_bfloat162* gt =
          reinterpret_cast<const __nv_bfloat162*>(gring + (size_t)(i & 1) * kTileRows * D);
      float2* wacc = acc2 + (size_t)warp * kWarpCols * np;
      const int rows_here = min(kTileRows, hi - lo - i * kTileRows);
      const int word = warp * kWarpCols / 32, shift = warp * kWarpCols % 32;
      const uint32_t mask = kWarpCols == 32 ? kFull : (1u << kWarpCols) - 1u;
      for (int s = 0; s < rows_here; s += 32) {
        // zeros past the slice
        const uint32_t cols = (tb[tile_word(s + lane, word)] >> shift) & mask;
        unsigned m = __ballot_sync(kFull, cols != 0u);
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          unsigned set = __shfl_sync(kFull, cols, j);
          float2 gv[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int d2 = lane + 32 * p;
            gv[p] = d2 < np ? pair(gt + (s + j) * np + d2) : make_float2(0.0f, 0.0f);
          }
          do {
            const int t = __ffs(set) - 1;
            set &= set - 1;
            float2* a = wacc + t * np;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const int d2 = lane + 32 * p;
              if (d2 < np) {
                float2 x = a[d2];
                x.x += gv[p].x;
                x.y += gv[p].y;
                a[d2] = x;
              }
            }
          } while (set);
        }
      }
    }
  }
  if (bad) any_bad = 1;
  cluster.sync();  // every block of the cluster holds its slice's sums
  int bad_any = 0;
  for (int q = 0; q < C; ++q) bad_any |= *cluster.map_shared_rank(&any_bad, q);
  // this block's rows of the strip: the cluster's C sums in rank order
  const int c0 = kStripCols * rank / C, c1 = kStripCols * (rank + 1) / C;
  float* dst = out + (long long)strip * kStripCols * D;
  const float fill = nanf("");
  if (D % 4 == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int e = c0 * D / 4 + threadIdx.x; e < c1 * D / 4; e += kColsThreads) {
      float4 sum = cluster.map_shared_rank(acc4, 0)[e];
      for (int q = 1; q < C; ++q) {
        const float4 t = cluster.map_shared_rank(acc4, q)[e];
        sum.x += t.x;
        sum.y += t.y;
        sum.z += t.z;
        sum.w += t.w;
      }
      dst4[e] = bad_any ? make_float4(fill, fill, fill, fill) : sum;
    }
  } else {
    float2* dst2 = reinterpret_cast<float2*>(dst);
    for (int e = c0 * np + threadIdx.x; e < c1 * np; e += kColsThreads) {
      float2 sum = cluster.map_shared_rank(acc2, 0)[e];
      for (int q = 1; q < C; ++q) {
        const float2 t = cluster.map_shared_rank(acc2, q)[e];
        sum.x += t.x;
        sum.y += t.y;
      }
      dst2[e] = bad_any ? make_float2(fill, fill) : sum;
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}

}  // namespace

// What the kernels take: the largest D (D must be even), the multiple nbytes
// must be (rows and strips start 16-byte aligned), and the column kernel's
// shared memory at a given D.
extern "C" void bit_kernels_limits(int* max_d, int* d_multiple, int* nbytes_multiple) {
  *max_d = kMaxD;
  *d_multiple = 2;
  *nbytes_multiple = kNbytesMultiple;
}

extern "C" long long bit_cols_smem_bytes(int D) { return (long long)cols_smem_bytes(D); }

namespace {

bool shape_ok(int D, int nbytes) {
  return D >= 2 && D <= kMaxD && D % 2 == 0 && nbytes >= kNbytesMultiple &&
         nbytes % kNbytesMultiple == 0;
}

}  // namespace

extern "C" int bit_rows_launch(const void* bits, long long n_major, int nbytes, const void* rows,
                               int R, const void* v, long long n_v, int D, float* out,
                               void* stream) {
  if (R < 1 || !shape_ok(D, nbytes)) return (int)cudaErrorInvalidValue;
  auto kernel = D <= 64 ? bit_rows_kernel<1> : bit_rows_kernel<kMaxPairs>;
  kernel<<<R, kRowsThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, n_major, nbytes, (const int64_t*)rows,
      (const __nv_bfloat162*)v, n_v, D, out);
  return (int)cudaGetLastError();
}

namespace {

using ColsKernel = void (*)(const uint8_t*, long long, int, const int64_t*, int,
                            const __nv_bfloat16*, int, float*);

ColsKernel cols_kernel(int D, bool vec) {
  if (D <= 64) return vec ? bit_cols_kernel<1, true> : bit_cols_kernel<1, false>;
  return vec ? bit_cols_kernel<kMaxPairs, true> : bit_cols_kernel<kMaxPairs, false>;
}

cudaLaunchConfig_t cols_config(int strips, int cluster, size_t smem, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * cluster);
  cfg.blockDim = dim3(kColsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Let the column kernel take its shared memory and clusters of more than 8
int cols_allow(ColsKernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)err;
}

}  // namespace

// What the column kernel's grid can use on the current device at D: its SMs,
// the blocks an SM holds at once, and the largest cluster that fits (16, or 8
// where a cluster of 16 does not).
extern "C" int bit_cols_occupancy(int D, int* sms, int* blocks_per_sm, int* max_cluster) {
  if (!shape_ok(D, kNbytesMultiple)) return (int)cudaErrorInvalidValue;
  const ColsKernel kernel = cols_kernel(D, D % 8 == 0);
  const size_t smem = cols_smem_bytes(D);
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cols_allow(kernel, smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kColsThreads,
                                                             smem);
  int clusters = 0;
  if (!err) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cols_config(1, kMaxCluster, smem, 0, &attr);
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  *max_cluster = clusters > 0 ? kMaxCluster : 8;
  return err;
}

// cluster: the blocks of a strip (bit_cols_plan), 1 to kMaxCluster. grid
// receives the launch's blocks and cluster size, as launched.
extern "C" int bit_cols_launch(const void* bits, long long n_major, int nbytes, const void* rows,
                               int R, const void* g, int D, int cluster, float* out,
                               void* stream, int* grid) {
  if (R < 0 || !shape_ok(D, nbytes) || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const ColsKernel kernel = cols_kernel(D, D % 8 == 0 && (uintptr_t)g % 16 == 0);
  const size_t smem = cols_smem_bytes(D);
  int err = cols_allow(kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cols_config(nbytes / kStripBytes, cluster, smem, (cudaStream_t)stream, &attr);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)bits, n_major, nbytes,
                                (const int64_t*)rows, R, (const __nv_bfloat16*)g, D, out);
  grid[0] = (int)cfg.gridDim.x;
  grid[1] = (int)attr.val.clusterDim.x;
  return err ? err : (int)cudaGetLastError();
}
