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
// float atomics). A block owns a strip of kStripBytes bytes of every row
// (kStripBytes * 8 output rows) and its (strip, D) fp32 sum in shared memory;
// each warp owns one 4-byte word of the strip (32 output rows). The block
// stages the strip of kTileRows picked rows at a time in shared memory (the
// next tile's loads in flight meanwhile); a warp takes 32 staged rows at a
// time, finds by a ballot those whose word holds a set bit, loads their g
// rows together (in batches of 32, 16, 8, 4 or 1, by how many there are)
// and, in ascending r, adds each into its set columns. Every output row is
// summed by one warp in the order of r, so two runs give the same bits. The
// block then writes its (strip, D) rows, zeros included, with coalesced
// stores.
//
// D is even: a lane reads v and g as bf16 pairs. The shapes the kernels take
// are reported by bit_kernels_limits; the wrapper raises on any other shape,
// nothing falls back.

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
constexpr int kColsThreads = 256;                 // 8 warps
constexpr int kColsWarps = kColsThreads / 32;
constexpr int kStripBytes = 4 * kColsWarps;       // one 4-byte word a warp
constexpr int kStripCols = 8 * kStripBytes;       // 256 output rows a block
constexpr int kTileRows = 256;                    // picked rows staged at a time
constexpr int kTileStride = kStripBytes / 4 + 1;  // words a staged row, padded: no bank conflicts
constexpr int kLoadsPerThread = kTileRows * (kStripBytes / 16) / kColsThreads;

// every row's bytes start 16-byte aligned, and a strip holds whole 16-byte loads
constexpr int kNbytesMultiple = kStripBytes;

static_assert(kLoadsPerThread * kColsThreads == kTileRows * (kStripBytes / 16),
              "the tile's 16-byte loads split evenly over the block");
static_assert(kTileRows % 32 == 0, "a warp scans 32 staged rows at a time");

size_t cols_smem_bytes(int D) {
  return sizeof(float) * (size_t)kStripCols * D + sizeof(uint32_t) * kTileRows * kTileStride;
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

// Load this thread's share of the strip of picked rows [r0, r0 + kTileRows):
// 16 bytes of row (i / 2), half (i % 2), for each of its kLoadsPerThread loads.
__device__ __forceinline__ void load_tile(uint4 (&regs)[kLoadsPerThread], bool& bad,
                                          const uint8_t* __restrict__ bits, long long n_major,
                                          int nbytes, const int64_t* __restrict__ rows, int R,
                                          int r0, int byte0) {
#pragma unroll
  for (int i = 0; i < kLoadsPerThread; ++i) {
    const int idx = threadIdx.x + i * kColsThreads;
    const int tr = idx / (kStripBytes / 16);
    const int part = idx % (kStripBytes / 16);
    const int r = r0 + tr;
    regs[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const long long m = rows[r];
      if (m < 0 || m >= n_major) {
        bad = true;
      } else {
        regs[i] = __ldg(reinterpret_cast<const uint4*>(bits + m * (long long)nbytes + byte0 +
                                                       16 * part));
      }
    }
  }
}

// Take the next NB staged rows with a set bit in this warp's word (lanes, in
// ascending r), load their g rows together, then add each into its set
// columns of acc in ascending r.
template <int NB, int P>
__device__ __forceinline__ void add_g_rows(unsigned& lanes, uint32_t word, long long r_first,
                                           const __nv_bfloat162* __restrict__ g, int np,
                                           float2* acc2, int warp, int lane) {
  int src[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    src[b] = lanes ? __ffs(lanes) - 1 : -1;
    lanes &= lanes ? lanes - 1 : 0u;
  }
  float2 gv[NB][P];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int d2 = lane + 32 * p;
      gv[b][p] = (src[b] >= 0 && d2 < np) ? pair(g + (r_first + src[b]) * np + d2)
                                          : make_float2(0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (src[b] < 0) break;  // the same for the whole warp
    unsigned set = __shfl_sync(kFull, word, src[b]);
    while (set) {
      const int t = __ffs(set) - 1;
      set &= set - 1;
      float2* a = acc2 + (size_t)(warp * 32 + t) * np;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int d2 = lane + 32 * p;
        if (d2 < np) {
          a[d2].x += gv[b][p].x;
          a[d2].y += gv[b][p].y;
        }
      }
    }
  }
}

template <int P>  // bf16 pairs a lane: D <= 64 * P
__global__ void __launch_bounds__(kColsThreads)
bit_cols_kernel(const uint8_t* __restrict__ bits, long long n_major, int nbytes,
                const int64_t* __restrict__ rows, int R, const __nv_bfloat162* __restrict__ g,
                int D, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);                                   // (kStripCols, D)
  float2* acc2 = reinterpret_cast<float2*>(smem);
  // (kTileRows, kTileStride) staged words after the sums
  uint32_t* tile = reinterpret_cast<uint32_t*>(acc + (size_t)kStripCols * D);
  __shared__ int any_bad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = D / 2;
  const int byte0 = blockIdx.x * kStripBytes;

  for (int i = threadIdx.x; i < kStripCols * D; i += kColsThreads) acc[i] = 0.0f;
  if (threadIdx.x == 0) any_bad = 0;
  bool bad = false;
  uint4 regs[kLoadsPerThread];
  load_tile(regs, bad, bits, n_major, nbytes, rows, R, 0, byte0);

  for (int r0 = 0; r0 < R; r0 += kTileRows) {
    __syncthreads();  // the previous tile has been read (and acc zeroed, any_bad set)
#pragma unroll
    for (int i = 0; i < kLoadsPerThread; ++i) {
      const int idx = threadIdx.x + i * kColsThreads;
      uint32_t* dst =
          tile + (idx / (kStripBytes / 16)) * kTileStride + 4 * (idx % (kStripBytes / 16));
      dst[0] = regs[i].x;
      dst[1] = regs[i].y;
      dst[2] = regs[i].z;
      dst[3] = regs[i].w;
    }
    __syncthreads();
    if (r0 + kTileRows < R)
      load_tile(regs, bad, bits, n_major, nbytes, rows, R, r0 + kTileRows, byte0);
    const int rows_here = min(kTileRows, R - r0);
    for (int s = 0; s < rows_here; s += 32) {
      const uint32_t word = tile[(s + lane) * kTileStride + warp];  // rows past R were staged as 0
      unsigned lanes = __ballot_sync(kFull, word != 0u);
      while (lanes) {
        const int n = __popc(lanes);
        if (n >= 16 && P == 1) {
          add_g_rows<32 / P, P>(lanes, word, r0 + s, g, np, acc2, warp, lane);
        } else if (n >= 8) {
          add_g_rows<8, P>(lanes, word, r0 + s, g, np, acc2, warp, lane);
        } else if (n >= 4) {
          add_g_rows<4, P>(lanes, word, r0 + s, g, np, acc2, warp, lane);
        } else {
          add_g_rows<1, P>(lanes, word, r0 + s, g, np, acc2, warp, lane);
        }
      }
    }
  }
  if (bad) any_bad = 1;
  __syncthreads();
  float* dst = out + (long long)blockIdx.x * kStripCols * D;
  const float fill = nanf("");
  for (int i = threadIdx.x; i < kStripCols * D; i += kColsThreads)
    dst[i] = any_bad ? fill : acc[i];
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

extern "C" int bit_cols_launch(const void* bits, long long n_major, int nbytes, const void* rows,
                               int R, const void* g, int D, float* out, void* stream) {
  if (R < 0 || !shape_ok(D, nbytes)) return (int)cudaErrorInvalidValue;
  auto kernel = D <= 64 ? bit_cols_kernel<1> : bit_cols_kernel<kMaxPairs>;
  const size_t smem = cols_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nbytes / kStripBytes, kColsThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, n_major, nbytes, (const int64_t*)rows, R,
      (const __nv_bfloat162*)g, D, out);
  return (int)cudaGetLastError();
}
