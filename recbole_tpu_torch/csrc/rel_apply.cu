// Per-row relation-matrix apply, forward and backward, for NVIDIA Hopper
// (sm_90a).
//
// Replaces: recbole_tpu/ops/rel_apply.py::rel_apply (:113; Pallas kernels
// _fwd_kernel :80 and _bwd_kernel :89, pallas_call :128 and :145). On
// v (N, D) f32, rel (N,) int32 and R (NR, D, D) f32:
//   y[n, i]   = sum_j R[rel[n], i, j] v[n, j]                       (N, D)
//   dv[n, j]  = sum_i R[rel[n], i, j] dy[n, i]                      (N, D)
//   dR[r, i, j] = sum over n with rel[n] = r of dy[n, i] v[n, j]    (NR, D, D)
// A row whose relation lies outside [0, NR) gets y = dv = 0 and adds nothing
// to dR, as the JAX kernel's pad rows (rel = NR) do.
//
// Two instances (template flag BF). fp32: the function of RippleNet's XLA
// relation loop (recbole_tpu/models/knowledge/ripplenet.py:173-178), every
// product as 3xTF32 on the tensor cores. bf16: the TPU kernel's rounding
// points: v, dy and R rounded to bf16, products on the tensor cores in bf16
// summed in fp32, y and dv rounded to bf16 once (then stored as f32, as the
// JAX kernel returns them), dR summed in fp32 without a final rounding.
//
// What bounds it on the H100 (RippleNet's step: N = 4,096 rows x 2 hops x 16
// memories = 131,072, D = 64, NR = 53): bytes. The forward moves v, rel, R
// and y (about 68.5 MB, 0.020 ms at 3.35 TB/s) for 1.07 GFLOP; the backward
// v, rel, R, dy, dv and dR (about 102.5 MB, 0.031 ms) for 2.15 GFLOP, which
// at the fp32 FMA rate would take 0.032 ms: only on the tensor cores (3xTF32
// runs at a third of dense TF32, 165 TFLOP/s) is the backward bound by its
// bytes. As measured (scripts/torch_rel_probe.py, PERF.md): the rows are
// gathered and scattered 256 bytes at a time at random places, which the
// card serves well below its streaming rate, and mma.sync's 3xTF32 products
// do not hide under them (the fp32 forward's take a third of its time, the
// backward's two thirds).
//
// Design. The TPU kernel multiplies every row by all NR matrices at once and
// keeps the right span with a mask. Here the rows are bucketed by relation
// on the device, and a block works on tiles of kTR rows of one relation with
// that relation's matrix in shared memory:
//   1. rel_count_kernel: each warp counts a chunk of kChunk rows by bucket
//      (NR relations and one bucket, NR, for rows outside [0, NR)) with
//      shared-memory integer atomics (an order-free count), bucket-major.
//      The last block to finish (an integer ticket, reset by that block)
//      runs one exclusive scan over the (bucket, chunk) counts in that order
//      (each chunk's first sorted position per bucket; a warp a segment, 32
//      counts a round), and writes each tile kernel's blocks: a bucket's
//      tiles split evenly over min(tiles, max(1, tiles G / T)) blocks (G the
//      blocks the kernel holds on the card at once, T the tiles), a block's
//      entry its bucket and its range of sorted positions, so that no block
//      changes relation and a tile's place follows from its index. No
//      thread walks the buckets.
//   2. rel_scatter_kernel: a warp per chunk writes its rows' indices into
//      their buckets in row order (ranks within a 32-row group from
//      __match_any_sync): the permutation is the stable sort by relation,
//      the same every run.
//   The forward keeps these tables (the perm, the blocks) and the backward
//   under autograd reuses them.
//   3. rel_fwd_kernel: a block stages R[r] in shared memory once (16-byte
//      loads) and packs it as the products' B fragments (fp32: hi and lo
//      parts, split once; bf16: pairs), while its first rows land. A warp
//      owns 16 rows of every tile: it gathers them by 16-byte cp.async
//      (consecutive lanes on consecutive bytes of a row) into its own ring
//      of kFwdStages stages, the perm entries read a tile ahead of the
//      copies, multiplies them by R[r]^T on the tensor cores (mma.sync
//      m16n8k8 3xTF32, each pass over all n-tiles before the next, or
//      m16n8k16 bf16), and writes the output rows through its stage as
//      whole 16-byte chunks to their perm rows. The warps never wait for
//      each other after the start.
//   4. rel_bwd_kernel: one pass over the same tiles. A block gathers a
//      tile's dy and v rows once (two stages); each warp forms its share of
//      dv = dy R[r] (packed R, through a shared buffer to 16-byte stores)
//      and of the tile's dy^T v, each tile's product started from zero and
//      added to fp32 sums (the tensor cores' accumulation is not carried
//      down long chains); the block writes one dR partial;
//      rel_dr_reduce_kernel sums each relation's partials in block order (a
//      relation with no rows gets 0). No float atomics and a static
//      assignment of tiles to blocks: two runs give the same bits.
// Shared-memory rows are D rounded up to 32 floats long, each 16-byte chunk
// c of row n stored at chunk c ^ swz(n) (swz a permutation of 0..7 over n
// mod 8), so that the fragments read conflict-free both along a row (A of
// y and dv) and down a column (dy^T and v of dR). Chunks past D are zero,
// so D = 4 mod 8 (or 4, 8 mod 16 in bf16) pads k with zeros; the packed
// fragments hold zeros past D.
//
// Limits: D a multiple of 4 and at most kMaxD = 128, NR + 1 buckets at most
// kMaxBuckets (the count and scatter kernels' shared-memory counters); any N.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 512;          // rows a warp counts and scatters
constexpr int kCountThreads = 1024;  // the count kernel's block (its last block scans)
constexpr int kTR = 64;              // rows of a tile
constexpr int kMaxD = 128;
constexpr int kMaxBuckets = 16384;   // NR + 1 (shared-memory counters)
constexpr int kFwdWarps = 4;         // 16 rows of a tile each
constexpr int kFwdStages = 2;  // a warp's ring of tiles
constexpr int kBwdThreads = 256;
constexpr int kMaxDevices = 64;

// the bucket of a row: its relation, or NR for a relation outside [0, NR)
__device__ __forceinline__ int bucket_of(int r, int NR) {
  return (r >= 0 && r < NR) ? r : NR;
}

// ============================================================== bucketing

// Exclusive prefix of x over the block (blockDim.x a multiple of 32, at most
// 1024); total gets the sum. tmp: 33 ints of shared memory.
__device__ int block_scan(int x, int* tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? tmp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    tmp[lane] = wi - w;
    if (lane == 31) tmp[32] = wi;
  }
  __syncthreads();
  total = tmp[32];
  const int out = tmp[warp] + inc - x;
  __syncthreads();
  return out;
}

// bucket b's first sorted position and rows, from the scanned counts
// (offsets[b * n_chunks + c], bucket-major)
__device__ __forceinline__ void bucket_span(const int* offsets, int b, int NB, int n_chunks,
                                            int N, int& start, int& total) {
  start = __ldcg(offsets + (size_t)b * n_chunks);
  const int next = b + 1 < NB ? __ldcg(offsets + (size_t)(b + 1) * n_chunks) : N;
  total = next - start;
}

// counts[b * n_chunks + c] = rows of chunk c in bucket b (warp w of block k
// counts chunk k wc + w); the last block then turns counts into offsets (each
// chunk's first sorted position per bucket) and writes the two tile kernels'
// blocks (fblocks for the forward's Gf resident blocks, bblocks and
// rel_blocks[b] = (first block, blocks) for the backward's Gb); and resets
// the ticket.
__global__ void __launch_bounds__(kCountThreads)
rel_count_kernel(const int* __restrict__ rel, int N, int NR, int wc, int n_chunks, int Gf,
                 int Gb, int* __restrict__ counts, int* __restrict__ rel_blocks,
                 int* __restrict__ fblocks, int* __restrict__ bblocks,
                 int* __restrict__ ticket) {
  extern __shared__ int cnt_sh[];
  __shared__ int tmp[33];
  __shared__ int last;
  const int NB = NR + 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < wc) {
    int* cnt = cnt_sh + warp * NB;
    const int c = blockIdx.x * wc + warp;
    for (int b = lane; b < NB; b += 32) cnt[b] = 0;
    __syncwarp();
    if (c < n_chunks) {
      const int n0 = c * kChunk, end = min(N, n0 + kChunk);
      int bk[kChunk / 32];
#pragma unroll
      for (int u = 0; u < kChunk / 32; ++u) {
        const int n = n0 + lane + 32 * u;
        bk[u] = n < end ? bucket_of(rel[n], NR) : -1;
      }
#pragma unroll
      for (int u = 0; u < kChunk / 32; ++u)
        if (bk[u] >= 0) atomicAdd(&cnt[bk[u]], 1);
      __syncwarp();
      for (int b = lane; b < NB; b += 32) counts[(size_t)b * n_chunks + c] = cnt[b];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nth = blockDim.x, tid = threadIdx.x;
  // 1. offsets: one exclusive scan over the counts in (bucket, chunk) order.
  // Warp w takes the w-th of equal segments, 32 consecutive counts a round
  // (coalesced), kHold rounds of loads in flight at a time and, when the
  // segment is no longer, held in registers for the second pass.
  constexpr int kHold = 16;
  const long long L = (long long)NB * n_chunks;
  const int nw = nth >> 5;
  const long long seg = (L + nw - 1) / nw;
  const long long s0 = min(L, warp * seg), s1 = min(L, s0 + seg);
  int c[kHold];
  int wsum = 0;
  for (long long i0 = s0; i0 < s1; i0 += 32 * kHold) {
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const long long i = i0 + 32 * u + lane;
      c[u] = i < s1 ? __ldcg(counts + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kHold; ++u) wsum += c[u];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
  int total;
  int carry = __shfl_sync(0xffffffffu, block_scan(lane == 0 ? wsum : 0, tmp, total), 0);
  const bool held = seg <= 32 * kHold;
  for (long long i0 = s0; i0 < s1; i0 += 32 * kHold) {
    if (!held) {
#pragma unroll
      for (int u = 0; u < kHold; ++u) {
        const long long i = i0 + 32 * u + lane;
        c[u] = i < s1 ? __ldcg(counts + i) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      int inc = c[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const long long i = i0 + 32 * u + lane;
      if (i < s1) counts[i] = carry + inc - c[u];
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  // 2. the tiles (T in all), and the tile kernels' blocks: a bucket's tiles
  // split evenly over min(tiles, max(1, tiles G / T)) blocks (G the
  // kernel's resident blocks), in bucket order, so that a block's rows
  // share one relation; entries (bucket, first sorted position, end), (NR,
  // 0, 0) past the last of G + NB; the backward's blocks of each relation.
  // each bucket's first sorted position and rows, once, in shared memory
  int* bstart = cnt_sh + wc * NB;
  int* brows = bstart + NB;
  for (int b = tid; b < NB; b += nth) bucket_span(counts, b, NB, n_chunks, N, bstart[b], brows[b]);
  __syncthreads();
  const int per2 = (NB + nth - 1) / nth;
  const int beg2 = min(NB, tid * per2), end2 = min(NB, beg2 + per2);
  int s2 = 0;
  for (int b = beg2; b < end2; ++b) s2 += (brows[b] + kTR - 1) / kTR;
  int T;
  block_scan(s2, tmp, T);
  auto blocks_of = [&](int nt, int G) {
    return min(nt, max(1, (int)((long long)nt * G / T)));
  };
  // both tables' first blocks in one scan, the forward's in the low 16 bits
  int s3 = 0;
  for (int b = beg2; b < end2; ++b) {
    const int nt = (brows[b] + kTR - 1) / kTR;
    s3 += blocks_of(nt, Gf) + (blocks_of(nt, Gb) << 16);
  }
  int K;
  const int x0 = block_scan(s3, tmp, K);
  for (int pass = 0; pass < 2; ++pass) {
    const int G = pass ? Gb : Gf, sh = pass ? 16 : 0, Kp = (K >> sh) & 0xffff;
    int* table = pass ? bblocks : fblocks;
    int x = (x0 >> sh) & 0xffff;
    for (int b = beg2; b < end2; ++b) {
      const int start = bstart[b], rows = brows[b];
      const int nt = (rows + kTR - 1) / kTR, k = blocks_of(nt, G);
      if (pass) {
        rel_blocks[2 * b] = x;
        rel_blocks[2 * b + 1] = k;
      }
      // block i takes the tiles [i nt / k, (i + 1) nt / k), no division
      int t1 = 0, rem = 0;
      for (int i = 0; i < k; ++i, ++x) {
        const int t0 = t1;
        rem += nt;
        while (rem >= k) {
          rem -= k;
          ++t1;
        }
        table[3 * x] = b;
        table[3 * x + 1] = start + t0 * kTR;
        table[3 * x + 2] = start + min(rows, t1 * kTR);
      }
    }
    for (int y = Kp + tid; y < G + NB; y += nth) {
      table[3 * y] = NR;
      table[3 * y + 1] = table[3 * y + 2] = 0;
    }
  }
  if (tid == 0) *ticket = 0;
}

// perm[offset of its chunk and bucket + its rank among them] = n, in row
// order within a chunk: the stable sort of the rows by bucket
__global__ void rel_scatter_kernel(const int* __restrict__ rel, int N, int NR, int n_chunks,
                                   const int* __restrict__ offsets, int* __restrict__ perm) {
  extern __shared__ int run[];
  const int NB = NR + 1, c = blockIdx.x, lane = threadIdx.x;
  const int n0 = c * kChunk, end = min(N, n0 + kChunk);
  int bk[kChunk / 32];
#pragma unroll
  for (int u = 0; u < kChunk / 32; ++u) {
    const int n = n0 + lane + 32 * u;
    bk[u] = n < end ? bucket_of(rel[n], NR) : -1;
  }
  for (int b = lane; b < NB; b += 32) run[b] = offsets[(size_t)b * n_chunks + c];
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kChunk / 32; ++u) {
    const int b = bk[u];
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (b >= 0) perm[run[b] + rank] = n0 + lane + 32 * u;
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) run[b] += __popc(peers);
    __syncwarp();
  }
}

// ========================================================= tensor-core products

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, or (bytes 0) 16 zero bytes
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// swz(n): a permutation of 0..7 over n mod 8, with swz(q) even and
// swz(q + 4) = swz(q) + 1 for q < 4: a fragment's 8 rows of one chunk, or its
// 4 rows (and the 4 after them) of two chunks, land in 8 distinct chunks of
// the 32 banks
__device__ __forceinline__ int swz(int n) { return 2 * (n & 3) + ((n >> 2) & 1); }

// the float offset of column col in row `row` of a swizzled buffer
__device__ __forceinline__ int swz_col(int row, int col) {
  return (((col >> 2) ^ swz(row)) << 2) + (col & 3);
}

// the float offset of (row, col) in a buffer of rows S floats long (S a
// multiple of 32)
__device__ __forceinline__ int at(int S, int row, int col) { return row * S + swz_col(row, col); }

// logical (r, c) of an operand: the buffer's (r, c) (RowView) or (c, r)
// (ColView)
struct RowView {
  const float* p;
  int S;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[at(S, r, c)]; }
};
struct ColView {
  const float* p;
  int S;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[at(S, c, r)]; }
};

// c += a b: one m16n8k8 tile, tf32 operands, fp32 sums
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: one m16n8k16 tile, bf16 operands, fp32 sums
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for 3xTF32: hi is x's top 19 bits (a tf32 value, x cut toward
// 0), lo the exact remainder, whose low bits the tensor cores drop; a product
// keeps about 2^-19 of |a b| (trm_layer.cu's split, copied: each source is
// built and hashed alone)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One instance's k-step. Fragments follow mma's register order (gr = lane /
// 4, q = lane % 4): tf32 a holds rows gr, gr + 8 by k q, q + 4, b k q, q + 4
// by column gr; bf16 a holds rows gr, gr + 8 by k pairs 2q, 2q + 8, b k pairs
// 2q, 2q + 8 by column gr. load_a reads A(m, k) and load_b B(k, n) from a
// view; a B fragment also comes packed (Packed, one entry a lane, made from
// B's kElems elements at the k offsets koff(i, q) by pack), which R is once a
// run of its tiles. mma runs the k-step for n-tiles 0..n-1 of one A.
template <bool BF>
struct Tc;

// 3xTF32: a k-step of 8 is a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo,
// about 2^-20 of the product, dropped), the small terms first, each pass over
// every n-tile before the next, so that a tile's three products are not
// back to back on one accumulator
template <>
struct Tc<false> {
  static constexpr int kK = 8, kElems = 2;
  typedef uint4 Packed;  // hi(k q), hi(k q + 4), lo(k q), lo(k q + 4)
  typedef uint2 Raw;     // x(k q), x(k q + 4), split at use (half the bytes)
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  template <class V>
  static __device__ __forceinline__ void load_a(const V& v, int m0, int k0, A& a) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    split_tf32(v(m0 + g, k0 + q), a.hi[0], a.lo[0]);
    split_tf32(v(m0 + g + 8, k0 + q), a.hi[1], a.lo[1]);
    split_tf32(v(m0 + g, k0 + q + 4), a.hi[2], a.lo[2]);
    split_tf32(v(m0 + g + 8, k0 + q + 4), a.hi[3], a.lo[3]);
  }
  template <class V>
  static __device__ __forceinline__ void load_b(const V& v, int k0, int n0, B& b) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    split_tf32(v(k0 + q, n0 + g), b.hi[0], b.lo[0]);
    split_tf32(v(k0 + q + 4, n0 + g), b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ int koff(int i, int q) { return q + 4 * i; }
  static __device__ __forceinline__ Packed pack(const float (&x)[kElems]) {
    Packed p;
    split_tf32(x[0], p.x, p.z);
    split_tf32(x[1], p.y, p.w);
    return p;
  }
  static __device__ __forceinline__ void unpack(const Packed& p, B& b) {
    b.hi[0] = p.x;
    b.hi[1] = p.y;
    b.lo[0] = p.z;
    b.lo[1] = p.w;
  }
  static __device__ __forceinline__ Raw pack_raw(const float (&x)[kElems]) {
    return make_uint2(__float_as_uint(x[0]), __float_as_uint(x[1]));
  }
  static __device__ __forceinline__ void unpack(const Raw& p, B& b) {
    split_tf32(__uint_as_float(p.x), b.hi[0], b.lo[0]);
    split_tf32(__uint_as_float(p.y), b.hi[1], b.lo[1]);
  }
  template <int NB>
  static __device__ __forceinline__ void mma(float (&c)[NB][4], const A& a, const B (&b)[NB],
                                             int n) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) mma1688(c[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) mma1688(c[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) mma1688(c[j], a.hi, b[j].hi[0], b[j].hi[1]);
  }
  static __device__ __forceinline__ float out(float x) { return x; }
};

// bf16: one m16n8k16 a k-step on operands rounded to bf16; outputs rounded
// once
template <>
struct Tc<true> {
  static constexpr int kK = 16, kElems = 4;
  typedef uint2 Packed;  // the pairs of k 2q, 2q + 8
  typedef uint2 Raw;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  template <class V>
  static __device__ __forceinline__ void load_a(const V& v, int m0, int k0, A& a) {
    const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
    a.r[0] = pack_bf16(v(m0 + g, k), v(m0 + g, k + 1));
    a.r[1] = pack_bf16(v(m0 + g + 8, k), v(m0 + g + 8, k + 1));
    a.r[2] = pack_bf16(v(m0 + g, k + 8), v(m0 + g, k + 9));
    a.r[3] = pack_bf16(v(m0 + g + 8, k + 8), v(m0 + g + 8, k + 9));
  }
  template <class V>
  static __device__ __forceinline__ void load_b(const V& v, int k0, int n0, B& b) {
    const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
    b.r[0] = pack_bf16(v(k, n0 + g), v(k + 1, n0 + g));
    b.r[1] = pack_bf16(v(k + 8, n0 + g), v(k + 9, n0 + g));
  }
  static __device__ __forceinline__ int koff(int i, int q) { return 2 * q + (i & 1) + 8 * (i >> 1); }
  static __device__ __forceinline__ Packed pack(const float (&x)[kElems]) {
    return make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
  static __device__ __forceinline__ Raw pack_raw(const float (&x)[kElems]) { return pack(x); }
  static __device__ __forceinline__ void unpack(const Packed& p, B& b) {
    b.r[0] = p.x;
    b.r[1] = p.y;
  }
  template <int NB>
  static __device__ __forceinline__ void mma(float (&c)[NB][4], const A& a, const B (&b)[NB],
                                             int n) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) mma16816(c[j], a.r, b[j].r[0], b[j].r[1]);
  }
  static __device__ __forceinline__ float out(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the row stride of the shared-memory buffers
__host__ __device__ __forceinline__ int row_floats(int D) { return round_up(D, 32); }

// R[r] as packed B fragments, bytes (n-tiles x k-steps x 32 lanes x the
// entry: 16 split fp32, 8 unsplit fp32 or bf16)
template <bool BF, bool SPLIT>
__host__ __device__ __forceinline__ size_t packed_bytes(int D) {
  const int kK = BF ? 16 : 8;
  return (size_t)((D + 7) / 8) * (round_up(D, kK) / kK) * 32 * (BF || !SPLIT ? 8 : 16);
}

// a packed entry: split (Packed) or, for the fp32 instance, not (Raw)
template <bool BF, bool SPLIT>
using PackedOf = typename std::conditional<SPLIT, typename Tc<BF>::Packed, typename Tc<BF>::Raw>::type;

// A block's rows: the sorted positions [begin, end) of one bucket r, in
// tiles of TR; tile t's first position and rows (0 past the last tile)
struct Tile {
  int p0, cnt;
};
struct Span {
  int r, begin, end;
  __device__ __forceinline__ int tiles(int TR) const { return (end - begin + TR - 1) / TR; }
  __device__ __forceinline__ Tile tile(int t, int TR) const {
    const int p0 = begin + t * TR;
    return Tile{p0, max(0, min(TR, end - p0))};
  }
};
__device__ __forceinline__ Span load_span(const int* blocks) {
  const int* e = blocks + 3 * blockIdx.x;
  return Span{__ldcg(e), __ldcg(e + 1), __ldcg(e + 2)};
}

// Rows of R staged in shared memory (swizzled as the tiles), row n at
// row(n): contiguous rows S floats long (RW 0), or in the forward's
// per-warp stages of RW rows (a multiple of 16): warp (n / RW) % kFwdWarps,
// stage s0 + n / (kFwdWarps RW)
struct RawRows {
  float* base;
  int S, NS, s0, RW;
  __device__ __forceinline__ float* row(int n) const {
    if (!RW) return base + (size_t)n * S;
    const int blk = n / RW;
    return base + ((size_t)(((blk % kFwdWarps) * NS + s0 + blk / kFwdWarps) * RW + n - blk * RW)) * S;
  }
};

// R[r]'s D rows into raw by the block's threads, 8 16-byte loads each in
// flight at a time
__device__ __forceinline__ void stage_r(const float* __restrict__ R, int r, int D,
                                        const RawRows& raw) {
  const int nc = D >> 2, total = D * nc;
  const float4* src = reinterpret_cast<const float4*>(R + (size_t)r * D * D);
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * blockDim.x) {
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) x[u] = __ldg(src + e);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x, row = e / nc;
      if (e < total)
        *reinterpret_cast<float4*>(raw.row(row) + swz_col(row, 4 * (e - row * nc))) = x[u];
    }
  }
}

// R[r], staged in raw, as packed B fragments: entry (n-tile j, k-step kk) of
// a lane at ((j KS + kk) 32 + lane), B(k, n) = R[r][n][k] (the forward's
// R^T) or, with TRANS, R[r][k][n] (dv's R); zeros past D
template <bool BF, bool TRANS, bool SPLIT>
__device__ __forceinline__ void pack_r(const RawRows& raw, int D, int KS,
                                       PackedOf<BF, SPLIT>* dst) {
  typedef Tc<BF> M;
  const int total = ((D + 7) >> 3) * KS * 32, q = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int step = blockDim.x >> 5;  // entries (j, kk) advance by the block's warps
  int j = 0, kk = threadIdx.x >> 5;
  while (kk >= KS) {
    kk -= KS;
    ++j;
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int n = j * 8 + g;
    float x[M::kElems];
#pragma unroll
    for (int i = 0; i < M::kElems; ++i) {
      const int k = kk * M::kK + M::koff(i, q);
      x[i] = k < D && n < D ? (TRANS ? raw.row(k)[swz_col(k, n)] : raw.row(n)[swz_col(n, k)])
                            : 0.0f;
    }
    if constexpr (SPLIT) dst[e] = M::pack(x);
    else dst[e] = M::pack_raw(x);
    for (kk += step; kk >= KS; kk -= KS) ++j;
  }
}

// zero the chunks past D of rows [0, rows) of a buffer (the cp.async copies
// never write them), by the threads [t0, t0 + nt)
__device__ __forceinline__ void zero_pad(float* buf, int rows, int D, int S, int t, int nt) {
  const int nc = D >> 2, np = (S >> 2) - nc;
  for (int e = t; e < rows * np; e += nt) {
    const int row = e / np, c = nc + e - row * np;
    *reinterpret_cast<float4*>(buf + at(S, row, 4 * c)) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A thread's 16-byte chunks of a buffer of `rows` rows of nc chunks, taken
// by `threads` threads, chunk e = t + threads i being row e / nc, chunk e %
// nc: consecutive threads copy consecutive bytes of a row
template <int CH>
struct Chunks {
  int row[CH], col[CH];
  __device__ __forceinline__ Chunks(int t, int threads, int nc) {
    int rw = t / nc, c = t - rw * nc;
    const int dr = threads / nc, dc = threads - dr * nc;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      row[i] = rw;
      col[i] = 4 * c;
      c += dc;
      rw += dr;
      if (c >= nc) {
        c -= nc;
        ++rw;
      }
    }
  }
};

// ================================================================= forward

template <bool BF>
size_t fwd_smem(int D, int stages) {
  const int S = row_floats(D), RW = 16;
  return packed_bytes<BF, true>(D) + sizeof(float) * (size_t)kFwdWarps * stages * RW * S +
         sizeof(int) * kFwdWarps * stages * RW;
}

// y[perm rows of each tile] = rows of v times R[r]^T, rounded as the
// instance says; the rows of bucket NR get 0. Block b takes the sorted
// positions blocks[3 b + 1] .. blocks[3 b + 2] of bucket blocks[3 b], in
// tiles of kFwdWarps RW rows; warp w the rows [RW w, RW w + RW) of every
// tile (an m-tile, RW = 16), each warp with its own ring of NS stages.
template <bool BF, int DMAX, int NS>
__global__ void __launch_bounds__(kFwdWarps * 32)
rel_fwd_kernel(const float* __restrict__ v, const float* __restrict__ R, int D, int NR,
               const int* __restrict__ blocks, const int* __restrict__ perm,
               float* __restrict__ y) {
  typedef Tc<BF> M;
  typedef typename M::Packed P;
  constexpr int RW = 16, TR = kFwdWarps * RW;
  constexpr int NT = DMAX / 8;              // n-tiles of 8 columns
  constexpr int CH = RW * (DMAX / 4) / 32;  // a lane's chunks of its RW rows
  extern __shared__ float4 smem4[];
  const int S = row_floats(D), nc = D >> 2, KS = round_up(D, M::kK) / M::kK, ntu = (D + 7) >> 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  P* Bp = reinterpret_cast<P*>(smem4);  // R[r]^T packed
  float* rings =
      reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + packed_bytes<BF, true>(D));
  float* ring = rings + (size_t)warp * NS * RW * S;  // [NS][RW][S]
  int* meta = reinterpret_cast<int*>(rings + (size_t)kFwdWarps * NS * RW * S) + warp * NS * RW;
  const Span sp = load_span(blocks);
  const int nt = sp.tiles(TR), r = sp.r;
  if (nt <= 0) return;
  zero_pad(ring, NS * RW, D, S, lane, 32);
  const Chunks<CH> ck(lane, 32, nc);
  // the perm rows of the lane's chunks of tile t (-1 past its rows)
  auto perms = [&](int t, int (&p)[CH]) {
    const Tile tl = sp.tile(t, TR);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int ra = warp * RW + ck.row[i];
      p[i] = ck.row[i] < RW && ra < tl.cnt ? __ldg(perm + tl.p0 + ra) : -1;
    }
  };
  // tile u's rows into stage u % NS, their perm rows into its meta
  auto issue = [&](int u, const int (&p)[CH]) {
    if (u < nt) {
      const int st = u % NS;
      int* m = meta + st * RW;
      float* dst = ring + (size_t)st * RW * S;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (ck.row[i] < RW && ck.col[i] == 0) m[ck.row[i]] = p[i];
        if (r != NR && p[i] >= 0)
          cp16(dst + at(S, ck.row[i], ck.col[i]), v + (size_t)p[i] * D + ck.col[i], 16);
      }
    }
    cp_commit();
  };
  // the first NS tiles' perm rows and R[r] in flight together; the
  // lookahead: p1, the perm rows of the next tile to issue (u)
  int u = NS - 1;
  int p0[NS - 1][CH], p1[CH];
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) perms(s, p0[s]);
  perms(u, p1);
  // R[r]^T packed once, staged in stages no tile holds yet: the stage the
  // first tiles leave free (when the warps' RW rows a stage hold D rows,
  // packed while they land), or the first stages (packed before they are
  // issued)
  const bool late = kFwdWarps * RW >= D;
  const RawRows raw{rings, S, NS, late ? NS - 1 : 0, RW};
  if (r != NR) stage_r(R, r, D, raw);
  auto pack = [&]() {
    __syncthreads();
    if (r != NR) pack_r<BF, false, true>(raw, D, KS, Bp);
    __syncthreads();
  };
  if (!late) pack();
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s, p0[s]);
  if (late) pack();
  for (int t = 0; t < nt; ++t) {
    issue(u, p1);
    perms(++u, p1);
    cp_wait<NS - 1>();
    __syncwarp();
    const int st = t % NS;
    const int* m = meta + st * RW;
    float* buf = ring + (size_t)st * RW * S;
    const int rows = min(RW, sp.tile(t, TR).cnt - warp * RW);
    if (r == NR) {  // rows outside [0, NR): zero
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (ck.row[i] < rows)
          *reinterpret_cast<float4*>(y + (size_t)m[ck.row[i]] * D + ck.col[i]) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      continue;
    }
    if (rows > 0) {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const RowView A{buf, S};
      for (int kk = 0; kk < KS; ++kk) {
        typename M::A a;
        M::load_a(A, 0, kk * M::kK, a);
        typename M::B b[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < ntu) M::unpack(Bp[(j * KS + kk) * 32 + lane], b[j]);
        M::mma(acc, a, b, ntu);
      }
      // the output rows through the stage (the warp's own rows), then
      // whole 16-byte chunks to their perm rows
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = j * 8 + 2 * q;
        if (j < ntu && col < D) {
          *reinterpret_cast<float2*>(buf + at(S, g, col)) =
              make_float2(M::out(acc[j][0]), M::out(acc[j][1]));
          *reinterpret_cast<float2*>(buf + at(S, g + 8, col)) =
              make_float2(M::out(acc[j][2]), M::out(acc[j][3]));
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (ck.row[i] < rows)
          *reinterpret_cast<float4*>(y + (size_t)m[ck.row[i]] * D + ck.col[i]) =
              *reinterpret_cast<const float4*>(buf + at(S, ck.row[i], ck.col[i]));
    }
    __syncwarp();
  }
  cp_wait<0>();
}

// ================================================================ backward

template <int DMAX>
struct BwdCfg {
  static constexpr int kStages = 2;
  static constexpr int kWarps = kBwdThreads / 32;
  static constexpr int NT = DMAX / 8;
  // dv: the tile's 4 m-tiles x NT n-tiles, NV a warp within one m-tile
  static constexpr int NV = 4 * NT / kWarps;
  // dR: (DMAX / 16) m-tiles x NT n-tiles, NDR a warp within one m-tile
  static constexpr int NDR = (DMAX / 16) * NT / kWarps;
  // a thread's chunks of a tile's rows (of dy, and of v)
  static constexpr int CH = kTR * (DMAX / 4) / kBwdThreads;
  // R's fragments split once (up to D 64), or at use (fp32 past 64: the
  // split ones would not fit beside the tiles)
  static constexpr bool kSplit = DMAX <= 64;
};

template <bool BF, int DMAX>
size_t bwd_smem(int D) {
  typedef BwdCfg<DMAX> C;
  const int S = row_floats(D);
  return packed_bytes<BF, C::kSplit>(D) +
         sizeof(float) * (size_t)(C::kStages * 2 + 1) * kTR * S +
         sizeof(int) * C::kStages * kTR;
}

// One pass over block b's tiles (as the forward's: the sorted positions
// blocks[3 b + 1] .. blocks[3 b + 2] of bucket r = blocks[3 b]):
// dv[perm rows] = rows of dy times R[r] (rounded as the instance says; 0 for
// bucket NR), and the sum of the tiles' dy^T v written to partials[b].
template <bool BF, int DMAX>
__global__ void __launch_bounds__(kBwdThreads, DMAX <= 64 ? 2 : 1)
rel_bwd_kernel(const float* __restrict__ v, const float* __restrict__ R,
               const float* __restrict__ dy, int D, int NR, const int* __restrict__ blocks,
               const int* __restrict__ perm, float* __restrict__ dv,
               float* __restrict__ partials) {
  typedef Tc<BF> M;
  typedef BwdCfg<DMAX> C;
  typedef PackedOf<BF, C::kSplit> P;
  constexpr int NS = C::kStages, CH = C::CH;
  extern __shared__ float4 smem4[];
  const int S = row_floats(D), nc = D >> 2, DD = D * D;
  const int KS = round_up(D, M::kK) / M::kK, ntu = (D + 7) >> 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  P* Bp = reinterpret_cast<P*>(smem4);  // R[r] packed
  // [NS][dy, v][kTR][S]
  float* ring =
      reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + packed_bytes<BF, C::kSplit>(D));
  float* dvs = ring + (size_t)NS * 2 * kTR * S;  // the tile's dv rows [kTR][S]
  int* meta = reinterpret_cast<int*>(dvs + (size_t)kTR * S);  // [NS][kTR] perm rows
  const Span sp = load_span(blocks);
  const int nt = sp.tiles(kTR), r = sp.r;
  if (nt <= 0) return;
  zero_pad(ring, NS * 2 * kTR, D, S, tid, blockDim.x);
  const Chunks<CH> ck(tid, kBwdThreads, nc);
  auto perms = [&](int t, int (&p)[CH]) {
    const Tile tl = sp.tile(t, kTR);
#pragma unroll
    for (int i = 0; i < CH; ++i)
      p[i] = ck.row[i] < kTR && ck.row[i] < tl.cnt ? __ldg(perm + tl.p0 + ck.row[i]) : -1;
  };
  auto issue = [&](int u, const int (&p)[CH]) {
    if (u < nt) {
      const int st = u % NS;
      int* m = meta + st * kTR;
      float* dyb = ring + (size_t)st * 2 * kTR * S;
      float* vb = dyb + (size_t)kTR * S;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (ck.row[i] >= kTR) continue;
        if (ck.col[i] == 0) m[ck.row[i]] = p[i];
        if (r != NR) {
          const size_t off = (size_t)max(p[i], 0) * D + ck.col[i];
          const int bytes = p[i] >= 0 ? 16 : 0;  // rows past the tile's: zeros
          cp16(dyb + at(S, ck.row[i], ck.col[i]), dy + off, bytes);
          cp16(vb + at(S, ck.row[i], ck.col[i]), v + off, bytes);
        }
      }
    }
    cp_commit();
  };
  int u = 0;
  int p1[CH];
  perms(u, p1);
  auto advance = [&]() { perms(++u, p1); };
  // R[r] packed once, staged in the stage the first tiles leave free, its
  // loads in flight with the first perm rows'
  const RawRows raw{ring + (size_t)(NS - 1) * 2 * kTR * S, S, NS, 0, 0};
  if (r != NR) stage_r(R, r, D, raw);
  __syncthreads();
  for (int s = 0; s < NS - 1; ++s) {
    issue(u, p1);
    advance();
  }
  if (r != NR) pack_r<BF, true, C::kSplit>(raw, D, KS, Bp);
  // this warp's dv tiles: m-tile mv, n-tiles nv0 .. nv0 + NV; dR: m-tile md,
  // n-tiles nd0 .. nd0 + NDR
  const int mv = warp / (C::NT / C::NV), nv0 = (warp % (C::NT / C::NV)) * C::NV;
  const int md = warp / (C::NT / C::NDR), nd0 = (warp % (C::NT / C::NDR)) * C::NDR;
  const int nv = min(C::NV, ntu - nv0), nd = min(C::NDR, ntu - nd0);
  float sum[C::NDR][4] = {};
  for (int t = 0; t < nt; ++t) {
    cp_wait<NS - 2>();
    __syncthreads();  // tile t has landed; every thread is done with tile t - 1
    issue(u, p1);
    advance();
    const int st = t % NS;
    const int* m = meta + st * kTR;
    const int cnt = sp.tile(t, kTR).cnt;
    if (r == NR) {  // rows outside [0, NR): dv 0
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (ck.row[i] < cnt)
          *reinterpret_cast<float4*>(dv + (size_t)m[ck.row[i]] * D + ck.col[i]) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* dyb = ring + (size_t)st * 2 * kTR * S;
    const float* vb = dyb + (size_t)kTR * S;
    // dv = dy R[r]: A(m = row, k = i) = dy, B(k = i, n = j) = R[i][j]; into
    // the dv rows' buffer
    if (mv * 16 < cnt && nv > 0) {
      float acc[C::NV][4];
#pragma unroll
      for (int j = 0; j < C::NV; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const RowView A{dyb, S};
      for (int kk = 0; kk < KS; ++kk) {
        typename M::A a;
        M::load_a(A, mv * 16, kk * M::kK, a);
        typename M::B b[C::NV];
#pragma unroll
        for (int j = 0; j < C::NV; ++j)
          if (j < nv) M::unpack(Bp[((nv0 + j) * KS + kk) * 32 + lane], b[j]);
        M::mma(acc, a, b, nv);
      }
#pragma unroll
      for (int j = 0; j < C::NV; ++j) {
        const int col = (nv0 + j) * 8 + 2 * q;
        if (j < nv && col < D) {
          *reinterpret_cast<float2*>(dvs + at(S, mv * 16 + g, col)) =
              make_float2(M::out(acc[j][0]), M::out(acc[j][1]));
          *reinterpret_cast<float2*>(dvs + at(S, mv * 16 + g + 8, col)) =
              make_float2(M::out(acc[j][2]), M::out(acc[j][3]));
        }
      }
    }
    // dR += dy^T v over the tile: A(m = i, k = row) = dy[row][i],
    // B(k = row, n = j) = v[row][j]; rows past cnt are zeros. Each tile's
    // product starts from zero and is added to the fp32 sums.
    if (md * 16 < D && nd > 0) {
      float acc[C::NDR][4];
#pragma unroll
      for (int j = 0; j < C::NDR; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const ColView A{dyb, S};
      const RowView B{vb, S};
      const int kend = round_up(cnt, M::kK);
      for (int k0 = 0; k0 < kend; k0 += M::kK) {
        typename M::A a;
        M::load_a(A, md * 16, k0, a);
        typename M::B b[C::NDR];
#pragma unroll
        for (int j = 0; j < C::NDR; ++j)
          if (j < nd) M::load_b(B, k0, (nd0 + j) * 8, b[j]);
        M::mma(acc, a, b, nd);
      }
#pragma unroll
      for (int j = 0; j < C::NDR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[j][e] += acc[j][e];
    }
    __syncthreads();  // the tile's dv rows are in their buffer
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (ck.row[i] < cnt)
        *reinterpret_cast<float4*>(dv + (size_t)m[ck.row[i]] * D + ck.col[i]) =
            *reinterpret_cast<const float4*>(dvs + at(S, ck.row[i], ck.col[i]));
  }
  if (r != NR) {  // the block's partial of dR[r]
    float* part = partials + (size_t)blockIdx.x * DD;
    const int i0 = md * 16 + g;
#pragma unroll
    for (int j = 0; j < C::NDR; ++j) {
      const int col = (nd0 + j) * 8 + 2 * q;
      if (j < nd && col < D) {
        if (i0 < D)
          *reinterpret_cast<float2*>(part + (size_t)i0 * D + col) = make_float2(sum[j][0], sum[j][1]);
        if (i0 + 8 < D)
          *reinterpret_cast<float2*>(part + (size_t)(i0 + 8) * D + col) =
              make_float2(sum[j][2], sum[j][3]);
      }
    }
  }
  cp_wait<0>();
}

// dR[r] = its blocks' partials summed in block order (0 with no rows): the
// backward's blocks rel_blocks[2 r] .. + rel_blocks[2 r + 1]. Grid
// (ceil(D D / 256), NR).
__global__ void rel_dr_reduce_kernel(const float* __restrict__ partials,
                                     const int* __restrict__ rel_blocks, int D,
                                     float* __restrict__ dR) {
  const int r = blockIdx.y, e = blockIdx.x * blockDim.x + threadIdx.x, DD = D * D;
  if (e >= DD) return;
  const int b0 = rel_blocks[2 * r], nb = rel_blocks[2 * r + 1];
  float s = 0.0f;
  for (int b = b0; b < b0 + nb; ++b) s += partials[(size_t)b * DD + e];
  dR[(size_t)r * DD + e] = s;
}

// ------------------------------------------------------------------- launch

int n_chunks(int N) { return (N + kChunk - 1) / kChunk; }

int valid_shape(int N, int D, int NR) {
  return N >= 1 && NR >= 1 && NR + 1 <= kMaxBuckets && D >= 4 && D % 4 == 0 && D <= kMaxD;
}

// counting warps a block of the count kernel: enough blocks to spread the
// chunks over the SMs (their shared-memory atomics), their counters within
// 48 KB (the last block's two NB spans come on top)
int count_warps(int NB, int chunks, int sms) {
  int wc = (chunks + sms - 1) / sms;
  if (wc > 32) wc = 32;
  if (wc * NB > 12288) wc = 12288 / NB;
  return wc < 1 ? 1 : wc;
}

// the runtime's answers, kept per device: SM count, the dynamic shared
// memory each kernel may take, which only rises (ids: forward 0-3, backward
// 4-7, count 8, scatter 9), blocks an SM (per tile kernel and D / 4)
struct DevCache {
  int sms;
  size_t smem[10];
  int occ[8][kMaxD / 4 + 1];
};
DevCache g_dev[kMaxDevices];

int device_sms(int dev) {
  if (!g_dev[dev].sms) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    g_dev[dev].sms = n;
  }
  return g_dev[dev].sms;
}

template <typename K>
int allow_smem(K kernel, int id, size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  if (bytes > g_dev[dev].smem[id]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    g_dev[dev].smem[id] = bytes;
  }
  return 0;
}

// the persistent grid of a tile kernel: SMs x its blocks an SM at D (0 on
// error)
template <typename K>
int persistent_grid(K kernel, int id, int threads, size_t smem, int D) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  int& occ = g_dev[dev].occ[id][D / 4];
  if (!occ) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
      return 0;
    occ = n;
  }
  return occ * device_sms(dev);
}

template <bool BF, int DMAX>
int fwd_grid(int D, size_t* smem_out) {
  auto kernel = rel_fwd_kernel<BF, DMAX, kFwdStages>;
  const int id = 2 * BF + (DMAX > 64);
  const size_t smem = fwd_smem<BF>(D, kFwdStages);
  if (smem_out) *smem_out = smem;
  if (allow_smem(kernel, id, smem)) return 0;
  return persistent_grid(kernel, id, kFwdWarps * 32, smem, D);
}

template <bool BF, int DMAX>
int bwd_grid(int D, size_t* smem_out) {
  auto kernel = rel_bwd_kernel<BF, DMAX>;
  const int id = 4 + 2 * BF + (DMAX > 64);
  const size_t smem = bwd_smem<BF, DMAX>(D);
  if (smem_out) *smem_out = smem;
  if (allow_smem(kernel, id, smem)) return 0;
  return persistent_grid(kernel, id, kBwdThreads, smem, D);
}

// the blocks each tile kernel holds on the card at once (0 on error)
int fwd_grid_of(int D, int bf16) {
  if (bf16) return D > 64 ? fwd_grid<true, 128>(D, nullptr) : fwd_grid<true, 64>(D, nullptr);
  return D > 64 ? fwd_grid<false, 128>(D, nullptr) : fwd_grid<false, 64>(D, nullptr);
}
int bwd_grid_of(int D, int bf16) {
  if (bf16) return D > 64 ? bwd_grid<true, 128>(D, nullptr) : bwd_grid<true, 64>(D, nullptr);
  return D > 64 ? bwd_grid<false, 128>(D, nullptr) : bwd_grid<false, 64>(D, nullptr);
}

// the scratch layout (ints): counts / offsets (NB, n_chunks), perm (N),
// rel_blocks (NB, 2), the forward's and the backward's block tables (Gf +
// NB, 3) and (Gb + NB, 3)
struct Buckets {
  int Gf, Gb;
  int *counts, *perm, *rel_blocks, *fblocks, *bblocks;
};

Buckets carve(int* scratch, int N, int D, int NR, int bf16) {
  Buckets k;
  const size_t NB = NR + 1;
  k.Gf = fwd_grid_of(D, bf16);
  k.Gb = bwd_grid_of(D, bf16);
  k.counts = scratch;
  k.perm = k.counts + (size_t)n_chunks(N) * NB;
  k.rel_blocks = k.perm + N;
  k.fblocks = k.rel_blocks + 2 * NB;
  k.bblocks = k.fblocks + 3 * (k.Gf + NB);
  return k;
}

template <bool BF, int DMAX>
int launch_fwd(const float* v, const float* R, int D, int NR, const Buckets& k, float* y,
               cudaStream_t s) {
  size_t smem = 0;
  if (!fwd_grid<BF, DMAX>(D, &smem)) return (int)cudaErrorInvalidConfiguration;
  rel_fwd_kernel<BF, DMAX, kFwdStages><<<k.Gf + NR + 1, kFwdWarps * 32, smem, s>>>(
      v, R, D, NR, k.fblocks, k.perm, y);
  return (int)cudaGetLastError();
}

template <bool BF, int DMAX>
int launch_bwd(const float* v, const float* R, const float* dy, int D, int NR, const Buckets& k,
               float* dv, float* partials, float* dR, cudaStream_t s) {
  size_t smem = 0;
  if (!bwd_grid<BF, DMAX>(D, &smem)) return (int)cudaErrorInvalidConfiguration;
  rel_bwd_kernel<BF, DMAX><<<k.Gb + NR + 1, kBwdThreads, smem, s>>>(v, R, dy, D, NR, k.bblocks,
                                                                   k.perm, dv, partials);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 rgrid((D * D + 255) / 256, NR);
  rel_dr_reduce_kernel<<<rgrid, 256, 0, s>>>(partials, k.rel_blocks, D, dR);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest D and the most relations (NR) the kernels take.
extern "C" int rel_apply_max_width() { return kMaxD; }
extern "C" int rel_apply_max_relations() { return kMaxBuckets - 1; }

// Ints of a call's bucket tables for (N, NR) and the instance at D, on the
// current device; -1 for a shape the kernels do not take or a failed query.
extern "C" long long rel_apply_scratch_ints(int N, int D, int NR, int bf16) {
  if (!valid_shape(N, D, NR)) return -1;
  const long long Gf = fwd_grid_of(D, bf16), Gb = bwd_grid_of(D, bf16), NB = NR + 1;
  if (!Gf || !Gb) return -1;
  return (long long)n_chunks(N) * NB + N + 2 * NB + 3 * (Gf + NB) + 3 * (Gb + NB);
}

// Floats of the backward's dR partials on the current device, one (D, D) a
// backward block; -1 for a shape the kernels do not take or a failed query.
extern "C" long long rel_apply_partial_floats(int N, int D, int NR, int bf16) {
  if (!valid_shape(N, D, NR)) return -1;
  const int G = bwd_grid_of(D, bf16);
  if (!G) return -1;
  return (long long)(G + NR + 1) * D * D;
}

// Bucket the rows by relation into scratch (rel_apply_scratch_ints ints) for
// the instance at D: rel_count_kernel and rel_scatter_kernel. ticket: one
// int, 0 before the call and again after it, kept by the caller per stream.
// Returns the CUDA error code.
extern "C" int rel_apply_bucket(const int* rel, int N, int D, int NR, int bf16, int* scratch,
                                int* ticket, void* stream) {
  if (!valid_shape(N, D, NR)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buckets k = carve(scratch, N, D, NR, bf16);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!k.Gf || !k.Gb) return (int)cudaErrorInvalidConfiguration;
  const int NB = NR + 1, nc = n_chunks(N), wc = count_warps(NB, nc, device_sms(dev));
  const int blocks = (nc + wc - 1) / wc;
  const size_t cnt_smem = sizeof(int) * (size_t)(wc + 2) * NB;  // counters, then the spans
  int err = allow_smem(rel_count_kernel, 8, cnt_smem);
  if (!err) err = allow_smem(rel_scatter_kernel, 9, sizeof(int) * NB);
  if (err) return err;
  rel_count_kernel<<<blocks, kCountThreads, cnt_smem, s>>>(rel, N, NR, wc, nc, k.Gf, k.Gb,
                                                           k.counts, k.rel_blocks, k.fblocks,
                                                           k.bblocks, ticket);
  err = (int)cudaGetLastError();
  if (err) return err;
  rel_scatter_kernel<<<nc, 32, sizeof(int) * NB, s>>>(rel, N, NR, nc, k.counts, k.perm);
  return (int)cudaGetLastError();
}

// v (N, D), R (NR, D, D), y (N, D) f32, contiguous; scratch as bucketed by
// rel_apply_bucket for these rows and this instance. rel_fwd_kernel. Returns
// the CUDA error code.
extern "C" int rel_apply_fwd(const float* v, const float* R, int N, int D, int NR, int bf16,
                             const int* scratch, float* y, void* stream) {
  if (!valid_shape(N, D, NR)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buckets k = carve(const_cast<int*>(scratch), N, D, NR, bf16);
  if (bf16)
    return D > 64 ? launch_fwd<true, 128>(v, R, D, NR, k, y, s)
                  : launch_fwd<true, 64>(v, R, D, NR, k, y, s);
  return D > 64 ? launch_fwd<false, 128>(v, R, D, NR, k, y, s)
                : launch_fwd<false, 64>(v, R, D, NR, k, y, s);
}

// As rel_apply_fwd, with dy (N, D) in and dv (N, D), dR (NR, D, D) out;
// partials rel_apply_partial_floats f32. rel_bwd_kernel and
// rel_dr_reduce_kernel.
extern "C" int rel_apply_bwd(const float* v, const float* R, const float* dy, int N, int D,
                             int NR, int bf16, const int* scratch, float* partials, float* dv,
                             float* dR, void* stream) {
  if (!valid_shape(N, D, NR)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buckets k = carve(const_cast<int*>(scratch), N, D, NR, bf16);
  if (bf16)
    return D > 64 ? launch_bwd<true, 128>(v, R, dy, D, NR, k, dv, partials, dR, s)
                  : launch_bwd<true, 64>(v, R, dy, D, NR, k, dv, partials, dR, s);
  return D > 64 ? launch_bwd<false, 128>(v, R, dy, D, NR, k, dv, partials, dR, s)
                : launch_bwd<false, 64>(v, R, dy, D, NR, k, dv, partials, dR, s);
}
