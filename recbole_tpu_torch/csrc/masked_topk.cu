// Fused masked score + top-k for full-sort evaluation, for Hopper (sm_90a).
//
// Replaces: recbole_tpu/ops/masked_topk.py::masked_topk_pallas (:94; kernel
// body _kernel :43-91, pallas_call :112). It computes what masked_topk_xla
// (:35-40) computes:
//   scores = q @ items^T;  scores[mask > 0] = -1e15;  top-k of each row,
// ordered (score desc, id asc) as lax.top_k orders them. The (B, N) score
// matrix never exists.
//
// What bounds it on the H100: at the main path's shape (an ml-1m-shaped
// pass: B = 4,096, N = 3,707, D = 64, k = 10) the work is 2 B N D = 1.94
// GFLOP against 17.5 MB of traffic (15.2 MB of it the int8 mask): 0.029 ms
// at the 67 TFLOP/s fp32 FMA rate, 0.012 ms at the 3xTF32 rate (a third of
// dense TF32's 494.7 TFLOP/s), 0.005 ms for the bytes. The products go to
// the tensor cores as 3xTF32: each operand split into a TF32 hi part (x
// rounded to its top 19 bits) and the remainder lo, three mma.sync m16n8k8
// a k-step (lo hi, hi lo, then hi hi; lo lo dropped) in fresh sums added to
// the fp32 total, which keeps about 2^-21 of each |a b|. A single TF32
// product would reorder near ties against the fp32 oracle. As measured
// (scripts/torch_topk_probe.py, PERF.md): mma.sync's TF32 rate and the
// products' latency leave the products alone at about 0.11 ms a call, and
// the selection, latency-bound chains of shuffles and ballots, about as
// much again unless it runs beside them.
//
// Design. The grid is (row tiles of 16 MT query rows, MT 4, 2 or 1) x (S
// slices of the item axis); the launcher (ops/masked_topk.py::
// masked_topk_plan) picks MT and S from (B, N, D, k) and the card's SM count
// so that one wave, a block an SM, fills the card. A block keeps its query
// rows in shared memory for its whole slice and walks the slice 64 items a
// step:
//   * items (a K chunk of at most 64 floats a row) and the tile's mask bytes
//     come by cp.async into a ring of 3 stages, issued 2 steps ahead. Mask
//     rows lie N bytes apart, so a row's 64 bytes start at any offset: the
//     kernel copies the aligned 16-byte chunks that cover them
//     (5 a row) and reads past the offset; a chunk that leaves the tensor's
//     B N bytes is read byte by byte within it.
//   * product_warps(MT) product warps: warp (wm, wn) computes rows 16 wm..
//     of 8 NTW items at 8 NTW wn (NTW m16n8 tiles), each fragment split at
//     use; D = 4 mod 8 is zero-padded to a multiple of 8 in shared memory,
//     and D > 64 runs in K chunks of 64 through the ring. Tile t's scores,
//     masked, go to one of two buffers, and a row's flag is raised where one
//     of them beats the row's k-th entry (its bar).
//   * kSelWarps selecting warps, in the same step, take tile t - 1 from the
//     other buffer, each its rows, a row at a time and flagged rows only: the
//     slice's first tile is sorted into the row's list (a bitonic network
//     over the warp); in a later one the entries that beat the bar are
//     ranked against the list and each other at once and placed. Each row's
//     top k so far and its bar lie in shared memory.
// A block then writes its slice's list (k entries a row, (-inf, INT_MAX)
// past the slice's items) to a scratch, and the last block of a row tile to
// finish (an integer ticket per row tile, reset by that block) merges the S
// lists: an entry's place is its position in its list plus, in each other
// list, the count of entries that beat it (a binary search), and it is
// kept when that place is below k. (score desc, id asc) is a strict total
// order over distinct ids, so the result does not depend on the order in
// which blocks finish, and two runs give the same bits. With S = 1 a block
// keeps its own lists. The block that holds a row's final k ids takes their
// values again in fp32 (a fused multiply-add a coordinate in order, as the
// plain fp32 product sums them), orders the row by those and writes it: the
// output's values carry fp32's rounding, and 3xTF32 only chooses the ids.
// One kernel a call.
//
// The bf16-operand instance (eval_score_dtype: bfloat16; the JAX trainer
// rounds the query and the table to bf16 before masked_topk,
// recbole_tpu/trainer/trainer.py:981-983, and its dot keeps fp32 sums):
// the same block, ring, selection and merge on bf16 query and item rows
// (D a multiple of 8; 16-byte copies of 8 elements), each k-step one
// mma.sync m16n8k16 with bf16 operands and fp32 accumulation: a product of
// two bf16 values is exact in fp32, so the tensor cores' sums differ from
// the plain fp32 product of the rounded operands only in their order. The
// chosen ids' values are taken again as the fp32 instance's are, a fused
// multiply-add a coordinate in order on the operands widened to fp32.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSelWarps = 16;            // selecting warps a block
constexpr int kTN = 64;               // items a tile
constexpr int kStages = 3;            // the staging ring's depth
constexpr int kKC = 64;               // elements of an item row a stage holds
constexpr int kMaskChunks = kTN / 16 + 1;  // 16-byte chunks covering 64 bytes
constexpr int kMaskRow = 16 * kMaskChunks; // bytes a staged mask row holds
constexpr int kSS = kTN + 8;          // the score tile's stride (floats)
constexpr int kMaxMerge = 512;        // S k a row, at most
constexpr int kMaxSlices = 16;
constexpr int kMaxSmem = 232448;      // a block's shared memory on the H100
constexpr float kNegInf = -1e15f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// an operand type's elements a 16-byte copy: 4 floats, 8 bf16
template <typename E>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(E); }

// a row of the query tile in shared memory: D zero-padded to a whole
// number of k-steps' pairs (8 floats, 16 bf16), plus 16 bytes, so that a
// fragment's 8 rows by 4 words hit 32 banks
template <typename E>
__host__ __device__ __forceinline__ int a_stride(int D) { return round_up(D, 2 * vec<E>()) + vec<E>(); }

// a staged item row's stride (elements), the same rule
template <typename E>
__host__ __device__ constexpr int item_stride() { return kKC + vec<E>(); }

// a ring stage: 64 item rows of a K chunk, and bm rows of mask bytes
template <typename E>
__host__ __device__ __forceinline__ int stage_bytes(int bm) {
  return kTN * item_stride<E>() * (int)sizeof(E) + bm * kMaskRow;
}

// a block of bm = 16 MT query rows: the query tile, the ring, two score
// tiles, each row's bar (its k-th entry) and two flags (a tile has an entry
// that beats the bar), each row's top k so far, and the block's flag
template <typename E>
__host__ __device__ __forceinline__ size_t smem_bytes(int bm, int D, int k) {
  return sizeof(E) * bm * a_stride<E>(D) + (size_t)kStages * stage_bytes<E>(bm) +
         (size_t)8 * bm * kSS + (size_t)16 * bm + (size_t)8 * bm * k + 16;
}

// a block's product warps: 16 at 32 and 64 rows (one or two m16n8 tiles a
// warp), 8 at 16 rows; its threads, with the selecting warps
__host__ __device__ constexpr int product_warps(int mt) { return mt >= 2 ? 16 : 8; }
__host__ __device__ constexpr int threads(int mt) { return 32 * (product_warps(mt) + kSelWarps); }

__device__ __forceinline__ bool beats(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

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

// c += a b: one m16n8k8 tile, tf32 operands, fp32 sums
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for 3xTF32: hi is x rounded to its top 19 bits (a tf32
// value, nearest, ties away from zero, by an integer add and a mask), lo the
// exact remainder (|lo| <= 2^-11 |x|), whose low bits the tensor cores drop:
// a product keeps about 2^-21 of |a b|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: one m16n8k16 tile, bf16 operands (two to a register), fp32 sums
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One K chunk of a product warp's tiles: rows 16 wm.. of the query tile
// (s_q at the warp's row g, column c kKC, lane's qd) against the NTW item
// tiles of its stage (s_it at its item g), nks k-steps.
// fp32: 3xTF32, each operand split at use, three mma.sync m16n8k8 a step in
// fresh sums (the small terms first), then one fp32 add.
template <int NTW>
__device__ __forceinline__ void chunk_products(float (*acc)[4], const float* s_q, const float* s_it,
                                               int AS, int nks, int qd) {
  s_q += qd;
  s_it += qd;
#pragma unroll
  for (int ks = 0; ks < kKC / 8; ++ks) {
    if (ks >= nks) break;
    uint32_t ah[4], al[4];
    split_tf32(s_q[8 * ks], ah[0], al[0]);
    split_tf32(s_q[8 * AS + 8 * ks], ah[1], al[1]);
    split_tf32(s_q[8 * ks + 4], ah[2], al[2]);
    split_tf32(s_q[8 * AS + 8 * ks + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(s_it[8 * j * item_stride<float>() + 8 * ks], bh0, bl0);
      split_tf32(s_it[8 * j * item_stride<float>() + 8 * ks + 4], bh1, bl1);
      // a k-step's three products in fresh sums, the small terms first,
      // then one fp32 add: the tensor cores' sums stay small
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma1688(d, al, bh0, bh1);
      mma1688(d, ah, bl0, bl1);
      mma1688(d, ah, bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
    }
  }
}

// bf16: one mma.sync m16n8k16 a step, the fragments read two elements a
// register, summed in the tensor cores' fp32 accumulators
template <int NTW>
__device__ __forceinline__ void chunk_products(float (*acc)[4], const __nv_bfloat16* s_q,
                                               const __nv_bfloat16* s_it, int AS, int nks,
                                               int qd) {
  s_q += 2 * qd;
  s_it += 2 * qd;
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    if (ks >= nks) break;
    uint32_t a[4];
    a[0] = ld32(s_q + 16 * ks);
    a[1] = ld32(s_q + 8 * AS + 16 * ks);
    a[2] = ld32(s_q + 16 * ks + 8);
    a[3] = ld32(s_q + 8 * AS + 16 * ks + 8);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const __nv_bfloat16* b = s_it + 8 * j * item_stride<__nv_bfloat16>() + 16 * ks;
      mma16816(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

// the fp32 value of q . item over D coordinates, a fused multiply-add a
// coordinate in order from 0 (the operands widened to fp32 first)
__device__ __forceinline__ float dot_fma(const float* qa, const float* ib, int D) {
  const float4* a4 = reinterpret_cast<const float4*>(qa);
  const float4* b4 = reinterpret_cast<const float4*>(ib);
  float v = 0.f;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    const float4 a = __ldg(a4 + c), b = __ldg(b4 + c);
    v = fmaf(a.x, b.x, v);
    v = fmaf(a.y, b.y, v);
    v = fmaf(a.z, b.z, v);
    v = fmaf(a.w, b.w, v);
  }
  return v;
}

__device__ __forceinline__ float dot_fma(const __nv_bfloat16* qa, const __nv_bfloat16* ib, int D) {
  const uint4* a4 = reinterpret_cast<const uint4*>(qa);
  const uint4* b4 = reinterpret_cast<const uint4*>(ib);
  float v = 0.f;
#pragma unroll 2
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = __ldg(a4 + c), b = __ldg(b4 + c);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      v = fmaf(af.x, bf.x, v);
      v = fmaf(af.y, bf.y, v);
    }
  }
  return v;
}

// the byte offset of a row's tile segment within its first staged chunk
__device__ __forceinline__ int mask_offset(const int8_t* mask, int row, int N, int item0) {
  return (int)(reinterpret_cast<uintptr_t>(mask + (size_t)row * N + item0) & 15);
}

// Sort 64 (score, id) pairs of a warp, lane l holding entries l (slot 0)
// and l + 32 (slot 1), best first in (score desc, id asc): a bitonic network,
// each block of `size` entries built best-first or worst-first by its place,
// then merged; 20 exchange stages by shuffle and one in registers.
__device__ __forceinline__ void sort64(float& v0, int& i0, float& v1, int& i1, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // size 64: entry l against entry l + 32, one lane
        if (beats(v1, i1, v0, i0)) {
          const float tv = v0; v0 = v1; v1 = tv;
          const int ti = i0; i0 = i1; i1 = ti;
        }
        continue;
      }
      const bool lower = (lane & j) == 0;
      const bool best0 = size == 64 || size == 32 || (lane & size) == 0;
      const bool best1 = size == 64 || (size < 32 && (lane & size) == 0);
      const float p0 = __shfl_xor_sync(kFull, v0, j), p1 = __shfl_xor_sync(kFull, v1, j);
      const int q0 = __shfl_xor_sync(kFull, i0, j), q1 = __shfl_xor_sync(kFull, i1, j);
      const bool take0 = lower == best0 ? beats(p0, q0, v0, i0) : beats(v0, i0, p0, q0);
      const bool take1 = lower == best1 ? beats(p1, q1, v1, i1) : beats(v1, i1, p1, q1);
      if (take0) { v0 = p0; i0 = q0; }
      if (take1) { v1 = p1; i1 = q1; }
    }
  }
}

// A row's running top k: entry (score, id) p of the row at lv[p], li[p],
// sorted best first, and its k-th entry, the bar, as one 64-bit word (read
// and written whole: the products' warps read it while a selecting warp may
// raise it).
__device__ __forceinline__ void store_bar(float2* bar, int r, float v, int i) {
  bar[r] = make_float2(v, __int_as_float(i));
}

// Tile t's selection by one warp, for its flagged rows (rows the products'
// warps saw an entry beat the bar in): the slice's first tile is sorted into
// the list; in a later one, the entries that beat the bar are ranked against
// the list and each other at once (an entry's place: the list's entries and
// the other candidates that beat it; a list entry's: its place plus the
// candidates that beat it), and those placed below k are written.
template <int SLOTS>
__device__ __forceinline__ void select_tile(const float* sc, int* flags, float* s_lv, int* s_li,
                                            float2* bars, int warp, int rw, int lane, int t,
                                            bool first, int N, int k) {
  unsigned flagged = __ballot_sync(kFull, lane < rw && flags[warp * rw + (lane < rw ? lane : 0)]);
  const int kth_lane = (k - 1) & 31;
  const int kth_slot = (k - 1) >> 5;
  while (flagged) {
    const int lr = warp * rw + __ffs(flagged) - 1;
    flagged &= flagged - 1;
    if (lane == 0) flags[lr] = 0;
    const float* sr = sc + lr * kSS;
    float* lvp = s_lv + lr * k;
    int* lip = s_li + lr * k;
    float sv0 = sr[lane], sv1 = sr[32 + lane];  // masked already
    int si0 = t * kTN + lane, si1 = si0 + 32;
    if (si0 >= N) { sv0 = -INFINITY; si0 = INT_MAX; }  // past the items
    if (si1 >= N) { sv1 = -INFINITY; si1 = INT_MAX; }
    if (first) {
      sort64(sv0, si0, sv1, si1, lane);
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        if (32 * u + lane < k) {
          lvp[32 * u + lane] = u == 0 ? sv0 : u == 1 ? sv1 : -INFINITY;
          lip[32 * u + lane] = u == 0 ? si0 : u == 1 ? si1 : INT_MAX;
        }
      }
      const float kv = __shfl_sync(kFull, kth_slot ? sv1 : sv0, kth_lane);
      const int ki = __shfl_sync(kFull, kth_slot ? si1 : si0, kth_lane);
      if (lane == 0) store_bar(bars, lr, kth_slot < 2 ? kv : -INFINITY, kth_slot < 2 ? ki : INT_MAX);
      __syncwarp();
      continue;
    }
    const float2 bar = bars[lr];
    const int bi = __float_as_int(bar.y);
    const unsigned bal0 = __ballot_sync(kFull, beats(sv0, si0, bar.x, bi));
    const unsigned bal1 = __ballot_sync(kFull, beats(sv1, si1, bar.x, bi));
    if (!(bal0 | bal1)) continue;
    // the list in registers, place l + 32 u in slot u of lane l; past k
    // none is needed (a candidate beats the k-th entry)
    float lv[SLOTS];
    int li[SLOTS];
    int up[SLOTS];  // candidates that beat the list entry
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const bool in = 32 * u + lane < k;
      lv[u] = in ? lvp[32 * u + lane] : -INFINITY;
      li[u] = in ? lip[32 * u + lane] : INT_MAX;
      up[u] = 0;
    }
    int r0 = 0, r1 = 0;  // the lane's candidates' places
    for (int h = 0; h < 2; ++h) {
      unsigned bal = h ? bal1 : bal0;
      const float sv = h ? sv1 : sv0;
      while (bal) {
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        const float cs = __shfl_sync(kFull, sv, src);
        const int ci = t * kTN + 32 * h + src;  // a candidate is an item below N
        int pos = 0;
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
          pos += __popc(__ballot_sync(kFull, beats(lv[u], li[u], cs, ci)));
          up[u] += beats(cs, ci, lv[u], li[u]);
        }
        if (lane == src) { if (h) r1 += pos; else r0 += pos; }
        r0 += beats(cs, ci, sv0, si0);
        r1 += beats(cs, ci, sv1, si1);
      }
    }
    __syncwarp();  // every lane has read the list
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int p = 32 * u + lane + up[u];
      if (32 * u + lane < k && p < k) {
        lvp[p] = lv[u];
        lip[p] = li[u];
      }
    }
    if (bal0 >> lane & 1 && r0 < k) { lvp[r0] = sv0; lip[r0] = si0; }
    if (bal1 >> lane & 1 && r1 < k) { lvp[r1] = sv1; lip[r1] = si1; }
    __syncwarp();
    if (lane == 0) store_bar(bars, lr, lvp[k - 1], lip[k - 1]);
    __syncwarp();
  }
}

// A block: 16 MT query rows (MT m16 tiles), product_warps(MT) product warps
// and kSelWarps selecting warps. Product warp (wm, wn) = (w % MT, w / MT)
// computes rows 16 wm.. of items 8 NTW wn.. (NTW m16n8 tiles) of tile t; in
// the same step selecting warp w selects rows RW w.. of tile t - 1: scores,
// masked, and the rows' flags alternate between two buffers.
template <typename E, int MT, int SLOTS>
__global__ void __launch_bounds__(threads(MT), 1)
masked_topk_kernel(const E* __restrict__ q, const E* __restrict__ items,
                   const int8_t* __restrict__ mask, int B, int N, int D, int k,
                   float* __restrict__ out_vals, int* __restrict__ out_ids,
                   float* __restrict__ part_vals, int* __restrict__ part_ids,
                   int* __restrict__ tickets) {
  constexpr int BM = 16 * MT;
  constexpr int PW = product_warps(MT);
  constexpr int NTW = 8 * MT / PW;    // m16n8 tiles a product warp
  constexpr int NT = threads(MT);
  constexpr int RW = BM / kSelWarps;  // rows a selecting warp takes
  constexpr int V = vec<E>();         // elements a 16-byte copy
  constexpr int IS = item_stride<E>();
  extern __shared__ float4 smem4[];
  const int AS = a_stride<E>(D);
  const int Dp = AS - V;
  const int SB = stage_bytes<E>(BM);
  E* s_a = reinterpret_cast<E*>(smem4);                                 // [BM][AS]
  char* s_ring = reinterpret_cast<char*>(s_a + BM * AS);                 // kStages x SB
  float* s_sc = reinterpret_cast<float*>(s_ring + (size_t)kStages * SB); // [2][BM][kSS]
  float2* s_bar = reinterpret_cast<float2*>(s_sc + 2 * BM * kSS);        // [BM]
  int* s_flag = reinterpret_cast<int*>(s_bar + BM);                      // [2][BM]
  float* s_lv = reinterpret_cast<float*>(s_flag + 2 * BM);               // [BM][k]
  int* s_li = reinterpret_cast<int*>(s_lv + BM * k);                     // [BM][k]
  int* s_last = s_li + BM * k;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int S = gridDim.y;
  const int T = (N + kTN - 1) / kTN;
  const int t_lo = (int)((long long)blockIdx.y * T / S);
  const int t_hi = (int)((long long)(blockIdx.y + 1) * T / S);
  const int nch = max(1, (Dp + kKC - 1) / kKC);
  const int nsteps = (t_hi - t_lo) * nch;
  const uintptr_t mask_lo = reinterpret_cast<uintptr_t>(mask);
  const uintptr_t mask_hi = mask_lo + (size_t)B * N;

  // the query tile, zero past B and past D (one commit group with step 0)
  {
    const int cpr = Dp / V;
    for (int i = tid; i < BM * cpr; i += NT) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = row0 + r < B && V * c < D;
      cp16(s_a + r * AS + V * c, ok ? q + (size_t)(row0 + r) * D + V * c : q, ok ? 16 : 0);
    }
  }

  // stage a step (tile, K chunk): the chunk's item rows and, with the
  // tile's last chunk, its mask bytes; one commit group, maybe empty
  auto issue = [&](int step) {
    if (step < nsteps) {
      const int t = t_lo + step / nch, c = step - (step / nch) * nch;
      char* stage = s_ring + (size_t)(step % kStages) * SB;
      E* s_it = reinterpret_cast<E*>(stage);
      const int k0 = c * kKC;
      const int cpr = min(kKC, Dp - k0) / V;
      const int dr = NT / cpr, dc = NT - dr * cpr;
      for (int i = tid, r = tid / cpr, cc = tid % cpr; i < kTN * cpr;
           i += NT, r += dr + (cc + dc >= cpr), cc += dc - (cc + dc >= cpr ? cpr : 0)) {
        const int item = t * kTN + r, col = k0 + V * cc;
        const bool ok = item < N && col < D;
        cp16(s_it + r * IS + V * cc, ok ? items + (size_t)item * D + col : items, ok ? 16 : 0);
      }
      if (c == nch - 1) {
        int8_t* s_m = reinterpret_cast<int8_t*>(stage + kTN * IS * sizeof(E));
        for (int i = tid; i < BM * kMaskChunks; i += NT) {
          const int r = i / kMaskChunks, cc = i - r * kMaskChunks;
          if (row0 + r >= B) continue;
          const uintptr_t seg = reinterpret_cast<uintptr_t>(mask + (size_t)(row0 + r) * N +
                                                            (size_t)t * kTN);
          const uintptr_t chunk = (seg & ~(uintptr_t)15) + 16 * cc;
          int8_t* dst = s_m + r * kMaskRow + 16 * cc;
          if (chunk >= mask_lo && chunk + 16 <= mask_hi) {
            cp16(dst, reinterpret_cast<const void*>(chunk), 16);
          } else {
            for (int b = 0; b < 16; ++b) {
              const uintptr_t p = chunk + b;
              dst[b] = p >= mask_lo && p < mask_hi ? *reinterpret_cast<const int8_t*>(p) : 0;
            }
          }
        }
      }
    }
    cp_commit();
  };

  for (int r = tid; r < BM; r += NT) {
    store_bar(s_bar, r, -INFINITY, INT_MAX);  // before the first tile every entry passes
    s_flag[r] = s_flag[BM + r] = 0;
  }
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const int wm = warp % MT, wn = warp / MT;
  float acc[NTW][4];
  for (int step = 0; step < nsteps; ++step) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step's stage landed; the stage refilled below is consumed
    issue(step + kStages - 1);

    const int t = t_lo + step / nch, c = step - (step / nch) * nch;
    if (warp >= PW) {  // a selecting warp: the tile before
      if (c == nch - 1 && t > t_lo) {
        const int tp = t - 1;
        select_tile<SLOTS>(s_sc + (tp & 1) * BM * kSS, s_flag + (tp & 1) * BM, s_lv, s_li,
                           s_bar, warp - PW, RW, lane, tp, tp == t_lo, N, k);
      }
      continue;
    }
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const char* stage = s_ring + (size_t)(step % kStages) * SB;
    // a k-step is 8 fp32 or 16 bf16 coordinates
    chunk_products<NTW>(acc, s_a + (wm * 16 + g) * AS + c * kKC,
                        reinterpret_cast<const E*>(stage) + (wn * 8 * NTW + g) * IS, AS,
                        min(kKC, Dp - c * kKC) / (2 * V), qd);
    if (c != nch - 1) continue;

    // the tile's scores, masked, to its buffer, and each row's flag raised
    // where one of them beats the row's bar (read as the previous tile's
    // selection may be raising it: a lower bar only flags more rows)
    {
      const int8_t* s_m = reinterpret_cast<const int8_t*>(stage + kTN * IS * sizeof(E));
      float* sc = s_sc + (t & 1) * BM * kSS;
      int* flags = s_flag + (t & 1) * BM;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = wm * 16 + g + 8 * half;
        const bool live = row0 + lr < B;
        const int8_t* mr = s_m + lr * kMaskRow +
                           (live ? mask_offset(mask, row0 + lr, N, t * kTN) : 0);
        const float2 bar = s_bar[lr];
        const int bi = __float_as_int(bar.y);
        bool cand = false;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int col = wn * 8 * NTW + 8 * j + 2 * qd;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = live && mr[col + e] > 0 ? kNegInf : acc[j][2 * half + e];
            cand |= t * kTN + col + e < N && beats(v[e], t * kTN + col + e, bar.x, bi);
          }
          *reinterpret_cast<float2*>(sc + lr * kSS + col) = make_float2(v[0], v[1]);
        }
        if (cand && live) flags[lr] = 1;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the last tile's scores and flags
  if (warp >= PW) {
    const int tp = t_hi - 1;
    select_tile<SLOTS>(s_sc + (tp & 1) * BM * kSS, s_flag + (tp & 1) * BM, s_lv, s_li, s_bar,
                       warp - PW, RW, lane, tp, tp == t_lo, N, k);
  }
  __syncthreads();  // every row's list is final

  const int nrows = min(BM, B - row0);
  if (S > 1) {
    // the slice's lists to the scratch; the last block of the row tile to
    // finish merges them
    float* dv = part_vals + (size_t)blockIdx.y * B * k;
    int* di = part_ids + (size_t)blockIdx.y * B * k;
    for (int x = tid; x < nrows * k; x += NT) {
      dv[(size_t)row0 * k + x] = s_lv[x];
      di[(size_t)row0 * k + x] = s_li[x];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *s_last = atomicAdd(tickets + blockIdx.x, 1) == S - 1;
    __syncthreads();
    if (!*s_last) return;
    __threadfence();

    // The merge of the S lists of each row, as many rows at a time as the
    // query tile's and the ring's bytes hold: all threads load them, then
    // each takes entries in turn; an entry's place is its position plus, in
    // each other list of its row, the count of entries that beat it (a
    // binary search), and its id goes to that place of the row's list when
    // the place is below k.
    const int L = S * k;
    const int room = (BM * AS * (int)sizeof(E) + kStages * SB) / 8;  // entries the region holds
    const int RC = min(nrows, room / L);
    float* mv = reinterpret_cast<float*>(smem4);
    int* mi = reinterpret_cast<int*>(mv + RC * L);
    for (int c0 = 0; c0 < nrows; c0 += RC) {
      const int nr = min(RC, nrows - c0);
      const int n = nr * L;
      __syncthreads();
      // entry (list s, row c, place p) at (s nr + c) k + p: a list's rows lie
      // together in the scratch; four loads in flight a thread
      for (int x0 = tid; x0 < n; x0 += 4 * NT) {
        float v[4];
        int id[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int x = x0 + u * NT;
          if (x < n) {
            const int s = x / (nr * k), rem = x - s * nr * k;
            const size_t at = ((size_t)s * B + row0 + c0) * k + rem;
            v[u] = __ldcg(part_vals + at);
            id[u] = __ldcg(part_ids + at);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (x0 + u * NT < n) {
            mv[x0 + u * NT] = v[u];
            mi[x0 + u * NT] = id[u];
          }
        }
      }
      __syncthreads();
      for (int x = tid; x < n; x += NT) {
        const int sl = x / (nr * k), rem = x - sl * nr * k;
        const int c = rem / k, p = rem - c * k;
        const float ev = mv[x];
        const int ei = mi[x];
        int rank = p;
        for (int o = 0; o < S && rank < k; ++o) {
          if (o == sl) continue;
          const float* ov = mv + (o * nr + c) * k;
          const int* oi = mi + (o * nr + c) * k;
          int lo = 0, hi = k;  // entries of list o that beat e form a prefix
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (beats(ov[mid], oi[mid], ev, ei)) lo = mid + 1; else hi = mid;
          }
          rank += lo;
        }
        if (rank < k) s_li[(c0 + c) * k + rank] = ei;
      }
    }
    if (tid == 0) tickets[blockIdx.x] = 0;
    __syncthreads();  // every row's merged list
  }

  // The rows' k ids are chosen; their values are taken again as the plain
  // fp32 product takes them, a fused multiply-add a coordinate in order from
  // 0, so that the output carries fp32's rounding and not 3xTF32's (which
  // near a score of 0 lies up to about 2^-21 of the largest product from
  // it), and each row is ordered again by (score desc, id asc) on those
  // values. The choice stays 3xTF32's: an id can differ from the plain
  // version's only at a near tie.
  for (int x = tid; x < nrows * k; x += NT) {
    const size_t row = (size_t)row0 + x / k;
    const int id = s_li[x];
    float v = -INFINITY;  // never: k <= N real items fill every list
    if (id >= 0 && id < N) {
      v = mask[row * N + id] > 0 ? kNegInf : dot_fma(q + row * D, items + (size_t)id * D, D);
    }
    s_lv[x] = v;
  }
  __syncthreads();
  for (int x = tid; x < nrows * k; x += NT) {
    const int r = x / k;
    const float v = s_lv[x];
    const int id = s_li[x];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += beats(s_lv[r * k + j], s_li[r * k + j], v, id);
    out_vals[(size_t)(row0 + r) * k + rank] = v;
    out_ids[(size_t)(row0 + r) * k + rank] = id;
  }
}

template <typename E, int MT, int SLOTS>
int launch(const E* q, const E* items, const int8_t* mask, int B, int N, int D, int k,
           int S, float* vals, int* ids, float* part, int* tickets, cudaStream_t stream) {
  // the kernel's shared-memory limit, raised once per device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(raised >> dev & 1ull)) {
    err = cudaFuncSetAttribute(masked_topk_kernel<E, MT, SLOTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised |= 1ull << dev;
  }
  constexpr int BM = 16 * MT;
  const size_t smem = smem_bytes<E>(BM, D, k);
  const dim3 grid((B + BM - 1) / BM, S);
  float* part_vals = part;
  int* part_ids = part ? reinterpret_cast<int*>(part + (size_t)S * B * k) : nullptr;
  masked_topk_kernel<E, MT, SLOTS><<<grid, threads(MT), smem, stream>>>(
      q, items, mask, B, N, D, k, vals, ids, part_vals, part_ids, tickets);
  return (int)cudaGetLastError();
}

template <typename E, int MT>
int launch_k(const E* q, const E* items, const int8_t* mask, int B, int N, int D, int k,
             int S, float* vals, int* ids, float* part, int* tickets, cudaStream_t s) {
  if (k <= 32) return launch<E, MT, 1>(q, items, mask, B, N, D, k, S, vals, ids, part, tickets, s);
  if (k <= 64) return launch<E, MT, 2>(q, items, mask, B, N, D, k, S, vals, ids, part, tickets, s);
  return launch<E, MT, 4>(q, items, mask, B, N, D, k, S, vals, ids, part, tickets, s);
}

template <typename E>
int launch_checked(const E* q, const E* items, const int8_t* mask, int B, int N, int D, int k,
                   int mt, int S, float* vals, int* ids, float* part, int* tickets, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (N + kTN - 1) / kTN;
  if (B < 1 || k < 1 || k > 128 || k > N || D < 0 || D % vec<E>() || D > 512 || S < 1 ||
      S > T || S > kMaxSlices || (mt != 1 && mt != 2 && mt != 4) ||
      (S > 1 && (S * k > kMaxMerge || !part || !tickets)) ||
      smem_bytes<E>(16 * mt, D, k) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (mt == 4) return launch_k<E, 4>(q, items, mask, B, N, D, k, S, vals, ids, part, tickets, s);
  if (mt == 2) return launch_k<E, 2>(q, items, mask, B, N, D, k, S, vals, ids, part, tickets, s);
  return launch_k<E, 1>(q, items, mask, B, N, D, k, S, vals, ids, part, tickets, s);
}

}  // namespace

// q (B, D) f32, items (N, D) f32, mask (B, N) int8, all contiguous, D % 4 == 0,
// q and items 16-byte aligned; vals (B, k) f32 and ids (B, k) int32 are
// written. 1 <= k <= 128, k <= N, D <= 512. Blocks of 16 mt query rows (mt
// 1, 2 or 4, whose shared memory fits) and S slices of the item axis
// (1 <= S <= min(16, ceil(N / 64)), S k <= 512), as
// ops/masked_topk.py::masked_topk_plan picks them. With S > 1: part holds
// 2 S B k floats (the slices' lists) and tickets one zeroed int per row tile
// (left zeroed). Returns the CUDA error code of the launch.
extern "C" int masked_topk_f32(const float* q, const float* items, const int8_t* mask, int B,
                               int N, int D, int k, int mt, int S, float* vals, int* ids,
                               float* part, int* tickets, void* stream) {
  return launch_checked<float>(q, items, mask, B, N, D, k, mt, S, vals, ids, part, tickets,
                               stream);
}

// The bf16-operand instance: q (B, D) and items (N, D) bf16, D % 8 == 0, the
// rest as masked_topk_f32 (vals fp32).
extern "C" int masked_topk_bf16(const void* q, const void* items, const int8_t* mask, int B,
                                int N, int D, int k, int mt, int S, float* vals, int* ids,
                                float* part, int* tickets, void* stream) {
  return launch_checked<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(q),
                                       static_cast<const __nv_bfloat16*>(items), mask, B, N, D,
                                       k, mt, S, vals, ids, part, tickets, stream);
}
