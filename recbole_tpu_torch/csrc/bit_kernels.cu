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
// The row product: bit_rows_claim_kernel, then bit_rows_kernel. A batch
// picks the same rows again and again (at the Yelp item side 3,952 distinct
// of 4,096, holding half the set bits; the top item, 14,468 set bits, 10
// times), and a few popular rows hold most of the set bits (the 100 heaviest
// picked rows 65%). So each distinct id is walked once, by the least pick of
// it, and a popular row is cut into pieces by its set bits.
//
// bit_rows_claim_kernel: each pick raises its id's owner word (persistent,
// tagged with the call's epoch, so nothing is cleared between calls) to
// name the least pick of the id, and notes into how many pieces its row
// would be cut: one a kSplitBits set bits of its count (the image's set bits
// a row, from the caller; none: 0), at most kMaxPieces. The counts only move
// the cuts: a wrong count changes the balance, never the sum beyond
// rounding.
//
// bit_rows_kernel: a persistent grid of the card's slots (or fewer, by R),
// launched to start while the claims run, whose warps work alone: no block
// barrier in the walk. Warp w owns the picks w, w + warps, .... It resolves
// them (a copy, an unsplit walker, or a split walker, which takes k slots of
// the call's rows_slot_cap and publishes them), walks the published slots
// w, w + warps, ... and then its other walkers, and then gives each of its
// copies its walker's row once written. A walk streams the row 2,048 bytes
// at a time through a ring of kStages in shared memory (cp.async, three in
// flight, evict-first in L2), numbers the set bits by a prefix over the
// lanes' popcounts, and each lane queues the columns of its set bits of the
// walk's range in shared memory at their number. Every 32 queued columns the
// warp loads those 32 rows of v into shared memory (evict-last in L2) and
// each lane adds its bf16 pairs of them in queue order into fp32 sums. A
// round costs about one load's latency under load (~5K clocks at the Yelp
// shape), whether its loads go in registers or by bulk copies on an
// mbarrier (tried; no faster). Piece j of k holds the set bits of index [count j / k,
// count (j + 1) / k), the last to the row's end; it is summed from zero, and
// the row is the sum of its pieces in order: a split walker's pieces are
// walked by many warps into their slots and added by the piece that finishes
// last (a ticket per row), a walker past the slots is walked by one warp
// piece by piece, to the same bits. So light rows take a warp each, and a
// popular row tens of warps. Every sum runs in an order fixed by the shapes,
// the data and the counts: two runs give the same bits, and no float
// atomics.
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
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// both kernels: D even, at most kMaxD (a lane holds kMaxPairs bf16 pairs)
constexpr int kMaxD = 128;
constexpr int kMaxPairs = kMaxD / 64;

// bit_rows_claim_kernel and bit_rows_kernel
constexpr int kClaimThreads = 256;
constexpr int kRowsThreads = 256;                 // the walk: 8 independent warps a block
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kSuperBytes = 32 * 64;              // a warp's super-chunk: 64 bytes a lane
constexpr int kQueue = 128;                       // columns a warp queues in shared memory
constexpr int kStages = 4;                        // super-chunks a warp's ring holds
constexpr int kSplitBits = 128;                   // set bits a piece of a split row
constexpr int kMaxPieces = 128;                   // pieces a row at most

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

// L2 eviction priorities for the row kernel: its rows of bits are streamed
// once (evict first), so that the rows of v it gathers stay (evict last).
__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ unsigned long long l2_evict_last() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}
// cp_async16 with an L2 eviction priority
__device__ __forceinline__ void cp_async16_hint(void* dst, const void* src, int bytes,
                                                unsigned long long policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "l"(policy)
               : "memory");
}
// a read-only 16-byte load with an L2 eviction priority
__device__ __forceinline__ uint4 ldg16_hint(const void* src, unsigned long long policy) {
  uint4 x;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "l"(src), "l"(policy));
  return x;
}

// A row-kernel call's state. Persistent, one per device and stream (the
// launcher keeps it): an owner word per id of the largest image called on,
// zeros at first, and an epoch. A call's claims raise each picked id's word
// to (epoch + 1) << 32 | (0xffffffff - r) for each r that picks it
// (atomicMax), so the word names the least r that picks the id in this
// call, a word of an earlier call never wins, and nothing is cleared; the
// walk's last block advances the epoch (2^32 calls a device and stream).
// Per call, int32 words the launcher allocates (rows_scratch_words), zeroed
// where needed by the claims:
enum {
  kSlotsTaken,     // split pieces given slots (past slot_cap: walked whole)
  kBlocksDone,     // walk blocks finished
  kResolved,       // picks resolved by the walk
  kUnsplit,        // unsplit walkers
  kSplitWalkers,   // split walkers
  kCopies,         // picks of an id another pick walks
  kOutside,        // picks outside the image
  kCtr
};

struct RowsScratch {
  int* ctr;         // [kCtr] the call's counters, in the order above
  int* pieces;      // [R] pieces of pick r, were it to walk its id (0: outside the image;
                    // -1 once resolved as a copy)
  int* done;        // [R] 1 once walker r's row is written
  int* ticket;      // [R] pieces of split walker r finished
  int* slot;        // [R] split walker r's first slot
  int* slot_owner;  // [slot_cap] the walker of each slot plus 1; 0 until published
};

__host__ __device__ inline long long rows_slot_cap(int R) { return R / 4 + 1024; }

__host__ __device__ inline long long rows_scratch_words(int R) {
  return kCtr + 4LL * R + rows_slot_cap(R);
}

// A fence that orders this thread's earlier and later memory accesses for
// the device (acquire and release; lighter than __threadfence's sequential
// consistency): with a flag written after one and read before another, the
// writes before the first are seen after the second.
__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

__device__ __forceinline__ RowsScratch rows_scratch(int* s, int R) {
  RowsScratch p;
  p.ctr = s;
  p.pieces = s + kCtr;
  p.done = p.pieces + R;
  p.ticket = p.done + R;
  p.slot = p.ticket + R;
  p.slot_owner = p.slot + R;
  return p;
}

// The pick an owner word names.
__device__ __forceinline__ int owner_pick(unsigned long long word) {
  return (int)(0xffffffffu - (unsigned)(word & 0xffffffffull));
}

// Each pick claims its id (the least r that picks an id walks it) and learns
// into how many pieces its row would be cut: one a kSplitBits set bits of
// its count (the image's set bits a row, from the caller; none: 0), at most
// kMaxPieces. A pick outside the image gets its NaN row here.
__global__ void __launch_bounds__(kClaimThreads)
bit_rows_claim_kernel(const int64_t* __restrict__ rows, int R, long long n_major,
                      const int* __restrict__ counts, long long nbits, int D,
                      unsigned long long* __restrict__ owner,
                      const unsigned long long* __restrict__ epoch, int* __restrict__ scratch,
                      float* __restrict__ out) {
  griddep_launch_dependents();  // the walk's blocks may take their SMs now
  const RowsScratch p = rows_scratch(scratch, R);
  const unsigned long long tag = (*epoch + 1) << 32;
  const long long stride = (long long)gridDim.x * kClaimThreads;
  const long long first = (long long)blockIdx.x * kClaimThreads + threadIdx.x;
  for (long long r = first; r < R; r += stride) {
    const long long m = rows[r];
    int k = 0;
    if (m >= 0 && m < n_major) {
      atomicMax(owner + m, tag | (0xffffffffull - (unsigned long long)r));
      const long long c = counts ? min(max((long long)counts[m], 0LL), nbits) : 0;
      k = (int)min((long long)kMaxPieces, max(1LL, (c + kSplitBits - 1) / kSplitBits));
    } else {
      // a row outside the matrix: a NaN row, loud, in place of a wild read
      for (int d = 0; d < D; ++d) out[r * D + d] = nanf("");
    }
    p.pieces[r] = k;
    p.done[r] = 0;
    p.ticket[r] = 0;
  }
  for (long long i = first; i < rows_slot_cap(R); i += stride) p.slot_owner[i] = 0;
  if (first < kCtr) p.ctr[first] = 0;
}

// The walk's shared memory, a warp's: the queue of columns, a ring of
// kStages super-chunks of the row (lane L's quarter i of super-chunk s is the
// 16 bytes at s kSuperBytes + 512 i + 16 L, held at ring[s % kStages][32 i +
// L]), and 32 / P rows of v (1,024 bf16 pairs either way).
struct WarpSmem {
  long long queue[kQueue];
  uint4 ring[kStages][4 * 32];
  __nv_bfloat162 vrows[32 * 32];
};

// Start the copy of super-chunk s of a row into the ring (zeros past the
// row; nothing past the last super-chunk), as one cp.async group.
__device__ __forceinline__ void stage_super(uint4 (&ring)[kStages][4 * 32], const uint8_t* row,
                                            int nbytes, int s, int lane,
                                            unsigned long long policy) {
  if ((long long)s * kSuperBytes < nbytes) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long off = (long long)s * kSuperBytes + 512 * i + 16 * lane;
      cp_async16_hint(&ring[s % kStages][32 * i + lane], off < nbytes ? row + off : row,
                      off < nbytes ? 16 : 0, policy);
    }
  }
  cp_async_commit();
}

// Queue this lane's set bits whose index in the walk's order is in [a, b):
// the bit of index g goes to dst[g - a]. The order: super-chunk by
// super-chunk, in one lane by lane, in a lane word by word of its 16 (word
// 4 i + h: quarter i's word h), bit by bit; g0 is the index of this lane's
// first set bit, col0 the column of its first byte's bit 0, w its quarters
// (w[32 i] is quarter i), nz the mask of its words that hold a set bit.
__device__ __forceinline__ void queue_bits(const uint4* w, unsigned nz, long long g0, long long a,
                                           long long b, long long* dst, long long col0) {
  long long g = g0;
  while (nz && g < b) {
    const int i = __ffs(nz) - 1;
    nz &= nz - 1;
    const unsigned* q = reinterpret_cast<const unsigned*>(w + 32 * (i >> 2));
    unsigned word = q[i & 3];
    const int pc = __popc(word);
    if (g + pc <= a) {
      g += pc;
      continue;
    }
    const long long c0 = col0 + 4096 * (i >> 2) + 32 * (i & 3);
    while (word && g < b) {
      const int pos = __ffs(word) - 1;
      word &= word - 1;
      if (g >= a) dst[g - a] = c0 + pos;
      ++g;
    }
  }
}

// Add the rows of v at the n (<= 32) queued columns q[0..n) into acc, in
// queue order, 32 / P rows at a time: the warp loads those rows into its
// buffer in shared memory (VEC: 16-byte loads under the L2 policy `keep`, a
// row's D / 8 chunks on as many lanes, D / 8 a power of two; else 4-byte
// ones), then each lane adds its bf16 pairs of them. A column past n_v, or
// past n, loads row 0 and adds nothing.
template <int P, bool VEC>
__device__ __forceinline__ void add_queued(const long long* q, int n,
                                           const __nv_bfloat162* __restrict__ v, long long n_v,
                                           int np, int lane, __nv_bfloat162* vrows,
                                           unsigned long long keep, float2 (&acc)[P]) {
  constexpr int kRows = 32 / P;
  for (int h = 0; h < n; h += kRows) {
    const long long mine = h + lane < n && lane < kRows ? q[h + lane] : -1;
    const bool in = mine >= 0 && mine < n_v;
    const unsigned ok = __ballot_sync(kFull, in);
    const long long src = in ? mine * np : 0;  // the pair where this lane's row starts
    if (VEC) {
      // np / 4 chunks a row: lane L loads chunk L % cpr of row (32 / cpr) i + L / cpr
      const int shift = __ffs(np / 4) - 1, cpr = 1 << shift, per = 32 >> shift;
      uint4 x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = per * i + (lane >> shift);
        const long long at = __shfl_sync(kFull, src, b < kRows ? b : 0);
        const uint4* chunk = reinterpret_cast<const uint4*>(v + at) + (lane & (cpr - 1));
        x[i] = per * i < kRows ? ldg16_hint(chunk, keep) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (per * i < kRows) reinterpret_cast<uint4*>(vrows)[32 * i + lane] = x[i];
    } else {
      // 4-byte pairs: flat pair b np + d2; lane L takes L, L + 32, ...
      const int total = kRows * np;
      for (int f0 = 0; f0 < total; f0 += 32 * 8) {
        __nv_bfloat162 x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int f = f0 + lane + 32 * i, b = f < total ? f / np : 0;
          x[i] = v[__shfl_sync(kFull, src, b) + (f < total ? f - b * np : 0)];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (f0 + lane + 32 * i < total) vrows[f0 + lane + 32 * i] = x[i];
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int b = 0; b < kRows; ++b) {
      if ((ok >> b) & 1u) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int d2 = lane + 32 * p;
          if (d2 < np) {
            const float2 x = pair(vrows + b * np + d2);
            acc[p].x += x.x;
            acc[p].y += x.y;
          }
        }
      }
    }
    __syncwarp();  // the buffer is free for the next rows
  }
}

// Walk pieces j0 .. j1 - 1 of k of one row into acc: piece j holds the set
// bits of index [c j / k, c (j + 1) / k) in the walk's order (the last piece
// to the row's end; c the row's count), summed from zero in that order, and
// acc = (0 + piece j0) + piece j0 + 1 + ..., so that a row walked whole in
// k pieces gives the bits of its k pieces walked apart and added in order.
// The warp streams the row a super-chunk at a time (cp.async, the next ones
// in flight), numbers its set bits (a lane's count, a prefix over the
// lanes), queues the columns in shared memory and adds 32 rows of v whenever
// 32 are queued, and the rest at a piece's end. It stops at the first
// super-chunk that reaches j1's cut.
template <int P, bool VEC>
__device__ __forceinline__ void walk_row(const uint8_t* __restrict__ row, int nbytes, int j0,
                                         int j1, int k, long long c,
                                         const __nv_bfloat162* __restrict__ v, long long n_v,
                                         int np, WarpSmem& ws, int lane, float2 (&acc)[P]) {
  auto cut = [&](int j) { return j == 0 ? 0LL : j == k ? LLONG_MAX : c * j / k; };
  const int supers = (nbytes + kSuperBytes - 1) / kSuperBytes;
  const unsigned long long stream = l2_evict_first(), keep = l2_evict_last();
  const long long end = cut(j1);
  float2 piece[P];
#pragma unroll
  for (int pp = 0; pp < P; ++pp) {
    acc[pp] = make_float2(0.0f, 0.0f);
    piece[pp] = make_float2(0.0f, 0.0f);
  }
  int j = j0;                // the piece being summed
  long long next = cut(j + 1);
  long long seen = 0;        // set bits before the super-chunk
  int q = 0;                 // columns queued
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage_super(ws.ring, row, nbytes, s, lane, stream);
  for (int s = 0; s < supers; ++s) {
    // a group a super-chunk (empty ones past the row), so that s has landed
    // once at most kStages - 1 are in flight
    stage_super(ws.ring, row, nbytes, s + kStages - 1, lane, stream);
    cp_async_wait<kStages - 1>();
    const uint4* mine = &ws.ring[s % kStages][lane];
    int cnt = 0;
    unsigned nz = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 w = mine[32 * i];
      cnt += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      nz |= (w.x ? 1u : 0u) << (4 * i) | (w.y ? 2u : 0u) << (4 * i) | (w.z ? 4u : 0u) << (4 * i) |
            (w.w ? 8u : 0u) << (4 * i);
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const long long g0 = seen + incl - cnt;
    const bool last = s + 1 == supers || seen + total >= end;
    long long a = max(cut(j0), seen);
    const long long b = min(end, seen + total);
    // the super-chunk's bits of [a, b), a window of the queue at a time; at a
    // piece's cut, and after the range's last bit, the whole queue is added
    bool finished = false;
    while (!finished && (a < b || last)) {
      const long long stop = min(b, next);
      const int take = (int)max(0LL, min(stop - a, (long long)(kQueue - q)));
      if (take && cnt > 0 && g0 < a + take && g0 + cnt > a)
        queue_bits(mine, nz, g0, a, a + take, ws.queue + q,
                   (long long)s * kSuperBytes * 8 + 128 * lane);
      __syncwarp();
      q += take;
      a += take;
      const bool at_cut = a == next || (last && a >= b);  // a > b: the range starts past the row
      const int full = at_cut ? q : q & ~31;
      for (int i = 0; i < full; i += 32)
        add_queued<P, VEC>(ws.queue + i, min(32, full - i), v, n_v, np, lane, ws.vrows, keep,
                           piece);
      if (full < q) {
        const int rest = q - full;
        const long long keep = lane < rest ? ws.queue[full + lane] : 0;
        __syncwarp();
        if (lane < rest) ws.queue[lane] = keep;
        __syncwarp();
      }
      q -= full;
      if (at_cut) {
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          acc[pp].x += piece[pp].x;
          acc[pp].y += piece[pp].y;
          piece[pp] = make_float2(0.0f, 0.0f);
        }
        if (a == next && j < j1 - 1) {
          ++j;
          next = cut(j + 1);
        } else {
          finished = true;  // the range's end
        }
      }
    }
    __syncwarp();  // every lane is done with this ring slot
    seen += total;
    if (last) break;
  }
  cp_async_wait<0>();  // the copies in flight land before the ring is reused
}

// Write a row (this lane's pairs in acc) to out[r].
template <int P>
__device__ __forceinline__ void write_row(long long r, const float2 (&acc)[P], int D, int np,
                                          int lane, float* __restrict__ out) {
  float2* dst = reinterpret_cast<float2*>(out + r * D);
#pragma unroll
  for (int pp = 0; pp < P; ++pp) {
    const int d2 = lane + 32 * pp;
    if (d2 < np) dst[d2] = acc[pp];
  }
}

// The walk: a persistent grid of the card's slots (or fewer, by R) whose
// warps work alone. Warp w of the grid owns the picks w, w + warps, ....
// 1. It resolves its picks: a pick is a copy unless its id's owner word
//    names it; a walker of more than one piece takes that many slots and
//    publishes them (past slot_cap it is walked whole, piece by piece).
// 2. It walks its slots w, w + warps, ... as they are published, until
//    every pick is resolved; the piece that finishes its row last (a
//    ticket) adds the row's slots in slot order and writes the row. Then it
//    walks its walkers that are not split.
// 3. It gives each of its copies its walker's row, once written.
// A walker's row is the same whoever walks it and however it is cut across
// warps: its pieces follow from the counts alone.
template <int P, bool VEC>
__global__ void __launch_bounds__(kRowsThreads, 3)
bit_rows_kernel(const uint8_t* __restrict__ bits, long long n_major, int nbytes,
                const int64_t* __restrict__ rows, int R, const __nv_bfloat162* __restrict__ v,
                long long n_v, int D, const int* __restrict__ counts,
                const unsigned long long* __restrict__ owner, unsigned long long* epoch,
                int* __restrict__ scratch, float2* __restrict__ partials,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int block_ctr[kCtr];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpSmem& ws = reinterpret_cast<WarpSmem*>(smem)[warp];
  const int np = D / 2;
  const long long nbits = 8LL * nbytes;
  const long long first = (long long)blockIdx.x * kRowsWarps + warp;
  const long long warps = (long long)gridDim.x * kRowsWarps;
  const int slot_cap = (int)rows_slot_cap(R);
  if (threadIdx.x < kCtr) block_ctr[threadIdx.x] = 0;
  griddep_wait();  // the claims
  const RowsScratch p = rows_scratch(scratch, R);
  auto count_of = [&](long long m) { return min(max((long long)counts[m], 0LL), nbits); };
  // 1. resolve this warp's picks; the block's counts go out once
  __syncthreads();
  for (long long r = first; r < R; r += warps) {
    const int k = __ldcg(p.pieces + r);
    const long long m = rows[r];
    int counter = kOutside;
    if (k > 0) {
      if (owner_pick(__ldcg(owner + m)) != r) {
        counter = kCopies;
        if (lane == 0) p.pieces[r] = -1;  // a copy
      } else if (k == 1) {
        counter = kUnsplit;
      } else {
        int base = slot_cap;
        if (lane == 0 && __ldcg(p.ctr + kSlotsTaken) < slot_cap)
          base = atomicAdd(p.ctr + kSlotsTaken, k);
        base = __shfl_sync(kFull, base, 0);
        const bool split = base + k <= slot_cap;
        counter = split ? kSplitWalkers : kUnsplit;
        if (lane == 0) p.slot[r] = split ? base : -1;  // -1: walked whole, piece by piece
        if (split) {
          fence_acq_rel();
          __syncwarp();
          for (int j = lane; j < k; j += 32) p.slot_owner[base + j] = (int)r + 1;
        }
      }
    }
    if (lane == 0) {
      atomicAdd(block_ctr + counter, 1);
      atomicAdd(block_ctr + kResolved, 1);
    }
  }
  fence_acq_rel();
  __syncthreads();
  if (threadIdx.x < kCtr && threadIdx.x >= kResolved && block_ctr[threadIdx.x])
    atomicAdd(p.ctr + threadIdx.x, block_ctr[threadIdx.x]);
  // 2. this warp's slots, as they are published, then its other walkers
  long long t = first, pick = first;
  for (;;) {
    long long r = -1;
    int k = 1, j0 = 0, j1 = 1;
    if (t < slot_cap) {
      int w = __ldcg(p.slot_owner + t);
      while (!w && __ldcg(p.ctr + kResolved) < R) {
        __nanosleep(64);
        w = __ldcg(p.slot_owner + t);
      }
      if (!w) w = __ldcg(p.slot_owner + t);
      if (!w) {
        // every pick is resolved and slot t was never published: past the
        // slots taken (then no later slot of this warp is), or the tail of
        // a row past slot_cap
        t = t >= __ldcg(p.ctr + kSlotsTaken) ? slot_cap : t + warps;
        continue;
      }
      r = w - 1;
      k = __ldcg(p.pieces + r);
      j0 = (int)t - __ldcg(p.slot + r);
      j1 = j0 + 1;
    } else {
      if (pick >= R) break;
      r = pick;
      pick += warps;
      k = __ldcg(p.pieces + r);
      // a walker not split: of one piece, or past the slots (slot -1)
      if (k <= 0 || (k > 1 && __ldcg(p.slot + r) >= 0)) continue;
      j1 = k;
    }
    const long long m = rows[r];
    float2 acc[P];
    walk_row<P, VEC>(bits + m * (long long)nbytes, nbytes, j0, j1, k, k > 1 ? count_of(m) : 0, v,
                     n_v, np, ws, lane, acc);
    if (t < slot_cap) {
      // piece j0 of a split row: its sums to its slot; the row's last piece
      // to finish adds its k slots in order
#pragma unroll
      for (int pp = 0; pp < P; ++pp) {
        const int d2 = lane + 32 * pp;
        if (d2 < np) partials[t * np + d2] = acc[pp];
      }
      const long long s0 = t - j0;
      t += warps;
      fence_acq_rel();
      __syncwarp();
      int finished = 0;
      if (lane == 0) finished = atomicAdd(p.ticket + r, 1);
      if (__shfl_sync(kFull, finished, 0) != k - 1) continue;
      fence_acq_rel();
#pragma unroll
      for (int pp = 0; pp < P; ++pp) {
        const int d2 = min(lane + 32 * pp, np - 1);
        float2 sum = make_float2(0.0f, 0.0f);
        for (int i0 = 0; i0 < k; i0 += 8) {
          float2 x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = i0 + i < k ? __ldcg(partials + (s0 + i0 + i) * np + d2)
                              : make_float2(0.0f, 0.0f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i0 + i < k) {
              sum.x += x[i].x;
              sum.y += x[i].y;
            }
          }
        }
        acc[pp] = sum;
      }
    }
    write_row<P>(r, acc, D, np, lane, out);
    fence_acq_rel();
    __syncwarp();
    if (lane == 0) atomicExch(p.done + r, 1);  // for the row's copies
  }
  // 3. this warp's copies: each its walker's row, once written
  for (long long r = first; r < R; r += warps) {
    if (__ldcg(p.pieces + r) >= 0) continue;
    const int o = owner_pick(__ldcg(owner + rows[r]));
    while (!__ldcg(p.done + o)) __nanosleep(64);
    fence_acq_rel();
    float2 acc[P];
#pragma unroll
    for (int pp = 0; pp < P; ++pp)
      acc[pp] = __ldcg(reinterpret_cast<const float2*>(out + (long long)o * D) +
                       min(lane + 32 * pp, np - 1));
    write_row<P>(r, acc, D, np, lane, out);
  }
  // the last block to finish advances the epoch
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel();
    if (atomicAdd(p.ctr + kBlocksDone, 1) == (int)gridDim.x - 1) atomicAdd(epoch, 1ull);
  }
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

namespace {

using RowsKernel = void (*)(const uint8_t*, long long, int, const int64_t*, int,
                            const __nv_bfloat162*, long long, int, const int*,
                            const unsigned long long*, unsigned long long*, int*, float2*, float*);

RowsKernel rows_kernel(int D, bool vec) {
  if (D <= 64) return vec ? bit_rows_kernel<1, true> : bit_rows_kernel<1, false>;
  return vec ? bit_rows_kernel<kMaxPairs, true> : bit_rows_kernel<kMaxPairs, false>;
}

// the walk's shared memory: a WarpSmem a warp
constexpr size_t kRowsSmem = kRowsWarps * sizeof(WarpSmem);

// 16-byte loads of v's rows: D / 8 chunks a row, a power of two, and v
// 16-byte aligned
bool rows_vec(int D, const void* v) {
  return D % 8 == 0 && ((D / 8) & (D / 8 - 1)) == 0 && (uintptr_t)v % 16 == 0;
}

int rows_allow(RowsKernel kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kRowsSmem);
}

}  // namespace

// The scratch a row-kernel call needs: int32 words (its counters, kCtr
// words, first) and float2 pairs (the split rows' partial sums).
extern "C" int bit_rows_sizes(int R, int D, long long* words, long long* pairs, int* ctr_words) {
  if (R < 0 || !shape_ok(D, kNbytesMultiple)) return (int)cudaErrorInvalidValue;
  *words = rows_scratch_words(R);
  *pairs = rows_slot_cap(R) * (D / 2);
  *ctr_words = kCtr;
  return 0;
}

// The walk's blocks an SM on the current device at D, and its SMs.
extern "C" int bit_rows_occupancy(int D, int* sms, int* blocks_per_sm) {
  if (!shape_ok(D, kNbytesMultiple)) return (int)cudaErrorInvalidValue;
  const RowsKernel kernel = rows_kernel(D, rows_vec(D, nullptr));
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = rows_allow(kernel);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kRowsThreads,
                                                             kRowsSmem);
  return err;
}

// Two launches on `stream`: the claims, then the walk on a persistent grid
// of at most `slots` blocks (the SMs times the walk's blocks an SM), under
// programmatic stream serialization so that its blocks take their SMs, and
// ask L2 for their rows, while the claims run. owner (n_major 64-bit words,
// zeros at first) and epoch (one word) are the device's and stream's state,
// kept between calls; scratch and partials hold bit_rows_sizes' words and
// pairs. report receives the launches, the walk's blocks and warps, and the
// slots for split pieces, as launched.
extern "C" int bit_rows_launch(const void* bits, long long n_major, int nbytes, const void* rows,
                               int R, const void* v, long long n_v, int D, const int* counts,
                               void* owner, void* epoch, int* scratch, void* partials, int slots,
                               float* out, void* stream, int* report) {
  if (R < 1 || slots < 1 || !shape_ok(D, nbytes)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long claim_blocks = ((long long)R + kClaimThreads - 1) / kClaimThreads;
  bit_rows_claim_kernel<<<claim_blocks < 1024 ? (int)claim_blocks : 1024, kClaimThreads, 0, s>>>(
      (const int64_t*)rows, R, n_major, counts, 8LL * nbytes, D, (unsigned long long*)owner,
      (const unsigned long long*)epoch, scratch, out);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const RowsKernel kernel = rows_kernel(D, rows_vec(D, v));
  err = rows_allow(kernel);
  if (err) return err;
  // at most R picks and rows_slot_cap(R) slots to walk
  const long long blocks = ((long long)R + rows_slot_cap(R) + kRowsWarps - 1) / kRowsWarps;
  const int grid = blocks < slots ? (int)blocks : slots;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = kRowsSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)bits, n_major, nbytes,
                                (const int64_t*)rows, R, (const __nv_bfloat162*)v, n_v, D, counts,
                                (const unsigned long long*)owner, (unsigned long long*)epoch,
                                scratch, (float2*)partials, out);
  report[0] = 2;
  report[1] = grid;
  report[2] = grid * kRowsWarps;
  report[3] = (int)rows_slot_cap(R);
  return err ? err : (int)cudaGetLastError();
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
