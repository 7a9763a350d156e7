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
// Two instances (template flag BF). fp32: everything fp32, the function of
// RippleNet's XLA relation loop (recbole_tpu/models/knowledge/ripplenet.py:
// 173-178). bf16: the TPU kernel's rounding points: v, dy and R rounded to
// bf16, products summed in fp32, y and dv rounded to bf16 (then stored as
// f32, as the JAX kernel returns them), dR summed in fp32 without a final
// rounding.
//
// What bounds it on the H100 (RippleNet's step: N = 4,096 rows x 2 hops x 16
// memories = 131,072, D = 64, NR = 53): bytes. The forward moves v, rel, R
// and y (about 68.5 MB, 0.020 ms at 3.35 TB/s) for 1.07 GFLOP (0.016 ms at
// the fp32 rate); the backward v, rel, R, dy, dv and dR (about 102.5 MB,
// 0.031 ms) for 2.15 GFLOP (0.032 ms).
//
// Design. The TPU kernel multiplies every row by all NR matrices at once (one
// (rows, D) x (D, NR D) product) and keeps the right span with a mask, so it
// does NR times the work to stay on the matrix unit. Here the rows are
// bucketed by relation on the device first, so that a block works on rows of
// one relation only and reads that relation's matrix once:
//   1. rel_count_kernel: one warp per chunk of kChunk rows counts the
//      chunk's rows per bucket (NR relations and one bucket for rows outside
//      [0, NR)) with shared-memory integer atomics (an order-free count);
//   2. rel_scan_kernel (one block): each bucket's total and start, each
//      (chunk, bucket)'s first position, and a table of tiles of at most kTR
//      rows of one bucket, in bucket order;
//   3. rel_scatter_kernel: one warp per chunk writes its rows' indices into
//      their buckets in row order (ranks within a 32-row group from
//      __match_any_sync), so the permutation is the stable sort by relation
//      and the same every run;
//   4. rel_rows_kernel (forward y, and dv with R transposed): a block of 256
//      threads per tile holds R[r] (or its transpose) in shared memory, rows
//      padded by one float (bank-conflict-free reads along a row), gathers the
//      tile's rows of v (dy), and writes each output row to its own place;
//      a thread owns one output column and 4 rows at a time;
//   5. rel_dr_tile_kernel: a block per tile forms the tile's partial
//      dy^T v (D, D) from its gathered rows, a thread owning 4 x 4 outputs;
//      rel_dr_reduce_kernel sums each relation's tile partials in tile order
//      (a relation with no rows gets 0). No float atomics: two runs give the
//      same bits.
// The grid of the tile kernels is the bound ceil(N / kTR) + NR + 1 tiles,
// so nothing waits for the host; blocks past the table's end return. Steps
// 1-3 run once per call (the forward's, and again in the backward) and move
// about 1 MB at N = 131,072.
//
// Limits: D a multiple of 4 (float4 rows) and at most kMaxD = 128 (R[r] and
// a (kTR, D) row tile in shared memory: 131,584 bytes at D = 128), NR + 1
// buckets at most kMaxBuckets (their counters in shared memory); any N.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;          // rows a warp counts and scatters
constexpr int kTR = 128;             // rows of a tile
constexpr int kMaxD = 128;
constexpr int kMaxBuckets = 16384;   // NR + 1 (shared-memory counters)

template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if (BF) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// the bucket of a row: its relation, or NR for a relation outside [0, NR)
__device__ __forceinline__ int bucket_of(int r, int NR) {
  return (r >= 0 && r < NR) ? r : NR;
}

// counts[c * NB + b] = rows of chunk c in bucket b
__global__ void rel_count_kernel(const int* __restrict__ rel, int N, int NR,
                                 int* __restrict__ counts) {
  extern __shared__ int cnt[];
  const int NB = NR + 1, c = blockIdx.x;
  for (int b = threadIdx.x; b < NB; b += blockDim.x) cnt[b] = 0;
  __syncwarp();
  const int end = min(N, (c + 1) * kChunk);
  for (int n = c * kChunk + threadIdx.x; n < end; n += blockDim.x)
    atomicAdd(&cnt[bucket_of(rel[n], NR)], 1);
  __syncwarp();
  for (int b = threadIdx.x; b < NB; b += blockDim.x) counts[(size_t)c * NB + b] = cnt[b];
}

// One block. offsets[c * NB + b]: the first sorted position of chunk c's
// rows of bucket b. tiles[t] = (bucket, first sorted position, rows) for t
// < max_tiles (rows 0 past the table's end). rel_tiles[b] = (first tile,
// tiles) of bucket b.
__global__ void rel_scan_kernel(const int* __restrict__ counts, int n_chunks, int NR,
                                int max_tiles, int* __restrict__ offsets,
                                int* __restrict__ tiles, int* __restrict__ rel_tiles) {
  extern __shared__ int sh[];
  const int NB = NR + 1;
  int* start = sh;          // [NB]
  int* tile0 = sh + NB;     // [NB + 1]
  for (int b = threadIdx.x; b < NB; b += blockDim.x) {
    int total = 0;
    for (int c = 0; c < n_chunks; ++c) total += counts[(size_t)c * NB + b];
    start[b] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int pos = 0, t = 0;
    for (int b = 0; b < NB; ++b) {
      const int total = start[b];
      start[b] = pos;
      tile0[b] = t;
      pos += total;
      t += (total + kTR - 1) / kTR;
    }
    tile0[NB] = t;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < NB; b += blockDim.x) {
    int run = start[b];
    for (int c = 0; c < n_chunks; ++c) {
      offsets[(size_t)c * NB + b] = run;
      run += counts[(size_t)c * NB + b];
    }
    const int total = run - start[b], t0 = tile0[b], nt = tile0[b + 1] - t0;
    for (int k = 0; k < nt; ++k) {
      tiles[3 * (t0 + k)] = b;
      tiles[3 * (t0 + k) + 1] = start[b] + k * kTR;
      tiles[3 * (t0 + k) + 2] = min(kTR, total - k * kTR);
    }
    rel_tiles[2 * b] = t0;
    rel_tiles[2 * b + 1] = nt;
  }
  for (int t = tile0[NB] + threadIdx.x; t < max_tiles; t += blockDim.x) {
    tiles[3 * t] = NR;
    tiles[3 * t + 1] = 0;
    tiles[3 * t + 2] = 0;
  }
}

// perm[offsets of its chunk and bucket + its rank among them] = n, in row
// order within a chunk: the stable sort of the rows by bucket
__global__ void rel_scatter_kernel(const int* __restrict__ rel, int N, int NR,
                                   const int* __restrict__ offsets, int* __restrict__ perm) {
  extern __shared__ int run[];
  const int NB = NR + 1, c = blockIdx.x, lane = threadIdx.x;
  for (int b = lane; b < NB; b += 32) run[b] = offsets[(size_t)c * NB + b];
  __syncwarp();
  const int end = min(N, (c + 1) * kChunk);
  for (int n0 = c * kChunk; n0 < end; n0 += 32) {
    const int n = n0 + lane;
    const bool ok = n < end;
    const int b = ok ? bucket_of(rel[n], NR) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ok) perm[run[b] + rank] = n;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) run[b] += __popc(peers);
    __syncwarp();
  }
}

// y[n] = M x[n] for the rows n of one tile, M = R[r] (TRANS false: the
// forward) or R[r]^T (TRANS true: dv from dy), rounded as the instance says;
// rows of the bucket NR get 0.
template <bool BF, bool TRANS>
__global__ void __launch_bounds__(kThreads)
rel_rows_kernel(const float* __restrict__ x, const float* __restrict__ R, int D, int NR,
                const int* __restrict__ tiles, const int* __restrict__ perm,
                float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* Ms = reinterpret_cast<float*>(smem4);  // [D][D + 1]
  float* xs = Ms + D * (D + 1);                 // [kTR][D]
  const int t = blockIdx.x;
  const int r = tiles[3 * t], p0 = tiles[3 * t + 1], cnt = tiles[3 * t + 2];
  if (cnt == 0) return;
  if (r == NR) {  // rows outside [0, NR): zero
    for (int e = threadIdx.x; e < cnt * D; e += blockDim.x) {
      const int q = e / D, i = e - q * D;
      y[(size_t)perm[p0 + q] * D + i] = 0.0f;
    }
    return;
  }
  const float* Rr = R + (size_t)r * D * D;
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    const int a = e / D, c = e - a * D;  // Rr[a][c]
    const float w = rnd<BF>(Rr[e]);
    if (TRANS) Ms[c * (D + 1) + a] = w;
    else Ms[a * (D + 1) + c] = w;
  }
  for (int e = threadIdx.x; e < kTR * D; e += blockDim.x) {
    const int q = e / D, j = e - q * D;
    xs[e] = q < cnt ? rnd<BF>(x[(size_t)perm[p0 + q] * D + j]) : 0.0f;
  }
  __syncthreads();
  // thread: output column i, row group g of G; rows 4 g .. 4 g + 3, then
  // G 4 further on
  const int G = kThreads / D;
  const int i = threadIdx.x % D, g = threadIdx.x / D;
  if (g >= G) return;
  const float* m = Ms + i * (D + 1);
  for (int q0 = 4 * g; q0 < cnt; q0 += 4 * G) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < D; j += 4) {
      const float w0 = m[j], w1 = m[j + 1], w2 = m[j + 2], w3 = m[j + 3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (q0 + u) * D + j);
        float a = acc[u];
        a = fmaf(w0, xv.x, a);
        a = fmaf(w1, xv.y, a);
        a = fmaf(w2, xv.z, a);
        a = fmaf(w3, xv.w, a);
        acc[u] = a;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q0 + u < cnt) y[(size_t)perm[p0 + q0 + u] * D + i] = rnd<BF>(acc[u]);
  }
}

// partials[t] = sum over the tile's rows of dy[n]^T v[n] ((D, D), operands
// rounded as the instance says), for tiles of a relation
template <bool BF>
__global__ void __launch_bounds__(kThreads)
rel_dr_tile_kernel(const float* __restrict__ v, const float* __restrict__ dy, int D, int NR,
                   const int* __restrict__ tiles, const int* __restrict__ perm,
                   float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);  // [kTR][D]
  float* vs = ds + kTR * D;                     // [kTR][D]
  const int t = blockIdx.x;
  const int r = tiles[3 * t], p0 = tiles[3 * t + 1], cnt = tiles[3 * t + 2];
  if (cnt == 0 || r == NR) return;
  for (int e = threadIdx.x; e < cnt * D; e += blockDim.x) {
    const int q = e / D, j = e - q * D;
    const size_t at = (size_t)perm[p0 + q] * D + j;
    ds[e] = rnd<BF>(dy[at]);
    vs[e] = rnd<BF>(v[at]);
  }
  __syncthreads();
  const int D4 = D / 4;
  float* part = partials + (size_t)t * D * D;
  for (int blk = threadIdx.x; blk < D4 * D4; blk += blockDim.x) {
    const int i0 = (blk / D4) * 4, j0 = (blk % D4) * 4;
    float acc[4][4] = {};
    for (int q = 0; q < cnt; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(ds + q * D + i0);
      const float4 b = *reinterpret_cast<const float4*>(vs + q * D + j0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(part + (size_t)(i0 + u) * D + j0) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
}

// dR[r] = its tiles' partials summed in tile order (0 with no rows). Grid
// (ceil(D D / 256), NR).
__global__ void rel_dr_reduce_kernel(const float* __restrict__ partials,
                                     const int* __restrict__ rel_tiles, int D,
                                     float* __restrict__ dR) {
  const int r = blockIdx.y, e = blockIdx.x * blockDim.x + threadIdx.x, DD = D * D;
  if (e >= DD) return;
  const int t0 = rel_tiles[2 * r], nt = rel_tiles[2 * r + 1];
  float s = 0.0f;
  for (int k = 0; k < nt; ++k) s += partials[(size_t)(t0 + k) * DD + e];
  dR[(size_t)r * DD + e] = s;
}

// ------------------------------------------------------------------- launch

int n_chunks(int N) { return (N + kChunk - 1) / kChunk; }
int max_tiles(int N, int NR) { return (N + kTR - 1) / kTR + NR + 1; }

int valid_shape(int N, int D, int NR) {
  return N >= 1 && NR >= 1 && NR + 1 <= kMaxBuckets && D >= 4 && D % 4 == 0 && D <= kMaxD;
}

size_t rows_smem(int D) { return sizeof(float) * ((size_t)D * (D + 1) + (size_t)kTR * D); }
size_t dr_smem(int D) { return sizeof(float) * 2 * (size_t)kTR * D; }

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the scratch layout (ints): counts and offsets (n_chunks, NB), perm (N),
// tiles (max_tiles, 3), rel_tiles (NB, 2)
struct Buckets {
  int *counts, *offsets, *perm, *tiles, *rel_tiles;
};

Buckets carve(int* scratch, int N, int NR) {
  const size_t cb = (size_t)n_chunks(N) * (NR + 1);
  Buckets k;
  k.counts = scratch;
  k.offsets = k.counts + cb;
  k.perm = k.offsets + cb;
  k.tiles = k.perm + N;
  k.rel_tiles = k.tiles + 3 * (size_t)max_tiles(N, NR);
  return k;
}

int bucket_rows(const int* rel, int N, int NR, const Buckets& k, cudaStream_t s) {
  const int NB = NR + 1, nc = n_chunks(N);
  const size_t cnt_smem = sizeof(int) * NB, scan_smem = sizeof(int) * (2 * NB + 1);
  int err = allow_smem(rel_count_kernel, cnt_smem);
  if (!err) err = allow_smem(rel_scatter_kernel, cnt_smem);
  if (!err) err = allow_smem(rel_scan_kernel, scan_smem);
  if (err) return err;
  rel_count_kernel<<<nc, 32, cnt_smem, s>>>(rel, N, NR, k.counts);
  rel_scan_kernel<<<1, 1024, scan_smem, s>>>(k.counts, nc, NR, max_tiles(N, NR), k.offsets,
                                            k.tiles, k.rel_tiles);
  rel_scatter_kernel<<<nc, 32, cnt_smem, s>>>(rel, N, NR, k.offsets, k.perm);
  return (int)cudaGetLastError();
}

template <bool BF, bool TRANS>
int launch_rows(const float* x, const float* R, int N, int D, int NR, const Buckets& k,
                float* y, cudaStream_t s) {
  const size_t smem = rows_smem(D);
  int err = allow_smem(rel_rows_kernel<BF, TRANS>, smem);
  if (err) return err;
  rel_rows_kernel<BF, TRANS><<<max_tiles(N, NR), kThreads, smem, s>>>(x, R, D, NR, k.tiles,
                                                                     k.perm, y);
  return (int)cudaGetLastError();
}

template <bool BF>
int launch_bwd(const float* v, const float* R, const float* dy, int N, int D, int NR,
               const Buckets& k, float* dv, float* partials, float* dR, cudaStream_t s) {
  int err = launch_rows<BF, true>(dy, R, N, D, NR, k, dv, s);
  if (err) return err;
  const size_t smem = dr_smem(D);
  err = allow_smem(rel_dr_tile_kernel<BF>, smem);
  if (err) return err;
  rel_dr_tile_kernel<BF><<<max_tiles(N, NR), kThreads, smem, s>>>(v, dy, D, NR, k.tiles,
                                                                 k.perm, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((D * D + 255) / 256, NR);
  rel_dr_reduce_kernel<<<grid, 256, 0, s>>>(partials, k.rel_tiles, D, dR);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest D and the most relations (NR) the kernels take.
extern "C" int rel_apply_max_width() { return kMaxD; }
extern "C" int rel_apply_max_relations() { return kMaxBuckets - 1; }

// Ints of bucketing scratch, and floats of the backward's dR partials, for
// (N, NR) (and D); -1 for a shape the kernels do not take.
extern "C" long long rel_apply_scratch_ints(int N, int D, int NR) {
  if (!valid_shape(N, D, NR)) return -1;
  return 2LL * n_chunks(N) * (NR + 1) + N + 3LL * max_tiles(N, NR) + 2LL * (NR + 1);
}

extern "C" long long rel_apply_partial_floats(int N, int D, int NR) {
  if (!valid_shape(N, D, NR)) return -1;
  return (long long)max_tiles(N, NR) * D * D;
}

// v (N, D), R (NR, D, D), y (N, D) f32 and rel (N,) int32, contiguous;
// scratch rel_apply_scratch_ints ints. Returns the CUDA error code.
extern "C" int rel_apply_fwd(const float* v, const int* rel, const float* R, int N, int D,
                             int NR, int bf16, int* scratch, float* y, void* stream) {
  if (!valid_shape(N, D, NR)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buckets k = carve(scratch, N, NR);
  int err = bucket_rows(rel, N, NR, k, s);
  if (err) return err;
  return bf16 ? launch_rows<true, false>(v, R, N, D, NR, k, y, s)
              : launch_rows<false, false>(v, R, N, D, NR, k, y, s);
}

// As rel_apply_fwd, with dy (N, D) in and dv (N, D), dR (NR, D, D) out;
// partials rel_apply_partial_floats f32 of scratch.
extern "C" int rel_apply_bwd(const float* v, const int* rel, const float* R, const float* dy,
                             int N, int D, int NR, int bf16, int* scratch, float* partials,
                             float* dv, float* dR, void* stream) {
  if (!valid_shape(N, D, NR)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buckets k = carve(scratch, N, NR);
  int err = bucket_rows(rel, N, NR, k, s);
  if (err) return err;
  return bf16 ? launch_bwd<true>(v, R, dy, N, D, NR, k, dv, partials, dR, s)
              : launch_bwd<false>(v, R, dy, N, D, NR, k, dv, partials, dR, s);
}
