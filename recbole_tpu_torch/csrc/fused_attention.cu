// Multi-head attention alone (mask, softmax, dropout, the two products),
// forward and backward, for Hopper, in fp32, tiled over the keys.
//
// Replaces: recbole_tpu/ops/fused_attention.py::fused_attention (:204;
// Pallas kernels _fwd_kernel :78 and _bwd_kernel :95), the kernel behind
// the JAX package's fused_attention: True (models/layers.py:390-423). Per
// sequence b and head h, on q, k, v (B, L, H, hd) f32 (the natural reshape
// of a (B, L, D) projection):
//   S = q k^T scale, -1e9 where key j is not valid or (causal) j > i;
//   P = softmax(S);  Pd = P keep / (1 - rate);  o = Pd v.
// A query row with no valid key comes out uniform over the L keys, as in the
// reference. The backward recomputes P, regenerates the keep mask, and writes
//   dp = (dO v^T) keep / (1 - rate);  dS = P (dp - t) scale, t = rowsum(dp P)
//   = dO . o, 0 where the mask holds;  dq = dS k;  dk = dS^T q;  dv = Pd^T dO.
// The mask is a select (attention_xla :224), so a masked score has no
// gradient; the JAX kernel adds -1e9 and its backward passes a cotangent to
// the masked scores of a row with no valid key (it differs only there).
// The JAX kernel builds a key-only mask in the bidirectional case (its
// _build_mask :39-47 and attention_xla :224), and so does this one.
//
// What bounds it on the H100 (SASRec's step: B = 2048, H = 2, L = 50,
// hd = 32): bytes. The forward moves q, k, v in and o out (104.9 MB,
// 0.031 ms at 3.35 TB/s) for 1.31 GFLOP; the backward q, k, v, dO in and dq,
// dk, dv out (183.5 MB, 0.055 ms) for 3.28 GFLOP, both far below the fp32
// rate's time. Design: tiles of kT = 32 queries and 32 keys, so that shared
// memory holds tiles only and any L runs (head widths up to kMaxHd = 128).
// The forward takes a block of 128 threads per (sequence, head, query tile)
// and streams the key tiles with an online softmax (running row max m and
// row sum l, the accumulator rescaled when m grows), then writes o and the
// rows' m and l. The backward recomputes each score tile from q, k and the
// saved m and l (P = exp(s - m) / l; m and l are kept apart because
// -1e9 + log l rounds back to -1e9 in fp32): one kernel per (sequence, head,
// query tile) writes dq and t = dO . o over the key tiles, then one per
// (sequence, head, key tile) writes dk and dv over the query tiles. Every
// output element is written by one block, so nothing is summed across
// blocks and the kernels need no atomics: two runs give the same bits.
// Causal: a key tile entirely after a query tile is skipped for rows that
// have a valid key (masked_tile), which leaves every result bit unchanged.
// Tile rows are padded by one float so that reads along keys are free of
// bank conflicts. Keys beyond L take no part (an exact zero weight), unlike
// masked keys, which keep the -1e9 score and its reference semantics.
//
// Dropout: Philox4x32-10 keyed by the seed (one int64 drawn on the device
// from the caller's generator) and counted by (element / 4, sequence, head,
// layer) with element = i L + j, the scheme of csrc/trm_layer.cu (its
// attention sites): the same bits in the forward and the backward, whatever
// block or tile draws them. The Philox rounds below are a copy of that
// source's. fused_attention_dropout_masks writes the keep masks out for the
// plain version.
//
// Limits: head width hd <= kMaxHd; any B, L and H (B H blocks on the grid's
// x axis).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;          // queries and keys of a tile (one key a lane)
constexpr int kTS = kT + 1;     // the row stride of a score tile
constexpr int kMaxHd = 128;
constexpr float kNeg = -1e9f;

struct U4 {
  unsigned v[4];
};

__device__ __forceinline__ U4 philox4x32_10(unsigned c0, unsigned c1, unsigned c2, unsigned c3,
                                            unsigned k0, unsigned k1) {
  const unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u, W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const unsigned hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  U4 out;
  out.v[0] = c0;
  out.v[1] = c1;
  out.v[2] = c2;
  out.v[3] = c3;
  return out;
}

__host__ __device__ inline unsigned keep_threshold(float rate) {
  const double t = (double)rate * 4294967296.0;
  return t >= 4294967295.0 ? 4294967295u : (unsigned)t;
}

struct Drop {
  unsigned k0, k1, thr, layer;
  float inv;
  bool on;
  // keep (1) or drop (0) element e of (sequence b, head h)
  __device__ __forceinline__ bool keep(int e, int b, int h) const {
    const U4 bits = philox4x32_10((unsigned)(e >> 2), (unsigned)b, (unsigned)h, layer, k0, k1);
    return bits.v[e & 3] >= thr;
  }
};

__device__ Drop make_drop(const long long* seed, float rate, int layer) {
  Drop d;
  d.on = rate > 0.0f && seed != nullptr;
  const unsigned long long s = d.on ? (unsigned long long)*seed : 0ull;
  d.k0 = (unsigned)s;
  d.k1 = (unsigned)(s >> 32);
  d.thr = keep_threshold(rate);
  d.layer = (unsigned)layer;
  d.inv = 1.0f / (1.0f - rate);
  return d;
}

struct Shape {
  int B, L, H, hd, causal, layer;
  float scale, rate;
};

// rows r0 .. r0 + kT - 1 of the (L, hd) slice of (sequence b, head h) of a
// (B, L, H, hd) tensor into shared memory rows of hd + 1 floats; rows past
// L are zero
__device__ void load_tile(float* dst, const float* __restrict__ src, const Shape& sh, int b,
                          int h, int r0) {
  const int hd = sh.hd;
  for (int i = threadIdx.x; i < kT * hd; i += blockDim.x) {
    const int l = i / hd, d = i - l * hd, row = r0 + l;
    dst[l * (hd + 1) + d] =
        row < sh.L ? src[(((size_t)b * sh.L + row) * sh.H + h) * hd + d] : 0.0f;
  }
}

__device__ __forceinline__ size_t slice_at(const Shape& sh, int b, int h, int l, int d) {
  return (((size_t)b * sh.L + l) * sh.H + h) * sh.hd + d;
}

// S[i][j] = q_i . k_j scale for query i0 + i and key j0 + j: -1e9 where the
// key is masked for that query, -inf where the query or the key lies past L
__device__ void score_tile(float* S, const float* qs, const float* ks, const int* valid,
                           const Shape& sh, int i0, int j0) {
  const int hd = sh.hd, LD = hd + 1;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) {
    const int i = e / kT, j = e - i * kT, qi = i0 + i, kj = j0 + j;
    float s = -INFINITY;
    if (qi < sh.L && kj < sh.L) {
      s = kNeg;
      if (valid[kj] > 0 && (!sh.causal || kj <= qi)) {
        float a = 0.0f;
        for (int d = 0; d < hd; ++d) a = fmaf(qs[i * LD + d], ks[j * LD + d], a);
        s = a * sh.scale;
      }
    }
    S[i * kTS + j] = s;
  }
}

// G[i][j] = a_i . b_j over the tiles' hd columns
__device__ void dot_tile(float* G, const float* as, const float* bs, int hd) {
  const int LD = hd + 1;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) {
    const int i = e / kT, j = e - i * kT;
    float a = 0.0f;
    for (int d = 0; d < hd; ++d) a = fmaf(as[i * LD + d], bs[j * LD + d], a);
    G[i * kTS + j] = a;
  }
}

__device__ __forceinline__ bool visible(const int* valid, const Shape& sh, int qi, int kj) {
  return valid[kj] > 0 && (!sh.causal || kj <= qi);
}

// Causal: every key of the tile at j0 lies after every query of the tile at
// i0, so all its scores are -1e9. A row that has seen a real score (max m
// above -1e9) gives them the weight exp(-1e9 - m) = 0 exactly, so the tile
// changes nothing and is skipped; a row with no valid key at all keeps it
// (its softmax is uniform over all L keys). ``m_row(i)`` is row i0 + i's max
// score. Called by every thread of the block (a barrier).
template <typename M>
__device__ __forceinline__ bool masked_tile(const Shape& sh, int i0, int j0, M m_row) {
  if (!sh.causal || j0 < i0 + kT) return false;
  const int i = threadIdx.x;
  return __syncthreads_and(i >= kT || i0 + i >= sh.L || m_row(i) > kNeg);
}

__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ key_valid,
                           const long long* __restrict__ seed, Shape sh, float* __restrict__ o,
                           float* __restrict__ stats) {
  extern __shared__ float smem[];
  const int L = sh.L, hd = sh.hd, LD = hd + 1;
  float* qs = smem;
  float* ks = qs + kT * LD;
  float* vs = ks + kT * LD;
  float* acc = vs + kT * LD;
  float* S = acc + kT * LD;
  float* m = S + kT * kTS;
  float* l = m + kT;
  float* corr = l + kT;
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, i0 = blockIdx.y * kT;
  const int* valid = key_valid + (size_t)b * L;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  load_tile(qs, q, sh, b, h, i0);
  for (int e = threadIdx.x; e < kT * LD; e += blockDim.x) acc[e] = 0.0f;
  for (int i = threadIdx.x; i < kT; i += blockDim.x) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  for (int j0 = 0; j0 < L; j0 += kT) {
    if (masked_tile(sh, i0, j0, [&](int i) { return m[i]; })) break;  // and every later tile
    load_tile(ks, k, sh, b, h, j0);
    load_tile(vs, v, sh, b, h, j0);
    __syncthreads();
    score_tile(S, qs, ks, valid, sh, i0, j0);
    __syncthreads();
    // the online softmax, one warp a row, one key a lane
    for (int i = warp; i < kT; i += kWarps) {
      const float s = S[i * kTS + lane];
      float mt = s;
      for (int w = 16; w; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_old = m[i], m_new = fmaxf(m_old, mt);
      float p = m_new == -INFINITY ? 0.0f : expf(s - m_new);
      float sum = p;
      for (int w = 16; w; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (drop.on && i0 + i < L && j0 + lane < L)
        p = drop.keep((i0 + i) * L + j0 + lane, b, h) ? p * drop.inv : 0.0f;
      S[i * kTS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        corr[i] = c;
        l[i] = l[i] * c + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kT * hd; e += blockDim.x) {
      const int i = e / hd, d = e - i * hd;
      float a = acc[i * LD + d] * corr[i];
      for (int j = 0; j < kT; ++j) a = fmaf(S[i * kTS + j], vs[j * LD + d], a);
      acc[i * LD + d] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kT * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;
    if (i0 + i < L) o[slice_at(sh, b, h, i0 + i, d)] = acc[i * LD + d] / l[i];
  }
  const size_t row0 = ((size_t)b * sh.H + h) * L;
  for (int i = threadIdx.x; i < kT; i += blockDim.x)
    if (i0 + i < L) {
      stats[2 * (row0 + i0 + i)] = m[i];
      stats[2 * (row0 + i0 + i) + 1] = l[i];
    }
}

// P and dS of one (query tile, key tile) pair: P (dropped: Pd) into Pt and
// dS into G, which holds dO . v on entry. ms, ls, ts: the query rows' m, l
// and t = dO . o.
__device__ void prob_grad_tile(float* Pt, float* G, const float* ms, const float* ls,
                               const float* ts, const int* valid, const Shape& sh,
                               const Drop& drop, int b, int h, int i0, int j0) {
  const int L = sh.L;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) {
    const int i = e / kT, j = e - i * kT, qi = i0 + i, kj = j0 + j;
    float p = 0.0f, ds = 0.0f;
    if (qi < L && kj < L) {
      p = expf(Pt[i * kTS + j] - ms[i]) / ls[i];
      const bool keep = !drop.on || drop.keep(qi * L + kj, b, h);
      const float dp = keep ? G[i * kTS + j] * (drop.on ? drop.inv : 1.0f) : 0.0f;
      if (visible(valid, sh, qi, kj)) ds = p * (dp - ts[i]) * sh.scale;
      p = keep ? p * (drop.on ? drop.inv : 1.0f) : 0.0f;
    }
    Pt[i * kTS + j] = p;
    G[i * kTS + j] = ds;
  }
}

// the query rows' m, l (from the forward) and t = dO . o, for rows i0 ..
__device__ void load_row_stats(float* ms, float* ls, float* ts, const float* __restrict__ stats,
                               const float* __restrict__ o, const float* dos, const Shape& sh,
                               int b, int h, int i0) {
  const int hd = sh.hd, LD = hd + 1;
  const size_t row0 = ((size_t)b * sh.H + h) * sh.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < kT; i += kWarps) {
    const int qi = i0 + i;
    float t = 0.0f;
    if (qi < sh.L)
      for (int d = lane; d < hd; d += 32)
        t = fmaf(dos[i * LD + d], o[slice_at(sh, b, h, qi, d)], t);
    for (int w = 16; w; w >>= 1) t += __shfl_xor_sync(0xffffffffu, t, w);
    if (lane == 0) {
      ts[i] = t;
      ms[i] = qi < sh.L ? stats[2 * (row0 + qi)] : 0.0f;
      ls[i] = qi < sh.L ? stats[2 * (row0 + qi) + 1] : 1.0f;
    }
  }
}

// dq of one (sequence, head, query tile), over the key tiles
__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ key_valid,
                              const long long* __restrict__ seed, Shape sh,
                              const float* __restrict__ o, const float* __restrict__ stats,
                              const float* __restrict__ dout, float* __restrict__ dq) {
  extern __shared__ float smem[];
  const int L = sh.L, hd = sh.hd, LD = hd + 1;
  float* qs = smem;
  float* dos = qs + kT * LD;
  float* ks = dos + kT * LD;
  float* vs = ks + kT * LD;
  float* acc = vs + kT * LD;
  float* Pt = acc + kT * LD;
  float* G = Pt + kT * kTS;
  float* ms = G + kT * kTS;
  float* ls = ms + kT;
  float* ts = ls + kT;
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, i0 = blockIdx.y * kT;
  const int* valid = key_valid + (size_t)b * L;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  load_tile(qs, q, sh, b, h, i0);
  load_tile(dos, dout, sh, b, h, i0);
  for (int e = threadIdx.x; e < kT * LD; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();
  load_row_stats(ms, ls, ts, stats, o, dos, sh, b, h, i0);
  const size_t row0 = ((size_t)b * sh.H + h) * L;
  for (int j0 = 0; j0 < L; j0 += kT) {
    if (masked_tile(sh, i0, j0, [&](int i) { return stats[2 * (row0 + i0 + i)]; })) break;
    load_tile(ks, k, sh, b, h, j0);
    load_tile(vs, v, sh, b, h, j0);
    __syncthreads();
    score_tile(Pt, qs, ks, valid, sh, i0, j0);
    dot_tile(G, dos, vs, hd);
    __syncthreads();
    prob_grad_tile(Pt, G, ms, ls, ts, valid, sh, drop, b, h, i0, j0);
    __syncthreads();
    for (int e = threadIdx.x; e < kT * hd; e += blockDim.x) {
      const int i = e / hd, d = e - i * hd;
      float a = acc[i * LD + d];
      for (int j = 0; j < kT; ++j) a = fmaf(G[i * kTS + j], ks[j * LD + d], a);
      acc[i * LD + d] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kT * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;
    if (i0 + i < L) dq[slice_at(sh, b, h, i0 + i, d)] = acc[i * LD + d];
  }
}

// dk and dv of one (sequence, head, key tile), over the query tiles
__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const int* __restrict__ key_valid,
                                const long long* __restrict__ seed, Shape sh,
                                const float* __restrict__ o, const float* __restrict__ stats,
                                const float* __restrict__ dout, float* __restrict__ dk,
                                float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int L = sh.L, hd = sh.hd, LD = hd + 1;
  float* ks = smem;
  float* vs = ks + kT * LD;
  float* qs = vs + kT * LD;
  float* dos = qs + kT * LD;
  float* dka = dos + kT * LD;
  float* dva = dka + kT * LD;
  float* Pt = dva + kT * LD;
  float* G = Pt + kT * kTS;
  float* ms = G + kT * kTS;
  float* ls = ms + kT;
  float* ts = ls + kT;
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, j0 = blockIdx.y * kT;
  const int* valid = key_valid + (size_t)b * L;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  load_tile(ks, k, sh, b, h, j0);
  load_tile(vs, v, sh, b, h, j0);
  for (int e = threadIdx.x; e < kT * LD; e += blockDim.x) dka[e] = dva[e] = 0.0f;
  const size_t row0 = ((size_t)b * sh.H + h) * L;
  for (int i0 = 0; i0 < L; i0 += kT) {
    if (masked_tile(sh, i0, j0, [&](int i) { return stats[2 * (row0 + i0 + i)]; })) continue;
    load_tile(qs, q, sh, b, h, i0);
    load_tile(dos, dout, sh, b, h, i0);
    __syncthreads();
    load_row_stats(ms, ls, ts, stats, o, dos, sh, b, h, i0);
    score_tile(Pt, qs, ks, valid, sh, i0, j0);
    dot_tile(G, dos, vs, hd);
    __syncthreads();
    prob_grad_tile(Pt, G, ms, ls, ts, valid, sh, drop, b, h, i0, j0);
    __syncthreads();
    // the key rows j: dk_j += sum_i dS_ij q_i, dv_j += sum_i Pd_ij dO_i
    for (int e = threadIdx.x; e < kT * hd; e += blockDim.x) {
      const int j = e / hd, d = e - j * hd;
      float ak = dka[j * LD + d], av = dva[j * LD + d];
      for (int i = 0; i < kT; ++i) {
        ak = fmaf(G[i * kTS + j], qs[i * LD + d], ak);
        av = fmaf(Pt[i * kTS + j], dos[i * LD + d], av);
      }
      dka[j * LD + d] = ak;
      dva[j * LD + d] = av;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kT * hd; e += blockDim.x) {
    const int j = e / hd, d = e - j * hd;
    if (j0 + j < L) {
      const size_t at = slice_at(sh, b, h, j0 + j, d);
      dk[at] = dka[j * LD + d];
      dv[at] = dva[j * LD + d];
    }
  }
}

// the keep masks of one (seed, layer), (B, H, L, L), as 0 or 1 / (1 - rate)
__global__ void dropout_masks_kernel(const long long* __restrict__ seed, Shape sh,
                                     float* __restrict__ masks) {
  const Drop drop = make_drop(seed, sh.rate, sh.layer);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, LL = sh.L * sh.L;
  for (int e = threadIdx.x; e < LL; e += blockDim.x)
    masks[(size_t)blockIdx.x * LL + e] = drop.keep(e, b, h) ? drop.inv : 0.0f;
}

// shared-memory floats of the forward, the dq and the dk-dv kernels
size_t fwd_floats(int hd) { return (size_t)4 * kT * (hd + 1) + kT * kTS + 3 * kT; }
size_t dq_floats(int hd) { return (size_t)5 * kT * (hd + 1) + 2 * kT * kTS + 3 * kT; }
size_t dkdv_floats(int hd) { return (size_t)6 * kT * (hd + 1) + 2 * kT * kTS + 3 * kT; }

size_t smem_bytes(int hd, bool backward) {
  return sizeof(float) * (backward ? dkdv_floats(hd) : fwd_floats(hd));
}

int make_shape(int B, int L, int H, int hd, int causal, float scale, float rate, int layer,
               Shape* sh) {
  if (B < 1 || L < 1 || H < 1 || hd < 1 || hd > kMaxHd || rate < 0.0f || rate >= 1.0f ||
      (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  sh->B = B; sh->L = L; sh->H = H; sh->hd = hd; sh->causal = causal; sh->layer = layer;
  sh->scale = scale; sh->rate = rate;
  return 0;
}

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

}  // namespace

// Shared-memory bytes a block needs at head width hd, forward or backward
// (the larger of the backward's two kernels); the widest head the kernels
// take.
extern "C" long long fused_attention_smem_bytes(int hd, int backward) {
  return (long long)smem_bytes(hd, backward != 0);
}
extern "C" int fused_attention_max_head_width() { return kMaxHd; }

// q, k, v, o (B, L, H, hd) f32 contiguous; key_valid (B, L) int32 (> 0: a
// real key); seed one int64 on the device (null when rate is 0); stats
// (B, H, L, 2) f32 out: each query row's max score and softmax sum, for the
// backward. Returns the CUDA error code.
extern "C" int fused_attention_fwd(const float* q, const float* k, const float* v,
                                   const int* key_valid, const void* seed, int B, int L, int H,
                                   int hd, int causal, float scale, float rate, int layer,
                                   float* o, float* stats, void* stream) {
  Shape sh;
  int err = make_shape(B, L, H, hd, causal, scale, rate, layer, &sh);
  if (err) return err;
  if (rate > 0.0f && !seed) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * fwd_floats(hd);
  err = allow_smem(fused_attention_fwd_kernel, smem);
  if (err) return err;
  const dim3 grid(B * H, (L + kT - 1) / kT);
  fused_attention_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_valid, static_cast<const long long*>(seed), sh, o, stats);
  return (int)cudaGetLastError();
}

// As fused_attention_fwd, with the forward's o and stats and dout in, and
// dq, dk, dv (B, L, H, hd) out: the dq kernel, then the dk-dv kernel.
extern "C" int fused_attention_bwd(const float* q, const float* k, const float* v,
                                   const int* key_valid, const void* seed, int B, int L, int H,
                                   int hd, int causal, float scale, float rate, int layer,
                                   const float* o, const float* stats, const float* dout,
                                   float* dq, float* dk, float* dv, void* stream) {
  Shape sh;
  int err = make_shape(B, L, H, hd, causal, scale, rate, layer, &sh);
  if (err) return err;
  if (rate > 0.0f && !seed) return (int)cudaErrorInvalidValue;
  const size_t smem_dq = sizeof(float) * dq_floats(hd), smem_kv = sizeof(float) * dkdv_floats(hd);
  err = allow_smem(fused_attention_bwd_dq_kernel, smem_dq);
  if (!err) err = allow_smem(fused_attention_bwd_dkdv_kernel, smem_kv);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  const dim3 grid(B * H, (L + kT - 1) / kT);
  fused_attention_bwd_dq_kernel<<<grid, kThreads, smem_dq, s>>>(q, k, v, key_valid, sd, sh, o,
                                                                stats, dout, dq);
  err = (int)cudaGetLastError();
  if (err) return err;
  fused_attention_bwd_dkdv_kernel<<<grid, kThreads, smem_kv, s>>>(q, k, v, key_valid, sd, sh, o,
                                                                  stats, dout, dk, dv);
  return (int)cudaGetLastError();
}

// The keep masks the two kernels draw for (seed, layer): (B, H, L, L) f32,
// each element 0 or 1 / (1 - rate).
extern "C" int fused_attention_dropout_masks(const void* seed, int B, int H, int L, float rate,
                                             int layer, float* masks, void* stream) {
  Shape sh;
  int err = make_shape(B, L, H, 1, 0, 1.0f, rate, layer, &sh);
  if (err) return err;
  if (!seed) return (int)cudaErrorInvalidValue;
  dropout_masks_kernel<<<B * H, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), sh, masks);
  return (int)cudaGetLastError();
}
