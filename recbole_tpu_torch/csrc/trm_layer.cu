// One post-LN transformer layer, forward and backward, in one kernel each,
// for Hopper.
//
// Replaces: recbole_tpu/ops/trm_layer.py::fused_transformer_layer2 (bf16
// operands; kernel bodies _forward_core :184-225 and _bwd_kernel :243-320)
// and recbole_tpu/ops/fused_transformer.py::fused_transformer_layer (the same
// layer with fp32 operands). Both are instances of the kernels below: the
// template flag BF rounds both operands of every product to bfloat16 (the
// products are then exact in fp32 and are summed in fp32), or leaves them
// fp32. The layer:
//   q, k, v = x W + b;  per head: P = dropout(softmax(q k^T / sqrt(hd) + mask));
//   ctx = P v;  a1 = LN1(x + dropout(ctx Wo + bo));
//   y = LN2(a1 + dropout(act(a1 W1 + b1) W2 + b2)).
// The backward recomputes the forward from x, regenerates the dropout masks,
// and returns dx and the 16 parameter gradients.
//
// What bounds it on the H100 (SASRec at the ml-1m shape: B = 2048, L = 50,
// D = 64, H = 2, I = 256): the forward is 11.4 GFLOP against 52 MB of x in
// and y out, the backward about 34 GFLOP against 79 MB, so both are bound by
// operations (0.17 ms and 0.51 ms at the 67 TFLOP/s fp32 rate these FMA
// kernels can reach at best; the bf16 instance could go to the tensor cores,
// which this first version does not use).
//
// Design. One block owns one sequence at a time and walks over sequences
// blockIdx.x, blockIdx.x + gridDim.x, ...; everything of a sequence, the
// (L, D) activations, one (L, IC) chunk of the FFN and the (L, L) scores of
// one head, lives in shared memory, so device memory sees x, y (dy, dx) and
// the weights only. The Pallas grid runs in order and sums the parameter
// gradients into one output; blocks here run in no order, so each block adds
// into a private (P,) partial in device memory that only it touches, and a
// second kernel sums the partials in block order: no float atomics, the
// result is the same bits on every run with the same grid. The FFN is
// walked in chunks of IC inner columns (forward and backward alike), which
// keeps the backward's working set under the 227 KB a block may use. Every
// product is a register-tiled (2 x 4 or 4 x 4 outputs per thread) loop of
// fp32 FMAs
// whose operands are rounded as they are loaded (shared memory) or were
// rounded once by prep_weights_kernel (the weight matrices, which it also
// transposes for the backward's products against W^T, so that a warp's loads
// of a weight matrix are always coalesced). Dropout masks
// come from Philox4x32-10 keyed by the seed, counted by (element / 4,
// sequence, site, layer), so a mask does not depend on the block that draws
// it and forward and backward draw the same bits; trm_dropout_masks writes
// the same masks out for the plain version. Heads contract over their own hd
// lanes only. The mask is additive -1e9 after the scale, so a fully masked
// row gives the uniform softmax the reference gives.
//
// Limits: D, D / H and I multiples of 4; the working set (see smem_floats)
// within the card's opt-in shared memory. Any B and L within that.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// Measured on an H100 at SASRec's shape against 256 threads with 4-row tiles
// and 384 threads with 2- and 4-row tiles: 512 threads with 2-row tiles keep
// the backward at 128 registers and were fastest (backward 4.9 against 6.0 ms).
constexpr int kThreads = 512;
constexpr int kTR = 2;            // rows of a thread's output tile (its columns: 4)
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;       // FFN inner columns per chunk
constexpr int kPad = 4;           // floats added to every shared-memory row
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNumParams = 16;

enum Param { WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, FF1W, FF1B, FF2W, FF2B, LN2G, LN2B };
enum Act { GELU, RELU, SWISH, TANH, SIGMOID };

struct Params {
  const float* p[kNumParams];
};

struct Shape {
  int B, L, D, H, I, hd, IC, LD, LC, LS;
  int causal, act;
  float eps, scale;
  float attn_rate, rate;
  int layer;
};

// offsets of the 16 gradients in a (P,) partial, in Param order
struct Offsets {
  int o[kNumParams + 1];
};

__host__ __device__ inline Offsets grad_offsets(int D, int I) {
  Offsets f;
  const int sizes[kNumParams] = {D * D, D, D * D, D, D * D, D, D * D, D, D, D,
                                 D * I, I, I * D, D, D, D};
  f.o[0] = 0;
  for (int i = 0; i < kNumParams; ++i) f.o[i + 1] = f.o[i] + sizes[i];
  return f;
}

// shared-memory floats of one block: 7 (forward) or 9 (backward) (L, D)
// buffers, 1 or 2 FFN chunks, 1 or 2 score matrices, 2 (L,) vectors of
// inverse deviations, and L ints of key validity
inline size_t smem_floats(int L, int D, int I, bool backward) {
  const int IC = I < kChunk ? I : kChunk;
  const int LS = ((L + 3) / 4) * 4 + kPad;
  const size_t ld = (size_t)L * (D + kPad), lc = (size_t)L * (IC + kPad), ls = (size_t)L * LS;
  return backward ? 9 * ld + 2 * lc + 2 * ls + 3 * (size_t)L
                  : 7 * ld + lc + ls + 3 * (size_t)L;
}

// ------------------------------------------------------------------ rounding

template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if (BF) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool BF>
__device__ __forceinline__ float4 rnd4(float4 v) {
  if (BF) {
    v.x = rnd<true>(v.x);
    v.y = rnd<true>(v.y);
    v.z = rnd<true>(v.z);
    v.w = rnd<true>(v.w);
  }
  return v;
}

// The six weight matrices made ready for the products in one launch: a copy
// rounded to bf16 (when ``rounded`` is given) and a transposed copy, rounded
// too in the bf16 instance (when ``transposed`` is given). Matrix m fills
// elements start[m] .. start[m + 1] of either output.
constexpr int kNumMats = 6;

struct PrepJob {
  const float* in[kNumMats];
  int rows[kNumMats], cols[kNumMats], start[kNumMats + 1];
};

template <bool BF>
__global__ void prep_weights_kernel(PrepJob job, float* __restrict__ rounded,
                                    float* __restrict__ transposed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= job.start[kNumMats]) return;
  int m = 0;
  while (i >= job.start[m + 1]) ++m;
  const int j = i - job.start[m], rows = job.rows[m], cols = job.cols[m];
  const float v = rnd<BF>(job.in[m][j]);
  if (rounded) rounded[i] = v;
  if (transposed) {
    const int r = j / cols, c = j - r * cols;
    transposed[job.start[m] + (size_t)c * rows + r] = v;
  }
}

// -------------------------------------------------------------------- Philox

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

// dst[r][c] = src[r][c] * keep(r * cols + c), keep = bits >= threshold ?
// 1 / (1 - rate) : 0; the element's bits are word (e & 3) of the Philox
// block counted by (e >> 2, sequence, site, layer). src may be null (the
// mask itself is written), and may equal dst.
__device__ void apply_keep(float* dst, const float* src, int ld_dst, int ld_src, int rows,
                           int cols, float rate, unsigned seq, unsigned site, unsigned layer,
                           unsigned k0, unsigned k1) {
  const unsigned thr = keep_threshold(rate);
  const float inv = 1.0f / (1.0f - rate);
  const int n = rows * cols;
  for (int g = threadIdx.x; g * 4 < n; g += blockDim.x) {
    const U4 bits = philox4x32_10((unsigned)g, seq, site, layer, k0, k1);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = g * 4 + u;
      if (e < n) {
        const int r = e / cols, c = e - r * cols;
        const float m = bits.v[u] >= thr ? inv : 0.0f;
        dst[r * ld_dst + c] = src ? src[r * ld_src + c] * m : m;
      }
    }
  }
}

// ---------------------------------------------------------------- epilogues
// Each product hands its 4 x 4 register tile to an epilogue, one element at
// a time: out(l, n, acc).

struct StoreBias {  // dst[l][n] = acc + bias[n]
  float* dst;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(int l, int n, float acc) const {
    dst[l * ld + n] = acc + bias[n];
  }
};

struct Store {  // dst[l][n] = acc
  float* dst;
  int ld;
  __device__ __forceinline__ void operator()(int l, int n, float acc) const {
    dst[l * ld + n] = acc;
  }
};

struct Add {  // dst[l][n] += acc (shared or device memory, one owner per element)
  float* dst;
  int ld;
  __device__ __forceinline__ void operator()(int l, int n, float acc) const {
    dst[l * ld + n] += acc;
  }
};

struct Score {  // dst[i][j] = acc * scale + (key j visible from query i ? 0 : -1e9)
  float* dst;
  int ld;
  const int* valid;
  float scale;
  int causal;
  __device__ __forceinline__ void operator()(int i, int j, float acc) const {
    const bool ok = valid[j] > 0 && (causal ? j <= i : valid[i] > 0);
    dst[i * ld + j] = acc * scale + (ok ? 0.0f : kNeg);
  }
};

// ----------------------------------------------------------------- products

// out(l, n) = sum_k A[l][k] * W[k][n]: A (rows, K) in shared memory (rows 16
// bytes aligned), rounded as it is read; W (K, N) with row stride ldw, N a
// multiple of 4, in device memory (already rounded, RW false) or shared
// memory (RW true). A warp's threads share their rows of A and read
// neighbouring columns of W, so every load is a broadcast or coalesced; the
// products against a transposed weight matrix come here too, with the
// transposed copy prep_weights_kernel makes.
template <bool BF, bool RW, typename Epi>
__device__ void mm_xw(const float* A, int lda, const float* W, int ldw, int rows, int K, int N,
                      Epi epi) {
  const int ncg = N >> 2, nrg = (rows + kTR - 1) / kTR;
  for (int t = threadIdx.x; t < ncg * nrg; t += blockDim.x) {
    const int rg = t / ncg, cg = t - rg * ncg;
    const int l0 = rg * kTR, n0 = cg * 4;
    const float* a[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) a[r] = A + min(l0 + r, rows - 1) * lda;
    float acc[kTR][4] = {};
    const float* w = W + n0;
    int k = 0;
    // four k at a time: one 16-byte load of A per row feeds 16 FMAs
#pragma unroll 2
    for (; k + 4 <= K; k += 4) {
      float4 av[kTR], wv[4];
#pragma unroll
      for (int r = 0; r < kTR; ++r) av[r] = rnd4<BF>(*reinterpret_cast<const float4*>(a[r] + k));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = rnd4<BF && RW>(*reinterpret_cast<const float4*>(w + (size_t)(k + j) * ldw));
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float ak[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][0] = fmaf(ak[j], wv[j].x, acc[r][0]);
          acc[r][1] = fmaf(ak[j], wv[j].y, acc[r][1]);
          acc[r][2] = fmaf(ak[j], wv[j].z, acc[r][2]);
          acc[r][3] = fmaf(ak[j], wv[j].w, acc[r][3]);
        }
      }
    }
    for (; k < K; ++k) {   // the tail of a K that is no multiple of 4 (K = L)
      const float4 wv = rnd4<BF && RW>(*reinterpret_cast<const float4*>(w + (size_t)k * ldw));
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float av = rnd<BF>(a[r][k]);
        acc[r][0] = fmaf(av, wv.x, acc[r][0]);
        acc[r][1] = fmaf(av, wv.y, acc[r][1]);
        acc[r][2] = fmaf(av, wv.z, acc[r][2]);
        acc[r][3] = fmaf(av, wv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
      if (l0 + r < rows) {
#pragma unroll
        for (int c = 0; c < 4; ++c) epi(l0 + r, n0 + c, acc[r][c]);
      }
  }
}

// out(l, n) = sum_k A[l][k] * W[n][k]: A (rows, K) and W (N, K) with row
// stride ldw, both in shared memory (the attention products q k^T and
// do v^T); K a multiple of 4, any N.
template <bool BF, typename Epi>
__device__ void mm_xwt(const float* A, int lda, const float* W, int ldw, int rows, int K, int N,
                       Epi epi) {
  const int ncg = (N + 3) >> 2, nrg = (rows + kTR - 1) / kTR;
  for (int t = threadIdx.x; t < ncg * nrg; t += blockDim.x) {
    const int rg = t / ncg, cg = t - rg * ncg;
    const int l0 = rg * kTR, n0 = cg * 4;
    const float* a[kTR];
    const float* w[4];
#pragma unroll
    for (int r = 0; r < kTR; ++r) a[r] = A + min(l0 + r, rows - 1) * lda;
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = W + (size_t)min(n0 + c, N - 1) * ldw;
    float acc[kTR][4] = {};
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 av[kTR], wv[4];
#pragma unroll
      for (int r = 0; r < kTR; ++r) av[r] = rnd4<BF>(*reinterpret_cast<const float4*>(a[r] + k));
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wv[c] = rnd4<BF>(*reinterpret_cast<const float4*>(w[c] + k));
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(av[r].x, wv[c].x, acc[r][c]);
          acc[r][c] = fmaf(av[r].y, wv[c].y, acc[r][c]);
          acc[r][c] = fmaf(av[r].z, wv[c].z, acc[r][c]);
          acc[r][c] = fmaf(av[r].w, wv[c].w, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
      if (l0 + r < rows) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n0 + c < N) epi(l0 + r, n0 + c, acc[r][c]);
      }
  }
}

// out(m, n) = sum_l A[l][m] * Bm[l][n]: both (rows, .) in shared memory and
// rounded as they are read; the rows of A are readable up to a multiple of 4
// past M (what lies there only reaches outputs that are dropped); N a
// multiple of 4.
template <bool BF, typename Epi>
__device__ void mm_atb(const float* A, int lda, const float* Bm, int ldb, int rows, int M, int N,
                       Epi epi) {
  const int ncg = N >> 2, nmg = (M + 3) >> 2;
  for (int t = threadIdx.x; t < ncg * nmg; t += blockDim.x) {
    const int mg = t / ncg, cg = t - mg * ncg;
    const int m0 = mg * 4, n0 = cg * 4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int l = 0; l < rows; ++l) {
      const float4 av = rnd4<BF>(*reinterpret_cast<const float4*>(A + l * lda + m0));
      const float4 bv = rnd4<BF>(*reinterpret_cast<const float4*>(Bm + l * ldb + n0));
      const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(am[r], bv.x, acc[r][0]);
        acc[r][1] = fmaf(am[r], bv.y, acc[r][1]);
        acc[r][2] = fmaf(am[r], bv.z, acc[r][2]);
        acc[r][3] = fmaf(am[r], bv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (m0 + r < M) {
#pragma unroll
        for (int c = 0; c < 4; ++c) epi(m0 + r, n0 + c, acc[r][c]);
      }
  }
}

// g[n] += sum_l a[l][n] (* b[l][n] when b is given), unrounded
__device__ void colsum_add(float* g, const float* a, const float* b, int ld, int rows, int N) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
    for (int l = 0; l < rows; ++l) s += b ? a[l * ld + n] * b[l * ld + n] : a[l * ld + n];
    g[n] += s;
  }
}

// ---------------------------------------------------------------- row passes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// LayerNorm of each row of src (biased variance, 1 / sqrt(var + eps)):
// out = xhat * g + b to ``out`` (row stride ld_out; shared or device memory),
// xhat and the inverse deviation kept when asked for. src may equal xhat.
__device__ void ln_rows(const float* src, int ld, float* out, int ld_out, float* xhat,
                        float* inv_out, const float* g, const float* b, int rows, int D,
                        float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < rows; l += kWarps) {
    const float* s = src + l * ld;
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) sum += s[d];
    const float mu = warp_sum(sum) / D;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = s[d] - mu;
      sq += c * c;
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / D + eps);
    if (inv_out && lane == 0) inv_out[l] = inv;
    for (int d = lane; d < D; d += 32) {
      const float xh = (s[d] - mu) * inv;
      if (xhat) xhat[l * ld + d] = xh;
      out[(size_t)l * ld_out + d] = xh * g[d] + b[d];
    }
  }
}

// dy (in place) -> dx of LayerNorm: (dy g - mean(dy g) - xhat mean(dy g xhat)) inv
__device__ void ln_bwd_rows(float* dy, const float* xhat, const float* inv, const float* g,
                            int ld, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < rows; l += kWarps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float dxh = dy[l * ld + d] * g[d];
      s1 += dxh;
      s2 += dxh * xhat[l * ld + d];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int d = lane; d < D; d += 32) {
      const float dxh = dy[l * ld + d] * g[d];
      dy[l * ld + d] = (dxh - m1 - xhat[l * ld + d] * m2) * inv[l];
    }
  }
}

__device__ void softmax_rows(float* S, int ld, int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kWarps) {
    float* s = S + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < cols; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < cols; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < cols; j += 32) s[j] = s[j] / sum;
  }
}

// dp (in place) -> ds = p0 * (dp - sum_j dp p0) * scale
__device__ void softmax_bwd_rows(float* dp, const float* p0, int ld, int rows, int cols,
                                 float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kWarps) {
    float s = 0.0f;
    for (int j = lane; j < cols; j += 32) s += dp[i * ld + j] * p0[i * ld + j];
    s = warp_sum(s);
    for (int j = lane; j < cols; j += 32)
      dp[i * ld + j] = p0[i * ld + j] * (dp[i * ld + j] - s) * scale;
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float act_fn(int act, float x) {
  switch (act) {
    case GELU: return x * 0.5f * (1.0f + erff(x / 1.41421356237309504880f));
    case RELU: return fmaxf(x, 0.0f);
    case SWISH: return x * sigmoidf_(x);
    case TANH: return tanhf(x);
    default: return sigmoidf_(x);
  }
}

__device__ __forceinline__ float act_grad(int act, float x) {
  switch (act) {
    case GELU:
      return 0.5f * (1.0f + erff(x / 1.41421356237309504880f)) +
             x * 0.39894228040143267794f * expf(-0.5f * x * x);
    case RELU: return x > 0.0f ? 1.0f : 0.0f;
    case SWISH: {
      const float s = sigmoidf_(x);
      return s + x * s * (1.0f - s);
    }
    case TANH: {
      const float t = tanhf(x);
      return 1.0f - t * t;
    }
    default: {
      const float s = sigmoidf_(x);
      return s * (1.0f - s);
    }
  }
}

// ------------------------------------------------------------ shared memory

struct Smem {
  float *x, *q, *k, *v, *ctx, *a1, *t1;  // (L, LD) each
  float *xh1, *t2;                        // backward only
  float *f1, *f2;                         // (L, LC); f2 backward only
  float *s0, *s1;                         // (L, LS); s1 backward only
  float *inv1, *inv2;                     // (L,)
  int* valid;                             // (L,)
};

__device__ Smem carve(float* base, const Shape& sh, bool backward) {
  Smem m;
  const int ld = sh.L * sh.LD, lc = sh.L * sh.LC, ls = sh.L * sh.LS;
  float* p = base;
  m.x = p; p += ld;
  m.q = p; p += ld;
  m.k = p; p += ld;
  m.v = p; p += ld;
  m.ctx = p; p += ld;
  m.a1 = p; p += ld;
  m.t1 = p; p += ld;
  m.xh1 = m.t2 = nullptr;
  if (backward) {
    m.xh1 = p; p += ld;
    m.t2 = p; p += ld;
  }
  m.f1 = p; p += lc;
  m.f2 = nullptr;
  if (backward) {
    m.f2 = p; p += lc;
  }
  m.s0 = p; p += ls;
  m.s1 = nullptr;
  if (backward) {
    m.s1 = p; p += ls;
  }
  m.inv1 = p; p += sh.L;
  m.inv2 = p; p += sh.L;
  m.valid = reinterpret_cast<int*>(p);
  return m;
}

// rows of a (L, D) block of device memory <-> shared memory, float4 each
__device__ void load_rows(float* dst, int ld, const float* src, int L, int D) {
  const int nv = D >> 2;
  for (int i = threadIdx.x; i < L * nv; i += blockDim.x) {
    const int l = i / nv, c = i - l * nv;
    *reinterpret_cast<float4*>(dst + l * ld + 4 * c) =
        reinterpret_cast<const float4*>(src + (size_t)l * D)[c];
  }
}

__device__ void store_rows(float* dst, const float* src, int ld, int L, int D) {
  const int nv = D >> 2;
  for (int i = threadIdx.x; i < L * nv; i += blockDim.x) {
    const int l = i / nv, c = i - l * nv;
    reinterpret_cast<float4*>(dst + (size_t)l * D)[c] =
        *reinterpret_cast<const float4*>(src + l * ld + 4 * c);
  }
}

// ------------------------------------------------------------------ forward

// softmax probabilities of head h into s0 (before dropout)
template <bool BF>
__device__ void head_probs(const Smem& m, const Shape& sh, int h) {
  mm_xwt<BF>(m.q + h * sh.hd, sh.LD, m.k + h * sh.hd, sh.LD, sh.L, sh.hd, sh.L,
                   Score{m.s0, sh.LS, m.valid, sh.scale, sh.causal});
  __syncthreads();
  softmax_rows(m.s0, sh.LS, sh.L, sh.L);
  __syncthreads();
}

// The forward of sequence b from x in shared memory. Leaves q, k, v, ctx and
// a1; with KEEP also xhat1, inv1, xhat2 (in t1) and inv2 for the backward.
// Without KEEP it writes y to device memory.
template <bool BF, bool KEEP>
__device__ void forward_seq(const Smem& m, const Shape& sh, const Params& W, const Params& Wr,
                            int b, unsigned k0, unsigned k1, float* y) {
  const int L = sh.L, D = sh.D, LD = sh.LD;
  mm_xw<BF, false>(m.x, LD, Wr.p[WQ], D, L, D, D, StoreBias{m.q, LD, W.p[BQ]});
  mm_xw<BF, false>(m.x, LD, Wr.p[WK], D, L, D, D, StoreBias{m.k, LD, W.p[BK]});
  mm_xw<BF, false>(m.x, LD, Wr.p[WV], D, L, D, D, StoreBias{m.v, LD, W.p[BV]});
  __syncthreads();
  for (int h = 0; h < sh.H; ++h) {
    head_probs<BF>(m, sh, h);
    if (sh.attn_rate > 0.0f) {
      apply_keep(m.s0, m.s0, sh.LS, sh.LS, L, L, sh.attn_rate, b, h, sh.layer, k0, k1);
      __syncthreads();
    }
    mm_xw<BF, true>(m.s0, sh.LS, m.v + h * sh.hd, LD, L, L, sh.hd,
                    Store{m.ctx + h * sh.hd, LD});
    __syncthreads();
  }
  mm_xw<BF, false>(m.ctx, LD, Wr.p[WO], D, L, D, D, StoreBias{m.t1, LD, W.p[BO]});
  __syncthreads();
  if (sh.rate > 0.0f) {
    apply_keep(m.t1, m.t1, LD, LD, L, D, sh.rate, b, sh.H, sh.layer, k0, k1);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int l = i / D, d = i - l * D;
    m.t1[l * LD + d] += m.x[l * LD + d];
  }
  __syncthreads();
  ln_rows(m.t1, LD, m.a1, LD, KEEP ? m.xh1 : nullptr, KEEP ? m.inv1 : nullptr, W.p[LN1G],
          W.p[LN1B], L, D, sh.eps);
  __syncthreads();
  for (int c0 = 0; c0 < sh.I; c0 += sh.IC) {
    const int ic = min(sh.IC, sh.I - c0);
    mm_xw<BF, false>(m.a1, LD, Wr.p[FF1W] + c0, sh.I, L, D, ic,
                     StoreBias{m.f1, sh.LC, W.p[FF1B] + c0});
    __syncthreads();
    for (int i = threadIdx.x; i < L * ic; i += blockDim.x) {
      const int l = i / ic, c = i - l * ic;
      m.f1[l * sh.LC + c] = act_fn(sh.act, m.f1[l * sh.LC + c]);
    }
    __syncthreads();
    if (c0 == 0)
      mm_xw<BF, false>(m.f1, sh.LC, Wr.p[FF2W], D, L, ic, D, StoreBias{m.t1, LD, W.p[FF2B]});
    else
      mm_xw<BF, false>(m.f1, sh.LC, Wr.p[FF2W] + (size_t)c0 * D, D, L, ic, D, Add{m.t1, LD});
    __syncthreads();
  }
  if (sh.rate > 0.0f) {
    apply_keep(m.t1, m.t1, LD, LD, L, D, sh.rate, b, sh.H + 1, sh.layer, k0, k1);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int l = i / D, d = i - l * D;
    m.t1[l * LD + d] += m.a1[l * LD + d];
  }
  __syncthreads();
  if (KEEP)
    ln_rows(m.t1, LD, m.t2, LD, m.t1, m.inv2, W.p[LN2G], W.p[LN2B], L, D, sh.eps);
  else
    ln_rows(m.t1, LD, y + (size_t)b * L * D, D, nullptr, nullptr, W.p[LN2G], W.p[LN2B], L, D,
            sh.eps);
  __syncthreads();
}

__device__ __forceinline__ void load_seq(const Smem& m, const Shape& sh, const float* x,
                                         const int* valid, int b) {
  load_rows(m.x, sh.LD, x + (size_t)b * sh.L * sh.D, sh.L, sh.D);
  for (int j = threadIdx.x; j < sh.L; j += blockDim.x) m.valid[j] = valid[(size_t)b * sh.L + j];
  __syncthreads();
}

template <bool BF>
__global__ void __launch_bounds__(kThreads)
trm_layer_fwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                     Params Wr, const long long* __restrict__ seed, Shape sh,
                     float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  const Smem m = carve(reinterpret_cast<float*>(smem4), sh, false);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    load_seq(m, sh, x, valid, b);
    forward_seq<BF, false>(m, sh, W, Wr, b, k0, k1, y);
  }
}

// ----------------------------------------------------------------- backward

template <bool BF>
__global__ void __launch_bounds__(kThreads)
trm_layer_bwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                     Params Wr, Params Wt, const long long* __restrict__ seed, Shape sh,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const Smem m = carve(reinterpret_cast<float*>(smem4), sh, true);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  const int L = sh.L, D = sh.D, I = sh.I, LD = sh.LD, LC = sh.LC, LS = sh.LS, hd = sh.hd;
  const Offsets off = grad_offsets(D, I);
  float* G = partials + (size_t)blockIdx.x * off.o[kNumParams];
  for (int i = threadIdx.x; i < off.o[kNumParams]; i += blockDim.x) G[i] = 0.0f;
  __syncthreads();

  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    load_seq(m, sh, x, valid, b);
    forward_seq<BF, true>(m, sh, W, Wr, b, k0, k1, nullptr);   // t1 = xhat2

    // LayerNorm 2
    load_rows(m.t2, LD, dy + (size_t)b * L * D, L, D);
    __syncthreads();
    colsum_add(G + off.o[LN2G], m.t2, m.t1, LD, L, D);
    colsum_add(G + off.o[LN2B], m.t2, nullptr, LD, L, D);
    __syncthreads();
    ln_bwd_rows(m.t2, m.t1, m.inv2, W.p[LN2G], LD, L, D);      // t2 = dr2
    __syncthreads();
    // FFN: t1 = df2, t2 becomes da1
    if (sh.rate > 0.0f)
      apply_keep(m.t1, m.t2, LD, LD, L, D, sh.rate, b, sh.H + 1, sh.layer, k0, k1);
    else
      for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
        const int l = i / D, d = i - l * D;
        m.t1[l * LD + d] = m.t2[l * LD + d];
      }
    __syncthreads();
    colsum_add(G + off.o[FF2B], m.t1, nullptr, LD, L, D);
    for (int c0 = 0; c0 < I; c0 += sh.IC) {
      const int ic = min(sh.IC, I - c0);
      mm_xw<BF, false>(m.a1, LD, Wr.p[FF1W] + c0, I, L, D, ic,
                       StoreBias{m.f1, LC, W.p[FF1B] + c0});
      __syncthreads();
      for (int i = threadIdx.x; i < L * ic; i += blockDim.x) {
        const int l = i / ic, c = i - l * ic;
        m.f2[l * LC + c] = act_fn(sh.act, m.f1[l * LC + c]);
      }
      __syncthreads();
      mm_atb<BF>(m.f2, LC, m.t1, LD, L, ic, D, Add{G + off.o[FF2W] + (size_t)c0 * D, D});
      __syncthreads();
      mm_xw<BF, false>(m.t1, LD, Wt.p[FF2W] + c0, I, L, D, ic, Store{m.f2, LC});
      __syncthreads();
      for (int i = threadIdx.x; i < L * ic; i += blockDim.x) {
        const int l = i / ic, c = i - l * ic;
        m.f1[l * LC + c] = m.f2[l * LC + c] * act_grad(sh.act, m.f1[l * LC + c]);
      }
      __syncthreads();
      mm_atb<BF>(m.a1, LD, m.f1, LC, L, D, ic, Add{G + off.o[FF1W] + c0, I});
      colsum_add(G + off.o[FF1B] + c0, m.f1, nullptr, LC, L, ic);
      mm_xw<BF, false>(m.f1, LC, Wt.p[FF1W] + (size_t)c0 * D, D, L, ic, D, Add{m.t2, LD});
      __syncthreads();
    }
    // LayerNorm 1
    colsum_add(G + off.o[LN1G], m.t2, m.xh1, LD, L, D);
    colsum_add(G + off.o[LN1B], m.t2, nullptr, LD, L, D);
    __syncthreads();
    ln_bwd_rows(m.t2, m.xh1, m.inv1, W.p[LN1G], LD, L, D);     // t2 = dr1
    __syncthreads();
    // attention output projection: t1 = dattn, a1 becomes dctx
    if (sh.rate > 0.0f)
      apply_keep(m.t1, m.t2, LD, LD, L, D, sh.rate, b, sh.H, sh.layer, k0, k1);
    else
      for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
        const int l = i / D, d = i - l * D;
        m.t1[l * LD + d] = m.t2[l * LD + d];
      }
    __syncthreads();
    mm_atb<BF>(m.ctx, LD, m.t1, LD, L, D, D, Add{G + off.o[WO], D});
    colsum_add(G + off.o[BO], m.t1, nullptr, LD, L, D);
    mm_xw<BF, false>(m.t1, LD, Wt.p[WO], D, L, D, D, Store{m.a1, LD});
    __syncthreads();
    // attention, head by head: dq -> ctx, dk -> xh1, dv -> t1
    float* dq = m.ctx;
    float* dk = m.xh1;
    float* dv = m.t1;
    for (int h = 0; h < sh.H; ++h) {
      const int ho = h * hd;
      head_probs<BF>(m, sh, h);                                 // s0 = p0
      if (sh.attn_rate > 0.0f)
        apply_keep(m.s1, m.s0, LS, LS, L, L, sh.attn_rate, b, h, sh.layer, k0, k1);
      else
        for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
          const int r = i / L, c = i - r * L;
          m.s1[r * LS + c] = m.s0[r * LS + c];
        }
      __syncthreads();
      mm_atb<BF>(m.s1, LS, m.a1 + ho, LD, L, L, hd, Store{dv + ho, LD});
      __syncthreads();
      mm_xwt<BF>(m.a1 + ho, LD, m.v + ho, LD, L, hd, L, Store{m.s1, LS});
      __syncthreads();
      if (sh.attn_rate > 0.0f) {
        apply_keep(m.s1, m.s1, LS, LS, L, L, sh.attn_rate, b, h, sh.layer, k0, k1);
        __syncthreads();
      }
      softmax_bwd_rows(m.s1, m.s0, LS, L, L, sh.scale);        // s1 = ds
      __syncthreads();
      mm_xw<BF, true>(m.s1, LS, m.k + ho, LD, L, L, hd, Store{dq + ho, LD});
      mm_atb<BF>(m.s1, LS, m.q + ho, LD, L, L, hd, Store{dk + ho, LD});
      __syncthreads();
    }
    // projections
    mm_atb<BF>(m.x, LD, dq, LD, L, D, D, Add{G + off.o[WQ], D});
    mm_atb<BF>(m.x, LD, dk, LD, L, D, D, Add{G + off.o[WK], D});
    mm_atb<BF>(m.x, LD, dv, LD, L, D, D, Add{G + off.o[WV], D});
    colsum_add(G + off.o[BQ], dq, nullptr, LD, L, D);
    colsum_add(G + off.o[BK], dk, nullptr, LD, L, D);
    colsum_add(G + off.o[BV], dv, nullptr, LD, L, D);
    mm_xw<BF, false>(dq, LD, Wt.p[WQ], D, L, D, D, Add{m.t2, LD});
    __syncthreads();
    mm_xw<BF, false>(dk, LD, Wt.p[WK], D, L, D, D, Add{m.t2, LD});
    __syncthreads();
    mm_xw<BF, false>(dv, LD, Wt.p[WV], D, L, D, D, Add{m.t2, LD});
    __syncthreads();
    store_rows(dx + (size_t)b * L * D, m.t2, LD, L, D);
    __syncthreads();
  }
}

// grads[p] = sum of the blocks' partials, in block order
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int nblocks, int P,
                                       float* __restrict__ grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * P + p];
  grads[p] = s;
}

// the keep masks of one (seed, layer): attn (B, H, L, L) and hidden
// (B, 2, L, D) (attention output, FFN output), as 0 or 1 / (1 - rate)
__global__ void dropout_masks_kernel(const long long* __restrict__ seed, int B, int H, int L,
                                     int D, float attn_rate, float rate, int layer,
                                     float* __restrict__ attn, float* __restrict__ hidden) {
  const unsigned long long s = (unsigned long long)*seed;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  const int b = blockIdx.x;
  for (int h = 0; h < H; ++h)
    apply_keep(attn + ((size_t)b * H + h) * L * L, nullptr, L, L, L, L, attn_rate, b, h, layer,
               k0, k1);
  for (int site = 0; site < 2; ++site)
    apply_keep(hidden + ((size_t)b * 2 + site) * L * D, nullptr, D, D, L, D, rate, b, H + site,
               layer, k0, k1);
}

// ------------------------------------------------------------------- launch

int make_shape(int B, int L, int D, int H, int I, int causal, int act, float eps,
               float attn_rate, float rate, int layer, Shape* sh) {
  if (B < 1 || L < 1 || D < 4 || H < 1 || I < 4 || D % H || D % 4 || (D / H) % 4 || I % 4 ||
      act < GELU || act > SIGMOID || attn_rate < 0.f || attn_rate >= 1.f || rate < 0.f ||
      rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  sh->B = B; sh->L = L; sh->D = D; sh->H = H; sh->I = I;
  sh->hd = D / H;
  sh->IC = I < kChunk ? I : kChunk;
  sh->LD = D + kPad;
  sh->LC = sh->IC + kPad;
  sh->LS = ((L + 3) / 4) * 4 + kPad;
  sh->causal = causal; sh->act = act; sh->eps = eps;
  sh->scale = 1.0f / sqrtf((float)sh->hd);
  sh->attn_rate = attn_rate; sh->rate = rate; sh->layer = layer;
  return 0;
}

// The six weight matrices as the products read them, in ``scratch``: Wr the
// copies rounded to bf16 (the weights themselves in the fp32 instance), Wt
// the transposed copies (backward only). scratch holds M = 4 D^2 + 2 D I
// floats for each set that is made.
int prep_weights(const Params& W, Params* Wr, Params* Wt, int bf16, bool transposes,
                 float* scratch, int D, int I, cudaStream_t stream) {
  *Wr = W;
  if (Wt) *Wt = W;
  if (!bf16 && !transposes) return 0;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int mats[kNumMats] = {WQ, WK, WV, WO, FF1W, FF2W};
  float* pr = bf16 ? scratch : nullptr;
  float* pt = transposes ? scratch + (bf16 ? 4 * D * D + 2 * D * I : 0) : nullptr;
  PrepJob job;
  job.start[0] = 0;
  for (int i = 0; i < kNumMats; ++i) {
    job.in[i] = W.p[mats[i]];
    job.rows[i] = mats[i] == FF2W ? I : D;
    job.cols[i] = mats[i] == FF1W ? I : D;
    job.start[i + 1] = job.start[i] + job.rows[i] * job.cols[i];
    if (pr) Wr->p[mats[i]] = pr + job.start[i];
    if (pt) Wt->p[mats[i]] = pt + job.start[i];
  }
  const int blocks = (job.start[kNumMats] + 255) / 256;
  if (bf16)
    prep_weights_kernel<true><<<blocks, 256, 0, stream>>>(job, pr, pt);
  else
    prep_weights_kernel<false><<<blocks, 256, 0, stream>>>(job, pr, pt);
  return (int)cudaGetLastError();
}

template <typename K>
int plan_grid(K kernel, size_t smem, int B, int* grid) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  *grid = (int)(B < most ? B : most);
  return 0;
}

template <bool BF>
int grid_of(bool backward, size_t smem, int B, int* grid) {
  return backward ? plan_grid(trm_layer_bwd_kernel<BF>, smem, B, grid)
                  : plan_grid(trm_layer_fwd_kernel<BF>, smem, B, grid);
}

}  // namespace

// Shared-memory bytes a block needs for these widths, forward or backward.
extern "C" long long trm_layer_smem_bytes(int L, int D, int I, int backward) {
  return (long long)(sizeof(float) * smem_floats(L, D, I, backward != 0));
}

// The number of blocks the forward or the backward launches for B sequences
// (the backward's partials are (blocks, P)), or minus the CUDA error code:
// cudaErrorInvalidValue for widths outside the limits,
// cudaErrorInvalidConfiguration when the working set exceeds the shared
// memory a block may have.
extern "C" int trm_layer_blocks(int B, int L, int D, int H, int I, int bf16, int backward) {
  Shape sh;
  int err = make_shape(B, L, D, H, I, 0, 0, 1e-12f, 0.f, 0.f, 0, &sh);
  if (err) return -err;
  const size_t smem = sizeof(float) * smem_floats(L, D, I, backward != 0);
  int grid = 0;
  err = bf16 ? grid_of<true>(backward != 0, smem, B, &grid)
             : grid_of<false>(backward != 0, smem, B, &grid);
  return err ? -err : grid;
}

// x (B, L, D) f32, valid (B, L) int32, params 16 device pointers in the order
// of enum Param (all f32, contiguous), seed one int64 on the device (null
// when both rates are 0), wr scratch of 4 D^2 + 2 D I floats (bf16 instance
// only, for the rounded weights), y (B, L, D) f32. Returns the CUDA error code.
extern "C" int trm_layer_fwd(const float* x, const int* valid, const void* const* params,
                             const void* seed, int B, int L, int D, int H, int I, int causal,
                             int act, float eps, float attn_rate, float rate, int layer,
                             int bf16, float* wr, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shape sh;
  int err = make_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, &sh);
  if (err) return err;
  Params W, Wr;
  for (int i = 0; i < kNumParams; ++i) W.p[i] = static_cast<const float*>(params[i]);
  const size_t smem = sizeof(float) * smem_floats(L, D, I, false);
  int grid = 0;
  err = bf16 ? grid_of<true>(false, smem, B, &grid) : grid_of<false>(false, smem, B, &grid);
  if (err) return err;
  err = prep_weights(W, &Wr, nullptr, bf16, false, wr, D, I, s);
  if (err) return err;
  const long long* sd = static_cast<const long long*>(seed);
  if (bf16)
    trm_layer_fwd_kernel<true><<<grid, kThreads, smem, s>>>(x, valid, W, Wr, sd, sh, y);
  else
    trm_layer_fwd_kernel<false><<<grid, kThreads, smem, s>>>(x, valid, W, Wr, sd, sh, y);
  return (int)cudaGetLastError();
}

// As trm_layer_fwd, with dy (B, L, D) in and dx (B, L, D) out; wr is scratch
// of 4 D^2 + 2 D I floats for the transposed weights, twice that in the bf16
// instance (rounded weights first); partials is
// scratch of trm_layer_blocks(..., backward = 1) x P floats and grads the
// (P,) output, the 16 gradients one after the other in the order of enum
// Param (P = 4 D^2 + 2 D I + 9 D + I).
extern "C" int trm_layer_bwd(const float* x, const int* valid, const void* const* params,
                             const void* seed, int B, int L, int D, int H, int I, int causal,
                             int act, float eps, float attn_rate, float rate, int layer,
                             int bf16, float* wr, const float* dy, float* dx, float* partials,
                             float* grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shape sh;
  int err = make_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, &sh);
  if (err) return err;
  Params W, Wr, Wt;
  for (int i = 0; i < kNumParams; ++i) W.p[i] = static_cast<const float*>(params[i]);
  const size_t smem = sizeof(float) * smem_floats(L, D, I, true);
  int grid = 0;
  err = bf16 ? grid_of<true>(true, smem, B, &grid) : grid_of<false>(true, smem, B, &grid);
  if (err) return err;
  err = prep_weights(W, &Wr, &Wt, bf16, true, wr, D, I, s);
  if (err) return err;
  const long long* sd = static_cast<const long long*>(seed);
  if (bf16)
    trm_layer_bwd_kernel<true><<<grid, kThreads, smem, s>>>(x, valid, W, Wr, Wt, sd, sh, dy,
                                                            dx, partials);
  else
    trm_layer_bwd_kernel<false><<<grid, kThreads, smem, s>>>(x, valid, W, Wr, Wt, sd, sh, dy,
                                                             dx, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int P = grad_offsets(D, I).o[kNumParams];
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, s>>>(partials, grid, P, grads);
  return (int)cudaGetLastError();
}

// The keep masks the two kernels draw for (seed, layer): attn (B, H, L, L)
// and hidden (B, 2, L, D) f32, each element 0 or 1 / (1 - its rate).
extern "C" int trm_dropout_masks(const void* seed, int B, int H, int L, int D, float attn_rate,
                                 float rate, int layer, float* attn, float* hidden,
                                 void* stream) {
  if (!seed || B < 1) return (int)cudaErrorInvalidValue;
  dropout_masks_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), B, H, L, D, attn_rate, rate, layer, attn, hidden);
  return (int)cudaGetLastError();
}
