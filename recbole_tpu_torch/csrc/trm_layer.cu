// One post-LN transformer layer, forward and backward, in one kernel each,
// for Hopper.
//
// Replaces: recbole_tpu/ops/trm_layer.py::fused_transformer_layer2 (bf16
// operands; kernel bodies _forward_core :184-225 and _bwd_kernel :243-320)
// and recbole_tpu/ops/fused_transformer.py::fused_transformer_layer (the same
// layer with fp32 operands). The layer:
//   q, k, v = x W + b;  per head: P = dropout(softmax(q k^T / sqrt(hd) + mask));
//   ctx = P v;  a1 = LN1(x + dropout(ctx Wo + bo));
//   y = LN2(a1 + dropout(act(a1 W1 + b1) W2 + b2)).
// The backward recomputes the forward from x, regenerates the dropout masks,
// and returns dx and the 16 parameter gradients. Both instances share the
// layer's semantics: the mask is additive -1e9 after the scale (a fully
// masked row gives the uniform softmax the reference gives), heads contract
// over their own hd lanes only, dropout masks come from Philox4x32-10 keyed
// by the seed and counted by (element / 4, sequence, site, layer) (a mask
// does not depend on the block that draws it, forward and backward draw the
// same bits, and trm_dropout_masks writes the same masks out for the plain
// version), and the parameter gradients are summed by each block into a
// private (P,) partial in device memory that only it touches, then across
// blocks in block order by a second kernel: no float atomics, the same bits
// on every run with the same grid.
//
// ---------------------------------------------------------- fp32 instance
// trm_layer_fwd_kernel / trm_layer_bwd_kernel (fused_transformer_layer, row
// 6 of the port's kernel table). One block of 512 threads owns one sequence
// at a time and walks over sequences blockIdx.x, blockIdx.x + gridDim.x, ...;
// everything of a sequence, the (L, D) activations, one (L, IC) chunk of the
// FFN and the (L, L) scores of one head, lives in shared memory. Every
// product is a register-tiled (2 x 4 or 4 x 4 outputs per thread) loop of
// fp32 FMAs; the weight matrices are read from device memory, transposed
// once a call by prep_weights_kernel for the backward's products against
// W^T. Limits: D, D / H and I multiples of 4 and the working set (see
// smem_floats) within the card's opt-in shared memory.
//
// ---------------------------------------------------------- bf16 instance
// trm_layer_bf16_fwd_kernel / trm_layer_bf16_bwd_kernel
// (fused_transformer_layer2, row 5). Its rounding points are the JAX
// kernel's: both operands of every product are bfloat16 and the products are
// summed in fp32; the residual stream, LayerNorm statistics and xhat, the
// softmax, the dropout scaling and every bias and LayerNorm gradient stay
// fp32.
//
// What bounds it on the H100 (SASRec at the ml-1m shape: B = 2048, L = 50,
// D = 64, H = 2, I = 256): the forward is 10.7 GFLOP against 53 MB of x in
// and y out, the backward 32.2 GFLOP against 79.5 MB, so at the bf16
// tensor-core rate (989 TFLOP/s) the bytes bound the forward (16 us) and the
// operations the backward (33 us). A
// sequence is small: its products are (50 x 64) by (64 x 64 .. 256) tiles,
// and between them come row passes (LayerNorm, softmax, Philox dropout,
// GELU) that need a whole row, so what the card spends is the latency of
// about 30 dependent phases a sequence, each ended by a block barrier, and
// the instructions it must fetch to run them: every phase runs once a
// sequence, so its code is fetched anew each time: products with
// multi-tile tasks and k-loops unrolled 8 deep make an 839 KB backward
// kernel that runs slower than the FMA loops (PERF.md, PR 12).
//
// Design, point by point:
//  * Every product runs as mma.sync.m16n8k16 (bf16 operands, fp32 sums). A
//    warp's task is one 16 x 8 output tile; its k-loop loads B fragments
//    kKB k-steps at a time and spends one ldmatrix and one mma a k-step,
//    the masked last k-step peeled off, so a product's code is a few dozen
//    instructions. Activations are fed by ldmatrix (.trans for the A^T B
//    weight gradients) from bf16 copies in shared memory; a head's q, k, v
//    and dO start at any multiple of 4 columns, so they are read with 32-bit
//    (16-bit for a transposed B) loads. K is masked past its end in the
//    fragments and rows past the end are clamped, so no buffer needs zero
//    padding and a buffer holds exactly L rows.
//  * The weights: pack_weights_kernel writes the six matrices once a call,
//    rounded to bf16, in the order of the B fragments (a warp's k-step of an
//    8-column strip is 256 contiguous bytes), as W for the forward's products
//    and W^T for the backward's. The products read them from device memory
//    through the read-only path: the packed set (96 KB forward, 192 KB
//    backward at SASRec's widths) stays in L2, and a strip's fragments,
//    read again for each of its 16-row tiles, come from L1. A sequence so
//    reads each weight matrix about once from L2, not L / 2 = 25 times as
//    the FMA loop did, with no staging barrier, at any D and I.
//  * The working set: bf16 copies of the operands (x, q|k|v, ctx, a1, the
//    FFN chunk, dO, dq|dk|dv), fp32 only where the reference keeps fp32
//    (xhat1, xhat2, the backward's residual cotangent, one head's scores and
//    probabilities). The probabilities after dropout, and in the backward
//    ds, live as bf16 in the rows of the dp buffer; the FFN's and the
//    attention's scratch share their room (tc_layout). At SASRec's shape a
//    block takes 83,088 bytes forward and 105,312 backward (smem_bytes_bf16),
//    so two blocks share an SM both ways and one's barriers hide under the
//    other's work; at every shape the route sends to the kernel the block
//    fits (a CPU test walks them).
//  * Gradients: each weight-gradient product adds its tile into the block's
//    partial once a sequence, its old values loaded before the product and
//    the next tile's lines prefetched to L2, so the round trips run under
//    the mma chains (the 264 partials, 53 MB, do not all stay in L2). The
//    FFN bias gradient is summed down each column by the one warp that owns
//    the column's strip; the q, k and v bias gradients come
//    from row and column sums of P and ds (sum_l dq[l] = colsum(ds) k,
//    sum_j dk[j] = rowsum(ds) q, sum_j dv[j] = rowsum(P) dO): every sum has
//    one owner and a fixed order, so two runs give the same bits.
//  * Read-only inputs (biases, LayerNorm parameters, x, dy) are read with
//    __ldg, so the compiler may issue them ahead of the shared-memory stores
//    around them; the row passes keep their loops rolled.
//
// Limits: D, D / H and I multiples of 4, L <= 256, and the working set
// (smem_bytes_bf16) within the card's opt-in shared memory. Any B.
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
constexpr int kMaxRowBf16 = 256;  // the bf16 instance's most positions (row passes in registers)

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

// shared-memory floats of one fp32-instance block: 7 (forward) or 9
// (backward) (L, D) buffers, 1 or 2 FFN chunks, 1 or 2 score matrices, 2 (L,)
// vectors of inverse deviations, and L ints of key validity
inline size_t smem_floats(int L, int D, int I, bool backward) {
  const int IC = I < kChunk ? I : kChunk;
  const int LS = ((L + 3) / 4) * 4 + kPad;
  const size_t ld = (size_t)L * (D + kPad), lc = (size_t)L * (IC + kPad), ls = (size_t)L * LS;
  return backward ? 9 * ld + 2 * lc + 2 * ls + 3 * (size_t)L
                  : 7 * ld + lc + ls + 3 * (size_t)L;
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

// f(r, c, m) for every element of a (rows, cols) site, m its keep factor:
// bits >= threshold ? 1 / (1 - rate) : 0, the element's bits word (e & 3) of
// the Philox block counted by (e >> 2, sequence, site, layer), the bits
// apply_keep draws; m = 1 at rate 0
template <typename F>
__device__ __forceinline__ void for_keep(int rows, int cols, float rate, unsigned seq,
                                         unsigned site, unsigned layer, unsigned k0, unsigned k1,
                                         F f) {
  const int n = rows * cols;
  if (rate <= 0.0f) {
#pragma unroll 1
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / cols;
      f(r, e - r * cols, 1.0f);
    }
    return;
  }
  const unsigned thr = keep_threshold(rate);
  const float inv = 1.0f / (1.0f - rate);
#pragma unroll 1
  for (int g = threadIdx.x; g * 4 < n; g += blockDim.x) {
    const U4 bits = philox4x32_10((unsigned)g, seq, site, layer, k0, k1);
    int r = g * 4 / cols, c = g * 4 - r * cols;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (g * 4 + u < n) f(r, c, bits.v[u] >= thr ? inv : 0.0f);
      if (++c == cols) {
        c = 0;
        ++r;
      }
    }
  }
}

// dst[r][c] = src[r][c] * keep(r * cols + c); src may be null (the mask
// itself is written), and may equal dst
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
// Each FMA product hands its 4 x 4 register tile to an epilogue, one element
// at a time: out(l, n, acc).

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

// ------------------------------------------------------------- FMA products

// out(l, n) = sum_k A[l][k] * W[k][n]: A (rows, K) in shared memory (rows 16
// bytes aligned); W (K, N) with row stride ldw, N a multiple of 4, in device
// or shared memory. A warp's threads share their rows of A and read
// neighbouring columns of W, so every load is a broadcast or coalesced; the
// products against a transposed weight matrix come here too, with the
// transposed copy prep_weights_kernel makes.
template <typename Epi>
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
      for (int r = 0; r < kTR; ++r) av[r] = *reinterpret_cast<const float4*>(a[r] + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const float4*>(w + (size_t)(k + j) * ldw);
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
      const float4 wv = *reinterpret_cast<const float4*>(w + (size_t)k * ldw);
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float av = a[r][k];
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
template <typename Epi>
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
      for (int r = 0; r < kTR; ++r) av[r] = *reinterpret_cast<const float4*>(a[r] + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = *reinterpret_cast<const float4*>(w[c] + k);
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

// out(m, n) = sum_l A[l][m] * Bm[l][n]: both (rows, .) in shared memory; the
// rows of A are readable up to a multiple of 4 past M (what lies there only
// reaches outputs that are dropped); N a multiple of 4.
template <typename Epi>
__device__ void mm_atb(const float* A, int lda, const float* Bm, int ldb, int rows, int M, int N,
                       Epi epi) {
  const int ncg = N >> 2, nmg = (M + 3) >> 2;
  for (int t = threadIdx.x; t < ncg * nmg; t += blockDim.x) {
    const int mg = t / ncg, cg = t - mg * ncg;
    const int m0 = mg * 4, n0 = cg * 4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int l = 0; l < rows; ++l) {
      const float4 av = *reinterpret_cast<const float4*>(A + l * lda + m0);
      const float4 bv = *reinterpret_cast<const float4*>(Bm + l * ldb + n0);
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

// g[n] += sum_l a[l][n] (* b[l][n] when b is given)
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

// ============================================================ fp32 instance

// The six weight matrices transposed for the backward's products against W^T,
// in one launch: matrix m fills elements start[m] .. start[m + 1].
constexpr int kNumMats = 6;

struct PrepJob {
  const float* in[kNumMats];
  int rows[kNumMats], cols[kNumMats], start[kNumMats + 1];
};

__global__ void prep_weights_kernel(PrepJob job, float* __restrict__ transposed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= job.start[kNumMats]) return;
  int m = 0;
  while (i >= job.start[m + 1]) ++m;
  const int j = i - job.start[m], rows = job.rows[m], cols = job.cols[m];
  const int r = j / cols, c = j - r * cols;
  transposed[job.start[m] + (size_t)c * rows + r] = job.in[m][j];
}

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

// softmax probabilities of head h into s0 (before dropout)
__device__ void head_probs(const Smem& m, const Shape& sh, int h) {
  mm_xwt(m.q + h * sh.hd, sh.LD, m.k + h * sh.hd, sh.LD, sh.L, sh.hd, sh.L,
         Score{m.s0, sh.LS, m.valid, sh.scale, sh.causal});
  __syncthreads();
  softmax_rows(m.s0, sh.LS, sh.L, sh.L);
  __syncthreads();
}

// The forward of sequence b from x in shared memory. Leaves q, k, v, ctx and
// a1; with KEEP also xhat1, inv1, xhat2 (in t1) and inv2 for the backward.
// Without KEEP it writes y to device memory.
template <bool KEEP>
__device__ void forward_seq(const Smem& m, const Shape& sh, const Params& W, int b, unsigned k0,
                            unsigned k1, float* y) {
  const int L = sh.L, D = sh.D, LD = sh.LD;
  mm_xw(m.x, LD, W.p[WQ], D, L, D, D, StoreBias{m.q, LD, W.p[BQ]});
  mm_xw(m.x, LD, W.p[WK], D, L, D, D, StoreBias{m.k, LD, W.p[BK]});
  mm_xw(m.x, LD, W.p[WV], D, L, D, D, StoreBias{m.v, LD, W.p[BV]});
  __syncthreads();
  for (int h = 0; h < sh.H; ++h) {
    head_probs(m, sh, h);
    if (sh.attn_rate > 0.0f) {
      apply_keep(m.s0, m.s0, sh.LS, sh.LS, L, L, sh.attn_rate, b, h, sh.layer, k0, k1);
      __syncthreads();
    }
    mm_xw(m.s0, sh.LS, m.v + h * sh.hd, LD, L, L, sh.hd, Store{m.ctx + h * sh.hd, LD});
    __syncthreads();
  }
  mm_xw(m.ctx, LD, W.p[WO], D, L, D, D, StoreBias{m.t1, LD, W.p[BO]});
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
    mm_xw(m.a1, LD, W.p[FF1W] + c0, sh.I, L, D, ic, StoreBias{m.f1, sh.LC, W.p[FF1B] + c0});
    __syncthreads();
    for (int i = threadIdx.x; i < L * ic; i += blockDim.x) {
      const int l = i / ic, c = i - l * ic;
      m.f1[l * sh.LC + c] = act_fn(sh.act, m.f1[l * sh.LC + c]);
    }
    __syncthreads();
    if (c0 == 0)
      mm_xw(m.f1, sh.LC, W.p[FF2W], D, L, ic, D, StoreBias{m.t1, LD, W.p[FF2B]});
    else
      mm_xw(m.f1, sh.LC, W.p[FF2W] + (size_t)c0 * D, D, L, ic, D, Add{m.t1, LD});
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

__global__ void __launch_bounds__(kThreads)
trm_layer_fwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                     const long long* __restrict__ seed, Shape sh, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  const Smem m = carve(reinterpret_cast<float*>(smem4), sh, false);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    load_seq(m, sh, x, valid, b);
    forward_seq<false>(m, sh, W, b, k0, k1, y);
  }
}

__global__ void __launch_bounds__(kThreads)
trm_layer_bwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                     Params Wt, const long long* __restrict__ seed, Shape sh,
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
    forward_seq<true>(m, sh, W, b, k0, k1, nullptr);   // t1 = xhat2

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
      mm_xw(m.a1, LD, W.p[FF1W] + c0, I, L, D, ic, StoreBias{m.f1, LC, W.p[FF1B] + c0});
      __syncthreads();
      for (int i = threadIdx.x; i < L * ic; i += blockDim.x) {
        const int l = i / ic, c = i - l * ic;
        m.f2[l * LC + c] = act_fn(sh.act, m.f1[l * LC + c]);
      }
      __syncthreads();
      mm_atb(m.f2, LC, m.t1, LD, L, ic, D, Add{G + off.o[FF2W] + (size_t)c0 * D, D});
      __syncthreads();
      mm_xw(m.t1, LD, Wt.p[FF2W] + c0, I, L, D, ic, Store{m.f2, LC});
      __syncthreads();
      for (int i = threadIdx.x; i < L * ic; i += blockDim.x) {
        const int l = i / ic, c = i - l * ic;
        m.f1[l * LC + c] = m.f2[l * LC + c] * act_grad(sh.act, m.f1[l * LC + c]);
      }
      __syncthreads();
      mm_atb(m.a1, LD, m.f1, LC, L, D, ic, Add{G + off.o[FF1W] + c0, I});
      colsum_add(G + off.o[FF1B] + c0, m.f1, nullptr, LC, L, ic);
      mm_xw(m.f1, LC, Wt.p[FF1W] + (size_t)c0 * D, D, L, ic, D, Add{m.t2, LD});
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
    mm_atb(m.ctx, LD, m.t1, LD, L, D, D, Add{G + off.o[WO], D});
    colsum_add(G + off.o[BO], m.t1, nullptr, LD, L, D);
    mm_xw(m.t1, LD, Wt.p[WO], D, L, D, D, Store{m.a1, LD});
    __syncthreads();
    // attention, head by head: dq -> ctx, dk -> xh1, dv -> t1
    float* dq = m.ctx;
    float* dk = m.xh1;
    float* dv = m.t1;
    for (int h = 0; h < sh.H; ++h) {
      const int ho = h * hd;
      head_probs(m, sh, h);                                 // s0 = p0
      if (sh.attn_rate > 0.0f)
        apply_keep(m.s1, m.s0, LS, LS, L, L, sh.attn_rate, b, h, sh.layer, k0, k1);
      else
        for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
          const int r = i / L, c = i - r * L;
          m.s1[r * LS + c] = m.s0[r * LS + c];
        }
      __syncthreads();
      mm_atb(m.s1, LS, m.a1 + ho, LD, L, L, hd, Store{dv + ho, LD});
      __syncthreads();
      mm_xwt(m.a1 + ho, LD, m.v + ho, LD, L, hd, L, Store{m.s1, LS});
      __syncthreads();
      if (sh.attn_rate > 0.0f) {
        apply_keep(m.s1, m.s1, LS, LS, L, L, sh.attn_rate, b, h, sh.layer, k0, k1);
        __syncthreads();
      }
      softmax_bwd_rows(m.s1, m.s0, LS, L, L, sh.scale);        // s1 = ds
      __syncthreads();
      mm_xw(m.s1, LS, m.k + ho, LD, L, L, hd, Store{dq + ho, LD});
      mm_atb(m.s1, LS, m.q + ho, LD, L, L, hd, Store{dk + ho, LD});
      __syncthreads();
    }
    // projections
    mm_atb(m.x, LD, dq, LD, L, D, D, Add{G + off.o[WQ], D});
    mm_atb(m.x, LD, dk, LD, L, D, D, Add{G + off.o[WK], D});
    mm_atb(m.x, LD, dv, LD, L, D, D, Add{G + off.o[WV], D});
    colsum_add(G + off.o[BQ], dq, nullptr, LD, L, D);
    colsum_add(G + off.o[BK], dk, nullptr, LD, L, D);
    colsum_add(G + off.o[BV], dv, nullptr, LD, L, D);
    mm_xw(dq, LD, Wt.p[WQ], D, L, D, D, Add{m.t2, LD});
    __syncthreads();
    mm_xw(dk, LD, Wt.p[WK], D, L, D, D, Add{m.t2, LD});
    __syncthreads();
    mm_xw(dv, LD, Wt.p[WV], D, L, D, D, Add{m.t2, LD});
    __syncthreads();
    store_rows(dx + (size_t)b * L * D, m.t2, LD, L, D);
    __syncthreads();
  }
}

// ============================================================ bf16 instance

typedef __nv_bfloat16 bf16;

constexpr int kKB = 4;   // k-steps of B fragments loaded at once

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// c += a b: one m16n8k16 tile, bf16 operands, fp32 sums
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float from_bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// a fragment register holding k = kk and kk + 1: those at or past K read as 0
__device__ __forceinline__ uint32_t kmask(uint32_t v, int kk, int K) {
  return kk >= K ? 0u : (kk + 1 >= K ? (v & 0xffffu) : v);
}

// Operand loaders. An A loader gives the 16 x 16 fragment at rows m0, k0; a B
// loader the 16 x 8 fragment at k0, columns n0, in mma's register order
// (a: rows gr, gr + 8 by k 2q, 2q + 8; b: k 2q, 2q + 8 by column gr, where
// gr = lane / 4, q = lane % 4). Rows past ``rows`` are clamped to the last
// one: what they give reaches only outputs past M or N, which are dropped,
// or k past K, which is masked.

// A from a bf16 matrix in shared memory, rows 16-byte aligned: [m][k]
// (ldmatrix), or [k][m] when T (ldmatrix.trans: A^T of what is stored)
template <bool T>
struct SmemA {
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int m0, int k0, uint32_t r[4]) const {
    const int lane = threadIdx.x & 31, mat = lane >> 3, i = lane & 7;
    if (!T) {
      const int row = min(m0 + i + (mat & 1) * 8, rows - 1);
      ldsm_x4(p + row * ld + k0 + (mat >> 1) * 8, r);
    } else {
      const int row = min(k0 + i + (mat >> 1) * 8, rows - 1);
      ldsm_x4_t(p + row * ld + m0 + (mat & 1) * 8, r);
    }
  }
};

// B from a bf16 matrix in shared memory, rows 16-byte aligned: [n][k], or
// [k][n] when T
template <bool T>
struct SmemB {
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int n0, int k0, uint32_t& b0, uint32_t& b1) const {
    const int lane = threadIdx.x & 31, mat = (lane >> 3) & 1, i = lane & 7;
    if (!T) {
      const int row = min(n0 + i, rows - 1);
      ldsm_x2(p + row * ld + k0 + mat * 8, b0, b1);
    } else {
      const int row = min(k0 + i + mat * 8, rows - 1);
      ldsm_x2_t(p + row * ld + n0, b0, b1);
    }
  }
};

// A head's slice of q, k, v or dO: [m][k] at any even column, read 32 bits
// at a time
struct HeadA {
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int m0, int k0, uint32_t r[4]) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
    const bf16* r0 = p + min(m0 + gr, rows - 1) * ld + k0 + 2 * q;
    const bf16* r8 = p + min(m0 + gr + 8, rows - 1) * ld + k0 + 2 * q;
    r[0] = *reinterpret_cast<const uint32_t*>(r0);
    r[1] = *reinterpret_cast<const uint32_t*>(r8);
    r[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    r[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
  }
};

// the same as a B operand: [n][k] (32-bit loads), or [k][n] when T (16-bit)
template <bool T>
struct HeadB {
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int n0, int k0, uint32_t& b0, uint32_t& b1) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
    if (!T) {
      const bf16* r = p + min(n0 + gr, rows - 1) * ld + k0 + 2 * q;
      b0 = *reinterpret_cast<const uint32_t*>(r);
      b1 = *reinterpret_cast<const uint32_t*>(r + 8);
    } else {
      const int k = k0 + 2 * q, c = n0 + gr, last = rows - 1;
      b0 = pack2(p[min(k, last) * ld + c], p[min(k + 1, last) * ld + c]);
      b1 = pack2(p[min(k + 8, last) * ld + c], p[min(k + 9, last) * ld + c]);
    }
  }
};

// B from a packed weight matrix in device memory (pack_weights_kernel): the
// fragment of strip s and k-step t is lane-contiguous at (s kt + t) 32 +
// lane; the loader starts ``s0`` strips and ``t0`` k-steps in (an FFN chunk)
struct PackedB {
  const uint2* p;
  int kt, s0, t0;
  __device__ __forceinline__ void load(int n0, int k0, uint32_t& b0, uint32_t& b1) const {
    const uint2 v = __ldg(p + ((size_t)(s0 + (n0 >> 3)) * kt + t0 + (k0 >> 4)) * 32 +
                          (threadIdx.x & 31));
    b0 = v.x;
    b1 = v.y;
  }
};

// The warp's accumulators for the 16 x 8 tile at rows m0, columns n0, over
// K: the strip's B fragments kKB k-steps at a time, then one ldmatrix and
// one mma a k-step. A task is one tile, so the loop body and the epilogue
// stay a few dozen instructions: every product is run once a sequence, and
// unrolled multi-tile bodies cost more in instruction fetch than they save
// (a strip's B fragments, read again for each of its tiles, come from L1).
template <typename AL, typename BL>
__device__ __forceinline__ void task_mma(const AL& A, const BL& Bl, int m0, int n0, int K,
                                         float acc[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
  const int full = K >> 4;  // k-steps that need no mask
  int t = 0;
  for (; t + kKB <= full; t += kKB) {
    uint32_t b[kKB][2];
#pragma unroll
    for (int u = 0; u < kKB; ++u) Bl.load(n0, (t + u) * 16, b[u][0], b[u][1]);
#pragma unroll
    for (int u = 0; u < kKB; ++u) {
      uint32_t a[4];
      A.load(m0, (t + u) * 16, a);
      mma16816(acc, a, b[u][0], b[u][1]);
    }
  }
#pragma unroll 1
  for (; t * 16 < K; ++t) {  // the rest one k-step at a time, the last masked
    const int k0 = t * 16;
    uint32_t a[4], b0, b1;
    Bl.load(n0, k0, b0, b1);
    A.load(m0, k0, a);
    if (k0 + 16 > K) {
      const int lo = k0 + 2 * (threadIdx.x & 3), hi = lo + 8;
      b0 = kmask(b0, lo, K);
      b1 = kmask(b1, hi, K);
      a[0] = kmask(a[0], lo, K);
      a[1] = kmask(a[1], lo, K);
      a[2] = kmask(a[2], hi, K);
      a[3] = kmask(a[3], hi, K);
    }
    mma16816(acc, a, b0, b1);
  }
}

// out(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, handed to epi(m, n,
// value) once each. The block's warps share the 16 x 8 tiles.
template <typename AL, typename BL, typename Epi>
__device__ __forceinline__ void mma_product(const AL& A, const BL& Bl, int M, int N, int K,
                                            Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int warps = blockDim.x >> 5;
  const int strips = (N + 7) >> 3, tasks = ((M + 15) >> 4) * strips;
  for (int task = warp; task < tasks; task += warps) {
    const int g = task / strips, n0 = (task - g * strips) * 8, m0 = g * 16;
    float acc[4];
    task_mma(A, Bl, m0, n0, K, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + gr + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
      if (row < M && col < N) epi(row, col, acc[e]);
    }
  }
}

// G[m ldg + n] += sum_k A(m, k) B(k, n) for m < M, n < N, G in device
// memory with one owner per element (the block's partial). A task loads its
// old values before its product, so their round trip runs under the mma
// chain, and first asks L2 for the next task's lines.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename AL, typename BL>
__device__ __forceinline__ void mma_product_add(const AL& A, const BL& Bl, int M, int N, int K,
                                                float* __restrict__ G, int ldg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int warps = blockDim.x >> 5;
  const int strips = (N + 7) >> 3, tasks = ((M + 15) >> 4) * strips;
  for (int task = warp; task < tasks; task += warps) {
    const int g = task / strips, n0 = (task - g * strips) * 8, m0 = g * 16;
    const int next = task + warps;
    if (next < tasks && lane < 16) {
      const int gn = next / strips, row = gn * 16 + lane;
      if (row < M) prefetch_l2(G + (size_t)row * ldg + (next - gn * strips) * 8);
    }
    float acc[4], old[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + gr + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
      old[e] = row < M && col < N ? G[(size_t)row * ldg + col] : 0.0f;
    }
    task_mma(A, Bl, m0, n0, K, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + gr + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
      if (row < M && col < N) G[(size_t)row * ldg + col] = old[e] + acc[e];
    }
  }
}

// Two products on the same (M, N) tiles, out1 = A1 B1 and out2 = A2 B2 over
// the same K, handed together to epi(m, n, v1, v2), which returns a value
// summed over each column; colsum(n, sum) receives the column's sum once. A
// warp takes a strip's every tile, so one warp sums a column in row order.
template <typename AL1, typename BL1, typename AL2, typename BL2, typename Epi, typename Col>
__device__ __forceinline__ void mma_dual(const AL1& A1, const BL1& B1, const AL2& A2,
                                         const BL2& B2, int M, int N, int K, Epi epi,
                                         Col colsum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int warps = blockDim.x >> 5;
  const int strips = (N + 7) >> 3;
  for (int s = warp; s < strips; s += warps) {
    const int n0 = s * 8;
    float cs[2] = {0.0f, 0.0f};
    for (int m0 = 0; m0 < M; m0 += 16) {
      float acc1[4], acc2[4];
      task_mma(A1, B1, m0, n0, K, acc1);
      task_mma(A2, B2, m0, n0, K, acc2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + gr + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
        if (row < M && col < N) cs[e & 1] += epi(row, col, acc1[e], acc2[e]);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      cs[0] += __shfl_xor_sync(kFull, cs[0], o);
      cs[1] += __shfl_xor_sync(kFull, cs[1], o);
    }
    if (gr == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n0 + 2 * q + e < N) colsum(n0 + 2 * q + e, cs[e]);
  }
}

// The packed weight matrices: W for the forward's products, W^T for the
// backward's dx products.
enum Packed { PQKV, PO, P1, P2, POT, P2T, P1T, PQKVT, kNumPacked };

struct PackedSet {
  const uint2* p[kNumPacked];
  int kt[kNumPacked];
};

// One matrix to pack: B(k, n) = W(k, n), or W(n, k) when trans; W is one
// (rows, cols) matrix, or (split) the columns of three (rows, split) ones
// side by side (Wq | Wk | Wv).
struct PackMat {
  const float* src[3];
  int rows, cols, split, trans, K, N;
  long long start;  // in uint2
};

struct PackJob {
  PackMat m[kNumPacked];
  int count;
  long long total;
};

__device__ __forceinline__ float pack_src(const PackMat& m, int k, int n) {
  if (k >= m.K || n >= m.N) return 0.0f;
  const int r = m.trans ? n : k, c = m.trans ? k : n;
  if (m.split) return m.src[c / m.split][(size_t)r * m.split + c % m.split];
  return m.src[0][(size_t)r * m.cols + c];
}

// every packed matrix rounded to bf16 in fragment order, zero past K and N
__global__ void pack_weights_kernel(PackJob job, uint2* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < job.total;
       i += (long long)gridDim.x * blockDim.x) {
    int mi = 0;
    while (mi + 1 < job.count && i >= job.m[mi + 1].start) ++mi;
    const PackMat& m = job.m[mi];
    const long long local = i - m.start;
    const int lane = (int)(local & 31), kt = (m.K + 15) >> 4;
    const long long blk = local >> 5;
    const int s = (int)(blk / kt), t = (int)(blk - (long long)s * kt);
    const int n = s * 8 + (lane >> 2), k = t * 16 + 2 * (lane & 3);
    uint2 v;
    v.x = pack2(to_bf(pack_src(m, k, n)), to_bf(pack_src(m, k + 1, n)));
    v.y = pack2(to_bf(pack_src(m, k + 8, n)), to_bf(pack_src(m, k + 9, n)));
    out[i] = v;
  }
}

__host__ __device__ inline long long packed_size(int K, int N) {
  return (long long)((K + 15) / 16) * ((N + 7) / 8) * 32;
}

// row strides: bf16 rows of n values end on a 16-byte boundary plus 16 bytes,
// an odd number of 16-byte chunks, so the 8 rows an ldmatrix reads fall in
// distinct banks; fp32 score rows take LSf = 4 mod 8 floats for the same
// reason when they hold bf16 P or ds, and at least 12
__host__ __device__ inline int sb(int n) { return (n + 15) / 16 * 16 + 8; }

__host__ __device__ inline int score_stride(int L) {
  int r = (L + 3) / 4 * 4;
  if (r % 8 == 0) r += 4;
  return r < 12 ? 12 : r;
}

struct TcShape {
  int B, L, D, H, I, hd, IC, SBD, SBQ, SBI, FD, LSf;
  int causal, act;
  float eps, scale;
  float attn_rate, rate;
  int layer;
};

// The bf16 instance's shared memory, in bytes from the block's base; every
// offset a multiple of 16. Persistent: xb, qkv (q | k | v), ctx, a1b (bf16),
// the backward's dr (fp32), inv1, inv2, three (L,) sums, valid. Then two
// areas that share their room, as their contents are never live at once:
// the FFN's (xh1 from the output projection through the backward's
// LayerNorm 1, fa a chunk of act(f1), t2 its sum then xhat2 then df2, and in
// the backward df2b and df1) and the attention's (S (p0) and Pdp (P, dp,
// ds) of one head; in the backward dctx, dqkv, and dattn, dattnb before the
// heads). The backward walks the FFN in chunks of kChunkBwd: at SASRec's
// shape its block then takes under half the SM's shared memory, so two
// blocks share an SM.
constexpr int kChunkBwd = 64;

struct TcLayout {
  size_t xb, qkv, ctx, a1b, xh1, dr, inv1, inv2, csum, rsum, psum, valid;
  size_t S, Pdp, dctx, dqkv, dattn, dattnb, fa, t2, df2b, df1, total;
};

inline size_t al16(size_t v) { return (v + 15) / 16 * 16; }

inline int tc_chunk(int I, bool backward) {
  const int c = backward ? kChunkBwd : kChunk;
  return I < c ? I : c;
}

inline TcLayout tc_layout(int L, int D, int I, bool backward) {
  const int IC = tc_chunk(I, backward);
  const size_t bD = al16((size_t)L * sb(D) * 2), bQ = al16((size_t)L * sb(3 * D) * 2),
               bI = al16((size_t)L * sb(IC) * 2), fD = (size_t)L * (D + 4) * 4,
               fS = (size_t)L * score_stride(L) * 4, vec = al16((size_t)L * 4);
  TcLayout t;
  size_t p = 0;
  t.xb = p; p += bD;
  t.qkv = p; p += bQ;
  t.ctx = p; p += bD;
  t.a1b = p; p += bD;
  t.dr = p; if (backward) p += fD;
  t.inv1 = p; p += vec;
  t.inv2 = p; p += vec;
  t.csum = p; if (backward) p += vec;
  t.rsum = p; if (backward) p += vec;
  t.psum = p; if (backward) p += vec;
  t.valid = p; p += vec;
  // the FFN's area
  size_t f = p;
  t.xh1 = f; f += fD;
  t.fa = f; f += bI;
  t.t2 = f; f += fD;
  t.df2b = f; if (backward) f += bD;
  t.df1 = f; if (backward) f += bI;
  // the attention's area
  size_t a = p;
  t.dctx = a; if (backward) a += bD;
  t.dqkv = a; if (backward) a += bQ;
  t.S = a;
  t.Pdp = a + fS;
  t.dattn = a;
  t.dattnb = a + fD;
  a += backward ? (2 * fS > fD + bD ? 2 * fS : fD + bD) : 2 * fS;
  // 64 bytes of slack: a head's 32-bit loads may read 8 bytes past its last row
  t.total = (a > f ? a : f) + 64;
  return t;
}

struct TcSmem {
  bf16 *xb, *qkv, *ctx, *a1b, *dctx, *dqkv, *dattnb, *fa, *df2b, *df1;
  float *xh1, *dr, *inv1, *inv2, *csum, *rsum, *psum, *S, *Pdp, *dattn, *t2;
  int* valid;
};

__device__ TcSmem tc_carve(char* base, const TcLayout& t) {
  TcSmem m;
  m.xb = reinterpret_cast<bf16*>(base + t.xb);
  m.qkv = reinterpret_cast<bf16*>(base + t.qkv);
  m.ctx = reinterpret_cast<bf16*>(base + t.ctx);
  m.a1b = reinterpret_cast<bf16*>(base + t.a1b);
  m.dctx = reinterpret_cast<bf16*>(base + t.dctx);
  m.dqkv = reinterpret_cast<bf16*>(base + t.dqkv);
  m.dattnb = reinterpret_cast<bf16*>(base + t.dattnb);
  m.fa = reinterpret_cast<bf16*>(base + t.fa);
  m.df2b = reinterpret_cast<bf16*>(base + t.df2b);
  m.df1 = reinterpret_cast<bf16*>(base + t.df1);
  m.xh1 = reinterpret_cast<float*>(base + t.xh1);
  m.dr = reinterpret_cast<float*>(base + t.dr);
  m.inv1 = reinterpret_cast<float*>(base + t.inv1);
  m.inv2 = reinterpret_cast<float*>(base + t.inv2);
  m.csum = reinterpret_cast<float*>(base + t.csum);
  m.rsum = reinterpret_cast<float*>(base + t.rsum);
  m.psum = reinterpret_cast<float*>(base + t.psum);
  m.S = reinterpret_cast<float*>(base + t.S);
  m.Pdp = reinterpret_cast<float*>(base + t.Pdp);
  m.dattn = reinterpret_cast<float*>(base + t.dattn);
  m.t2 = reinterpret_cast<float*>(base + t.t2);
  m.valid = reinterpret_cast<int*>(base + t.valid);
  return m;
}

// The bf16 instance's row passes: as ln_rows, ln_bwd_rows, colsum_add and
// load_rows, with the loops kept rolled (each pass runs once a sequence, so
// its instruction fetch costs more than unrolling saves) and the read-only
// parameters read through the non-coherent path.

// LayerNorm of each row of src: xhat in place when keep (with inv_out), or
// xhat g + b to out (row stride ld_out, device memory)
__device__ void tc_ln_rows(float* src, int ld, float* out, int ld_out, bool keep, float* inv_out,
                           const float* __restrict__ g, const float* __restrict__ b, int rows,
                           int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int l = warp; l < rows; l += kWarps) {
    float* s = src + l * ld;
    float sum = 0.0f;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) sum += s[d];
    const float mu = warp_sum(sum) / D;
    float sq = 0.0f;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) {
      const float c = s[d] - mu;
      sq += c * c;
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / D + eps);
    if (keep && lane == 0) inv_out[l] = inv;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) {
      const float xh = (s[d] - mu) * inv;
      if (keep) s[d] = xh;
      else out[(size_t)l * ld_out + d] = xh * __ldg(g + d) + __ldg(b + d);
    }
  }
}

__device__ void tc_ln_bwd_rows(float* dy, const float* xhat, const float* inv,
                               const float* __restrict__ g, int ld, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int l = warp; l < rows; l += kWarps) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) {
      const float dxh = dy[l * ld + d] * __ldg(g + d);
      s1 += dxh;
      s2 += dxh * xhat[l * ld + d];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) {
      const float dxh = dy[l * ld + d] * __ldg(g + d);
      dy[l * ld + d] = (dxh - m1 - xhat[l * ld + d] * m2) * inv[l];
    }
  }
}

__device__ void tc_colsum_add(float* g, const float* a, const float* b, int ld, int rows, int N) {
#pragma unroll 1
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
#pragma unroll 4
    for (int l = 0; l < rows; ++l) s += b ? a[l * ld + n] * b[l * ld + n] : a[l * ld + n];
    g[n] += s;
  }
}

__device__ void tc_load_rows(float* dst, int ld, const float* __restrict__ src, int L, int D) {
  const int nv = D >> 2;
#pragma unroll 1
  for (int i = threadIdx.x; i < L * nv; i += blockDim.x) {
    const int l = i / nv, c = i - l * nv;
    *reinterpret_cast<float4*>(dst + l * ld + 4 * c) =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)l * D) + c);
  }
}

// the activation, and the activation with its derivative, out of line: one
// copy of the five cases for all the products' epilogues (GELU's two share
// their erff)
__device__ __noinline__ float tc_act(int act, float x) { return act_fn(act, x); }
__device__ __noinline__ float2 tc_act2(int act, float x) {
  if (act == GELU) {
    const float e = erff(x / 1.41421356237309504880f);
    return make_float2(x * 0.5f * (1.0f + e),
                       0.5f * (1.0f + e) + x * 0.39894228040143267794f * expf(-0.5f * x * x));
  }
  return make_float2(act_fn(act, x), act_grad(act, x));
}

// P and ds: bf16 rows at the stride of the fp32 rows they share
__device__ __forceinline__ bf16* pb(const TcSmem& m) { return reinterpret_cast<bf16*>(m.Pdp); }

// S = q_h k_h^T scale + mask (fp32)
__device__ void tc_scores(const TcSmem& m, const TcShape& sh, int h) {
  const int hd = sh.hd, LSf = sh.LSf, causal = sh.causal;
  const float scale = sh.scale;
  const int* valid = m.valid;
  float* S = m.S;
  mma_product(HeadA{m.qkv + h * hd, sh.SBQ, sh.L},
              HeadB<false>{m.qkv + sh.D + h * hd, sh.SBQ, sh.L}, sh.L, sh.L, hd, [&](int i, int j, float v) {
                const bool ok = valid[j] > 0 && (causal ? j <= i : valid[i] > 0);
                S[i * LSf + j] = v * scale + (ok ? 0.0f : kNeg);
              });
}

// S -> p0 in place, row by row; P = bf16(p0) too when there is no attention
// dropout
__device__ void tc_softmax(const TcSmem& m, const TcShape& sh, bool write_p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, L = sh.L;
  bf16* P = pb(m);
#pragma unroll 1
  for (int i = warp; i < L; i += kWarps) {
    float* s = m.S + i * sh.LSf;
    float mx = -INFINITY;
#pragma unroll 1
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll 1
    for (int j = lane; j < L; j += 32) {
      const float e = expf(s[j] - mx);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll 1
    for (int j = lane; j < L; j += 32) {
      const float p = s[j] / sum;
      s[j] = p;
      if (write_p) P[i * 2 * sh.LSf + j] = to_bf(p);
    }
  }
}

// P = bf16(p0 keep) over head h's (L, L) dropout site
__device__ void tc_keep_probs(const TcSmem& m, const TcShape& sh, int b, int h, unsigned k0,
                              unsigned k1) {
  const float* S = m.S;
  bf16* P = pb(m);
  const int LSf = sh.LSf;
  for_keep(sh.L, sh.L, sh.attn_rate, b, h, sh.layer, k0, k1,
           [&](int i, int j, float mk) { P[i * 2 * LSf + j] = to_bf(S[i * LSf + j] * mk); });
}

// The forward of sequence b with xb and valid in shared memory. Leaves qkv,
// ctx, a1b and xhat1; with KEEP also inv1, xhat2 (in t2) and inv2 for the
// backward. Without KEEP it writes y to device memory.
template <bool KEEP>
__device__ void tc_forward_seq(const TcSmem& m, const TcShape& sh, const Params& W,
                               const PackedSet& pk, int b, unsigned k0, unsigned k1,
                               const float* __restrict__ x, float* __restrict__ y) {
  const int L = sh.L, D = sh.D, hd = sh.hd, SBD = sh.SBD, SBQ = sh.SBQ, SBI = sh.SBI,
            FD = sh.FD, LSf = sh.LSf;
  bf16* qkv = m.qkv;
  const float *bq = W.p[BQ], *bk = W.p[BK], *bv = W.p[BV];
  mma_product(SmemA<false>{m.xb, SBD, L}, PackedB{pk.p[PQKV], pk.kt[PQKV], 0, 0}, L, 3 * D, D,
              [&](int l, int c, float v) {
                const float bias = c < D ? __ldg(bq + c)
                                         : (c < 2 * D ? __ldg(bk + c - D) : __ldg(bv + c - 2 * D));
                qkv[l * SBQ + c] = to_bf(v + bias);
              });
  __syncthreads();
  // attention, head by head; the next head's scores beside this head's P v
  tc_scores(m, sh, 0);
  __syncthreads();
  bf16* ctx = m.ctx;
  for (int h = 0; h < sh.H; ++h) {
    tc_softmax(m, sh, sh.attn_rate <= 0.0f);
    __syncthreads();
    if (sh.attn_rate > 0.0f) {
      tc_keep_probs(m, sh, b, h, k0, k1);
      __syncthreads();
    }
    mma_product(SmemA<false>{pb(m), 2 * LSf, L}, HeadB<true>{qkv + 2 * D + h * hd, SBQ, L}, L,
                hd, L, [&](int i, int d, float v) { ctx[i * SBD + h * hd + d] = to_bf(v); });
    if (h + 1 < sh.H) tc_scores(m, sh, h + 1);
    __syncthreads();
  }
  // output projection, dropout, residual, LayerNorm 1
  float* xh1 = m.xh1;
  const float* bo = W.p[BO];
  mma_product(SmemA<false>{ctx, SBD, L}, PackedB{pk.p[PO], pk.kt[PO], 0, 0}, L, D, D,
              [&](int l, int n, float v) { xh1[l * FD + n] = v + __ldg(bo + n); });
  __syncthreads();
  const float* xs = x + (size_t)b * L * D;
  for_keep(L, D, sh.rate, b, sh.H, sh.layer, k0, k1,
           [&](int l, int n, float mk) {
             xh1[l * FD + n] = __ldg(xs + l * D + n) + xh1[l * FD + n] * mk;
           });
  __syncthreads();
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float *g = W.p[LN1G], *bb = W.p[LN1B];
#pragma unroll 1
    for (int l = warp; l < L; l += kWarps) {
      float* s = xh1 + l * FD;
      float sum = 0.0f;
#pragma unroll 1
      for (int d = lane; d < D; d += 32) sum += s[d];
      const float mu = warp_sum(sum) / D;
      float sq = 0.0f;
#pragma unroll 1
      for (int d = lane; d < D; d += 32) {
        const float c = s[d] - mu;
        sq += c * c;
      }
      const float inv = 1.0f / sqrtf(warp_sum(sq) / D + sh.eps);
      if (lane == 0) m.inv1[l] = inv;
#pragma unroll 1
      for (int d = lane; d < D; d += 32) {
        const float xh = (s[d] - mu) * inv;
        s[d] = xh;
        m.a1b[l * SBD + d] = to_bf(xh * __ldg(g + d) + __ldg(bb + d));
      }
    }
  }
  __syncthreads();
  // FFN in chunks of IC inner columns, its output summed in t2
  float* t2 = m.t2;
  bf16* fa = m.fa;
  const float *b1 = W.p[FF1B], *b2 = W.p[FF2B];
  const int act = sh.act;
  for (int c0 = 0; c0 < sh.I; c0 += sh.IC) {
    const int ic = min(sh.IC, sh.I - c0);
    mma_product(SmemA<false>{m.a1b, SBD, L}, PackedB{pk.p[P1], pk.kt[P1], c0 >> 3, 0}, L, ic, D,
                [&](int l, int c, float v) {
                  fa[l * SBI + c] = to_bf(tc_act(act, v + __ldg(b1 + c0 + c)));
                });
    __syncthreads();
    const bool first = c0 == 0;
    mma_product(SmemA<false>{fa, SBI, L}, PackedB{pk.p[P2], pk.kt[P2], 0, c0 >> 4}, L, D, ic,
                [&](int l, int n, float v) {
                  if (first) t2[l * FD + n] = v + __ldg(b2 + n);
                  else t2[l * FD + n] += v;
                });
    __syncthreads();
  }
  const float *g1 = W.p[LN1G], *be1 = W.p[LN1B];
  for_keep(L, D, sh.rate, b, sh.H + 1, sh.layer, k0, k1, [&](int l, int n, float mk) {
    t2[l * FD + n] = (xh1[l * FD + n] * __ldg(g1 + n) + __ldg(be1 + n)) + t2[l * FD + n] * mk;
  });
  __syncthreads();
  if (KEEP)
    tc_ln_rows(t2, FD, nullptr, 0, true, m.inv2, W.p[LN2G], W.p[LN2B], L, D, sh.eps);
  else
    tc_ln_rows(t2, FD, y + (size_t)b * L * D, D, false, nullptr, W.p[LN2G], W.p[LN2B], L, D,
               sh.eps);
  __syncthreads();
}

__device__ __forceinline__ void tc_load_seq(const TcSmem& m, const TcShape& sh,
                                            const float* __restrict__ x,
                                            const int* __restrict__ valid, int b) {
  const int L = sh.L, D = sh.D, nv = D >> 2;
  const float4* xs = reinterpret_cast<const float4*>(x + (size_t)b * L * D);
#pragma unroll 1
  for (int i = threadIdx.x; i < L * nv; i += blockDim.x) {
    const int l = i / nv, c = i - l * nv;
    const float4 v = xs[i];
    uint2 w;
    w.x = pack2(to_bf(v.x), to_bf(v.y));
    w.y = pack2(to_bf(v.z), to_bf(v.w));
    *reinterpret_cast<uint2*>(m.xb + l * sh.SBD + 4 * c) = w;
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x) m.valid[j] = valid[(size_t)b * L + j];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
trm_layer_bf16_fwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                          PackedSet pk, const long long* __restrict__ seed, TcShape sh,
                          TcLayout lay, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  const TcSmem m = tc_carve(reinterpret_cast<char*>(smem4), lay);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    tc_load_seq(m, sh, x, valid, b);
    tc_forward_seq<false>(m, sh, W, pk, b, k0, k1, x, y);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
trm_layer_bf16_bwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                          PackedSet pk, const long long* __restrict__ seed, TcShape sh,
                          TcLayout lay, const float* __restrict__ dy, float* __restrict__ dx,
                          float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const TcSmem m = tc_carve(reinterpret_cast<char*>(smem4), lay);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  const int L = sh.L, D = sh.D, I = sh.I, hd = sh.hd, SBD = sh.SBD, SBQ = sh.SBQ,
            SBI = sh.SBI, FD = sh.FD, LSf = sh.LSf, act = sh.act;
  const Offsets off = grad_offsets(D, I);
  float* G = partials + (size_t)blockIdx.x * off.o[kNumParams];
  for (int i = threadIdx.x; i < off.o[kNumParams]; i += blockDim.x) G[i] = 0.0f;
  __syncthreads();
  const int gbq = off.o[BQ], gbk = off.o[BK], gbv = off.o[BV];
  float *dr = m.dr, *t2 = m.t2, *xh1 = m.xh1;
  bf16 *df2b = m.df2b, *df1 = m.df1, *fa = m.fa, *dqkv = m.dqkv, *dctx = m.dctx;

  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    tc_load_seq(m, sh, x, valid, b);
    tc_forward_seq<true>(m, sh, W, pk, b, k0, k1, x, nullptr);   // t2 = xhat2

    // LayerNorm 2
    tc_load_rows(dr, FD, dy + (size_t)b * L * D, L, D);
    __syncthreads();
    tc_colsum_add(G + off.o[LN2G], dr, t2, FD, L, D);
    tc_colsum_add(G + off.o[LN2B], dr, nullptr, FD, L, D);
    __syncthreads();
    tc_ln_bwd_rows(dr, t2, m.inv2, W.p[LN2G], FD, L, D);        // dr = dr2
    __syncthreads();
    // FFN: df2 (fp32 in t2, bf16 in df2b); dr becomes da1
    for_keep(L, D, sh.rate, b, sh.H + 1, sh.layer, k0, k1, [&](int l, int n, float mk) {
      const float v = dr[l * FD + n] * mk;
      t2[l * FD + n] = v;
      df2b[l * SBD + n] = to_bf(v);
    });
    __syncthreads();
    tc_colsum_add(G + off.o[FF2B], t2, nullptr, FD, L, D);
    const float* b1 = W.p[FF1B];
    float* gb1 = G + off.o[FF1B];
    for (int c0 = 0; c0 < I; c0 += sh.IC) {
      const int ic = min(sh.IC, I - c0);
      // f1 = a1 W1 + b1 and dfa = df2 W2^T on the same tiles: fa = act(f1),
      // df1 = dfa act'(f1), and the FFN bias gradient, a column at a time
      mma_dual(SmemA<false>{m.a1b, SBD, L}, PackedB{pk.p[P1], pk.kt[P1], c0 >> 3, 0},
               SmemA<false>{df2b, SBD, L}, PackedB{pk.p[P2T], pk.kt[P2T], c0 >> 3, 0}, L, ic, D,
               [&](int l, int c, float v1, float v2) {
                 const float f1 = v1 + __ldg(b1 + c0 + c);
                 const float2 ag = tc_act2(act, f1);
                 fa[l * SBI + c] = to_bf(ag.x);
                 const float d = v2 * ag.y;
                 df1[l * SBI + c] = to_bf(d);
                 return d;
               },
               [&](int c, float sum) { gb1[c0 + c] += sum; });
      __syncthreads();
      mma_product_add(SmemA<true>{fa, SBI, L}, SmemB<true>{df2b, SBD, L}, ic, D, L,
                      G + off.o[FF2W] + (size_t)c0 * D, D);
      mma_product_add(SmemA<true>{m.a1b, SBD, L}, SmemB<true>{df1, SBI, L}, D, ic, L,
                      G + off.o[FF1W] + c0, I);
      mma_product(SmemA<false>{df1, SBI, L}, PackedB{pk.p[P1T], pk.kt[P1T], 0, c0 >> 4}, L, D,
                  ic, [&](int l, int n, float v) { dr[l * FD + n] += v; });
      __syncthreads();
    }
    // LayerNorm 1
    tc_colsum_add(G + off.o[LN1G], dr, xh1, FD, L, D);
    tc_colsum_add(G + off.o[LN1B], dr, nullptr, FD, L, D);
    __syncthreads();
    tc_ln_bwd_rows(dr, xh1, m.inv1, W.p[LN1G], FD, L, D);       // dr = dr1
    __syncthreads();
    // attention output projection: dattn (fp32 and bf16), then dWo and dctx
    float* dattn = m.dattn;
    bf16* dattnb = m.dattnb;
    for_keep(L, D, sh.rate, b, sh.H, sh.layer, k0, k1, [&](int l, int n, float mk) {
      const float v = dr[l * FD + n] * mk;
      dattn[l * FD + n] = v;
      dattnb[l * SBD + n] = to_bf(v);
    });
    __syncthreads();
    tc_colsum_add(G + off.o[BO], dattn, nullptr, FD, L, D);
    mma_product_add(SmemA<true>{m.ctx, SBD, L}, SmemB<true>{dattnb, SBD, L}, D, D, L,
                    G + off.o[WO], D);
    mma_product(SmemA<false>{dattnb, SBD, L}, PackedB{pk.p[POT], pk.kt[POT], 0, 0}, L, D, D,
                [&](int l, int n, float v) { dctx[l * SBD + n] = to_bf(v); });
    __syncthreads();
    // attention, head by head: dq | dk | dv into dqkv
    bf16* P = pb(m);
    float* dp = m.Pdp;
    const bf16* qkv = m.qkv;
    for (int h = 0; h < sh.H; ++h) {
      const int ho = h * hd;
      tc_scores(m, sh, h);
      __syncthreads();
      tc_softmax(m, sh, sh.attn_rate <= 0.0f);                  // S = p0
      __syncthreads();
      if (sh.attn_rate > 0.0f) {
        tc_keep_probs(m, sh, b, h, k0, k1);
        __syncthreads();
      }
      // dv = P^T dO, and the row sums of P
      mma_product(SmemA<true>{P, 2 * LSf, L}, HeadB<true>{dctx + ho, SBD, L}, L, hd, L,
                  [&](int j, int d, float v) { dqkv[j * SBQ + 2 * D + ho + d] = to_bf(v); });
      {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
        for (int i = warp; i < L; i += kWarps) {
          float sum = 0.0f;
#pragma unroll 1
          for (int j = lane; j < L; j += 32) sum += from_bf(P[i * 2 * LSf + j]);
          sum = warp_sum(sum);
          if (lane == 0) m.psum[i] = sum;
        }
      }
      __syncthreads();
      // dp = dO v^T (over P's rows)
      mma_product(HeadA{dctx + ho, SBD, L}, HeadB<false>{qkv + 2 * D + ho, SBQ, L}, L, L, hd,
                  [&](int i, int j, float v) { dp[i * LSf + j] = v; });
      __syncthreads();
      if (sh.attn_rate > 0.0f) {
        for_keep(L, L, sh.attn_rate, b, h, sh.layer, k0, k1,
                 [&](int i, int j, float mk) { dp[i * LSf + j] *= mk; });
        __syncthreads();
      }
      // ds = p0 (dp - sum_j dp p0) scale, written as bf16 over dp's own row
      {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        constexpr int kR = kMaxRowBf16 / 32;
        for (int i = warp; i < L; i += kWarps) {
          float dv[kR], pv[kR];
          float sum = 0.0f;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int j = lane + 32 * r;
            dv[r] = j < L ? dp[i * LSf + j] : 0.0f;
            pv[r] = j < L ? m.S[i * LSf + j] : 0.0f;
            sum += dv[r] * pv[r];
          }
          sum = warp_sum(sum);
          __syncwarp();
          float rs = 0.0f;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int j = lane + 32 * r;
            if (j < L) {
              const bf16 d = to_bf(pv[r] * (dv[r] - sum) * sh.scale);
              P[i * 2 * LSf + j] = d;
              rs += from_bf(d);
            }
          }
          rs = warp_sum(rs);
          if (lane == 0) m.rsum[i] = rs;
        }
      }
      __syncthreads();
      // dq = ds k, dk = ds^T q, and the column sums of ds
      mma_product(SmemA<false>{P, 2 * LSf, L}, HeadB<true>{qkv + D + ho, SBQ, L}, L, hd, L,
                  [&](int i, int d, float v) { dqkv[i * SBQ + ho + d] = to_bf(v); });
      mma_product(SmemA<true>{P, 2 * LSf, L}, HeadB<true>{qkv + ho, SBQ, L}, L, hd, L,
                  [&](int j, int d, float v) { dqkv[j * SBQ + D + ho + d] = to_bf(v); });
      for (int j = threadIdx.x; j < L; j += blockDim.x) {
        float sum = 0.0f;
#pragma unroll 4
        for (int i = 0; i < L; ++i) sum += from_bf(P[i * 2 * LSf + j]);
        m.csum[j] = sum;
      }
      __syncthreads();
      // bias gradients of q, k, v: sum_l dq[l] = colsum(ds) k, sum_j dk[j] =
      // rowsum(ds) q, sum_j dv[j] = rowsum(P) dO
      for (int t = threadIdx.x; t < 3 * hd; t += blockDim.x) {
        const int w = t / hd, d = t - w * hd;
        const float* vec = w == 0 ? m.csum : (w == 1 ? m.rsum : m.psum);
        const bf16* col = w == 0 ? qkv + D + ho + d : (w == 1 ? qkv + ho + d : dctx + ho + d);
        const int ld = w == 2 ? SBD : SBQ;
        float sum = 0.0f;
#pragma unroll 4
        for (int i = 0; i < L; ++i) sum += vec[i] * from_bf(col[i * ld]);
        G[(w == 0 ? gbq : (w == 1 ? gbk : gbv)) + ho + d] += sum;
      }
      // (the next head's first writes of csum, rsum and psum come after two
      // barriers)
    }
    __syncthreads();
    // projections: dWq | dWk | dWv = x^T dqkv, dx = dr1 + dqkv [Wq | Wk | Wv]^T
    mma_product_add(SmemA<true>{m.xb, SBD, L}, SmemB<true>{dqkv, SBQ, L}, D, D, L,
                    G + off.o[WQ], D);
    mma_product_add(SmemA<true>{m.xb, SBD, L}, SmemB<true>{dqkv + D, SBQ, L}, D, D, L,
                    G + off.o[WK], D);
    mma_product_add(SmemA<true>{m.xb, SBD, L}, SmemB<true>{dqkv + 2 * D, SBQ, L}, D, D, L,
                    G + off.o[WV], D);
    float* dxs = dx + (size_t)b * L * D;
    mma_product(SmemA<false>{dqkv, SBQ, L}, PackedB{pk.p[PQKVT], pk.kt[PQKVT], 0, 0}, L, D, 3 * D,
                [&](int l, int n, float v) { dxs[l * D + n] = dr[l * FD + n] + v; });
    __syncthreads();
  }
}

// ==================================================================== shared

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

int check_widths(int B, int L, int D, int H, int I, int act, float attn_rate, float rate,
                 int bf16) {
  if (B < 1 || L < 1 || D < 4 || H < 1 || I < 4 || D % H || D % 4 || (D / H) % 4 || I % 4 ||
      act < GELU || act > SIGMOID || attn_rate < 0.f || attn_rate >= 1.f || rate < 0.f ||
      rate >= 1.f || (bf16 && L > kMaxRowBf16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int make_shape(int B, int L, int D, int H, int I, int causal, int act, float eps,
               float attn_rate, float rate, int layer, Shape* sh) {
  const int err = check_widths(B, L, D, H, I, act, attn_rate, rate, 0);
  if (err) return err;
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

int make_tc_shape(int B, int L, int D, int H, int I, int causal, int act, float eps,
                  float attn_rate, float rate, int layer, TcShape* sh) {
  const int err = check_widths(B, L, D, H, I, act, attn_rate, rate, 1);
  if (err) return err;
  sh->B = B; sh->L = L; sh->D = D; sh->H = H; sh->I = I;
  sh->hd = D / H;
  sh->IC = I < kChunk ? I : kChunk;  // the backward kernel's is set at its launch
  sh->SBD = sb(D);
  sh->SBQ = sb(3 * D);
  sh->SBI = sb(sh->IC);
  sh->FD = D + 4;
  sh->LSf = score_stride(L);
  sh->causal = causal; sh->act = act; sh->eps = eps;
  sh->scale = 1.0f / sqrtf((float)sh->hd);
  sh->attn_rate = attn_rate; sh->rate = rate; sh->layer = layer;
  return 0;
}

size_t smem_bytes(int L, int D, int I, bool backward, bool bf16) {
  return bf16 ? tc_layout(L, D, I, backward).total : sizeof(float) * smem_floats(L, D, I, backward);
}

// The fp32 instance's transposed weights in ``scratch`` (4 D^2 + 2 D I
// floats), for the backward's products against W^T.
int prep_weights(const Params& W, Params* Wt, float* scratch, int D, int I, cudaStream_t stream) {
  *Wt = W;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int mats[kNumMats] = {WQ, WK, WV, WO, FF1W, FF2W};
  PrepJob job;
  job.start[0] = 0;
  for (int i = 0; i < kNumMats; ++i) {
    job.in[i] = W.p[mats[i]];
    job.rows[i] = mats[i] == FF2W ? I : D;
    job.cols[i] = mats[i] == FF1W ? I : D;
    job.start[i + 1] = job.start[i] + job.rows[i] * job.cols[i];
    Wt->p[mats[i]] = scratch + job.start[i];
  }
  prep_weights_kernel<<<(job.start[kNumMats] + 255) / 256, 256, 0, stream>>>(job, scratch);
  return (int)cudaGetLastError();
}

// The bf16 instance's packed weights: the forward's four (W), then, for the
// backward, the four transposed (W^T); their uint2 count when ``out`` is
// null, else the launch's error code.
long long pack_weights(const Params& W, int D, int I, bool backward, uint2* out, PackedSet* pk,
                       cudaStream_t stream) {
  PackJob job;
  job.count = backward ? kNumPacked : 4;
  // logical W: rows, cols, split; the source pointers
  struct Src { int rows, cols, split; const float* p[3]; };
  const Src qkv = {D, 3 * D, D, {W.p[WQ], W.p[WK], W.p[WV]}};
  const Src wo = {D, D, 0, {W.p[WO], nullptr, nullptr}};
  const Src w1 = {D, I, 0, {W.p[FF1W], nullptr, nullptr}};
  const Src w2 = {I, D, 0, {W.p[FF2W], nullptr, nullptr}};
  const Src* srcs[kNumPacked] = {&qkv, &wo, &w1, &w2, &wo, &w2, &w1, &qkv};
  long long start = 0;
  for (int i = 0; i < job.count; ++i) {
    PackMat& m = job.m[i];
    const Src& s = *srcs[i];
    m.trans = i >= 4;
    m.rows = s.rows;
    m.cols = s.cols;
    m.split = s.split;
    for (int j = 0; j < 3; ++j) m.src[j] = s.p[j];
    m.K = m.trans ? s.cols : s.rows;
    m.N = m.trans ? s.rows : s.cols;
    m.start = start;
    if (pk) {
      pk->p[i] = out ? out + start : nullptr;
      pk->kt[i] = (m.K + 15) / 16;
    }
    start += packed_size(m.K, m.N);
  }
  job.total = start;
  if (!out) return start;
  const long long blocks = (start + 255) / 256;
  pack_weights_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(job, out);
  return (long long)cudaGetLastError();
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

int grid_of(bool bf16, bool backward, size_t smem, int B, int* grid) {
  if (bf16)
    return backward ? plan_grid(trm_layer_bf16_bwd_kernel, smem, B, grid)
                    : plan_grid(trm_layer_bf16_fwd_kernel, smem, B, grid);
  return backward ? plan_grid(trm_layer_bwd_kernel, smem, B, grid)
                  : plan_grid(trm_layer_fwd_kernel, smem, B, grid);
}

}  // namespace

// Shared-memory bytes a block of the fp32 instance needs for these widths,
// forward or backward.
extern "C" long long trm_layer_smem_bytes(int L, int D, int I, int backward) {
  return (long long)smem_bytes(L, D, I, backward != 0, false);
}

// The same for the bf16 instance.
extern "C" long long trm_layer_smem_bytes_bf16(int L, int D, int I, int backward) {
  return (long long)smem_bytes(L, D, I, backward != 0, true);
}

// Floats of weight scratch a call needs: the fp32 instance's transposed
// weights (backward only), or the bf16 instance's packed weights.
extern "C" long long trm_layer_scratch_floats(int D, int I, int bf16, int backward) {
  if (!bf16) return backward ? 4LL * D * D + 2LL * D * I : 0;
  Params W = {};
  return pack_weights(W, D, I, backward != 0, nullptr, nullptr, 0) * 2;
}

// The number of blocks the forward or the backward launches for B sequences
// (the backward's partials are (blocks, P)), or minus the CUDA error code:
// cudaErrorInvalidValue for widths outside the limits,
// cudaErrorInvalidConfiguration when the working set exceeds the shared
// memory a block may have.
extern "C" int trm_layer_blocks(int B, int L, int D, int H, int I, int bf16, int backward) {
  int err = check_widths(B, L, D, H, I, 0, 0.f, 0.f, bf16);
  if (err) return -err;
  int grid = 0;
  err = grid_of(bf16 != 0, backward != 0, smem_bytes(L, D, I, backward != 0, bf16 != 0), B, &grid);
  return err ? -err : grid;
}

// x (B, L, D) f32, valid (B, L) int32, params 16 device pointers in the order
// of enum Param (all f32, contiguous), seed one int64 on the device (null
// when both rates are 0), wr trm_layer_scratch_floats(D, I, bf16, 0) floats
// of scratch (null when that is 0), y (B, L, D) f32. Returns the CUDA error
// code.
extern "C" int trm_layer_fwd(const float* x, const int* valid, const void* const* params,
                             const void* seed, int B, int L, int D, int H, int I, int causal,
                             int act, float eps, float attn_rate, float rate, int layer,
                             int bf16, float* wr, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params W;
  for (int i = 0; i < kNumParams; ++i) W.p[i] = static_cast<const float*>(params[i]);
  const long long* sd = static_cast<const long long*>(seed);
  const size_t smem = smem_bytes(L, D, I, false, bf16 != 0);
  int grid = 0, err;
  if (bf16) {
    TcShape sh;
    err = make_tc_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, &sh);
    if (err) return err;
    err = grid_of(true, false, smem, B, &grid);
    if (err) return err;
    if (!wr) return (int)cudaErrorInvalidValue;
    PackedSet pk;
    err = (int)pack_weights(W, D, I, false, reinterpret_cast<uint2*>(wr), &pk, s);
    if (err) return err;
    trm_layer_bf16_fwd_kernel<<<grid, kThreads, smem, s>>>(x, valid, W, pk, sd, sh,
                                                           tc_layout(L, D, I, false), y);
    return (int)cudaGetLastError();
  }
  Shape sh;
  err = make_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, &sh);
  if (err) return err;
  err = grid_of(false, false, smem, B, &grid);
  if (err) return err;
  trm_layer_fwd_kernel<<<grid, kThreads, smem, s>>>(x, valid, W, sd, sh, y);
  return (int)cudaGetLastError();
}

// As trm_layer_fwd, with dy (B, L, D) in and dx (B, L, D) out; wr is scratch
// of trm_layer_scratch_floats(D, I, bf16, 1) floats; partials is scratch of
// trm_layer_blocks(..., backward = 1) x P floats and grads the (P,) output,
// the 16 gradients one after the other in the order of enum Param (P = 4 D^2
// + 2 D I + 9 D + I).
extern "C" int trm_layer_bwd(const float* x, const int* valid, const void* const* params,
                             const void* seed, int B, int L, int D, int H, int I, int causal,
                             int act, float eps, float attn_rate, float rate, int layer,
                             int bf16, float* wr, const float* dy, float* dx, float* partials,
                             float* grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params W;
  for (int i = 0; i < kNumParams; ++i) W.p[i] = static_cast<const float*>(params[i]);
  const long long* sd = static_cast<const long long*>(seed);
  const size_t smem = smem_bytes(L, D, I, true, bf16 != 0);
  int grid = 0, err;
  if (bf16) {
    TcShape sh;
    err = make_tc_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, &sh);
    if (err) return err;
    err = grid_of(true, true, smem, B, &grid);
    if (err) return err;
    if (!wr) return (int)cudaErrorInvalidValue;
    PackedSet pk;
    err = (int)pack_weights(W, D, I, true, reinterpret_cast<uint2*>(wr), &pk, s);
    if (err) return err;
    sh.IC = tc_chunk(I, true);
    sh.SBI = sb(sh.IC);
    trm_layer_bf16_bwd_kernel<<<grid, kThreads, smem, s>>>(x, valid, W, pk, sd, sh,
                                                           tc_layout(L, D, I, true), dy, dx,
                                                           partials);
  } else {
    Shape sh;
    err = make_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, &sh);
    if (err) return err;
    err = grid_of(false, true, smem, B, &grid);
    if (err) return err;
    Params Wt;
    err = prep_weights(W, &Wt, wr, D, I, s);
    if (err) return err;
    trm_layer_bwd_kernel<<<grid, kThreads, smem, s>>>(x, valid, W, Wt, sd, sh, dy, dx, partials);
  }
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
