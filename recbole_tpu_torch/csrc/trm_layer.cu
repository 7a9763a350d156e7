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
// ---------------------------------------------------------- fp32 instance
// trm_layer_tf32x3_fwd_kernel / trm_layer_tf32x3_bwd_kernel
// (fused_transformer_layer, row 6). The same layer with fp32 operands, as
// the JAX kernel computes it, held to fp32's precision (2e-4 of each
// tensor's largest value against the plain version, as the FMA loops it
// replaced were): the bf16 instance's body, templated on the operand type,
// instantiated on fp32 copies, every product run as three TF32 products on
// the tensor cores.
//
// What bounds it on the H100 (SASRec's step): the work is the bf16
// instance's, 10.7 GFLOP forward and 32.2 backward. Three dense TF32
// products (494.7 TFLOP/s each) make 165 TFLOP/s of fp32-exact products, so
// the operations bound the forward at 0.065 ms and the backward at 0.195;
// the kernel table keeps the bound of the same work on the CUDA cores (67
// TFLOP/s). As in the bf16 instance, what the card spends is the latency of
// about 30 barrier-ended phases a sequence and the fetch of their code, now
// with three mma and the split of A a k-step of 8, and twice the bytes of
// every operand, so the working set decides how many blocks hide each
// other's barriers.
//
// Design, point by point:
//  * 3xTF32 (Mma<float>): x = hi + lo with hi = x's top 19 bits (a tf32
//    value) and lo = x - hi exact, whose low bits the tensor cores drop; a
//    k-step of 8 is a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, about
//    2^-20 of the product, is dropped), three mma.sync.m16n8k8 into one
//    accumulator, the small terms first. A product keeps about 2^-19 of
//    |a b|. Rounding both parts (cvt.rna.tf32.f32, five operations an
//    element in place of two) made both kernels 20% slower, and three
//    accumulators no faster (PERF.md §6).
//  * The structure is the bf16 instance's (the same functions, the operand
//    type a template parameter: Mma<E>, the loaders, task_mma, tc_layout):
//    short loops, K masked in the fragments and rows clamped,
//    weight-gradient adds that load their old values before the product,
//    the q, k and v bias gradients from row and column sums of P and ds.
//    One difference: a warp task is two 16 x 8 tiles side by side
//    (Mma<float>::kStrips), so the A fragment and its split serve two
//    strips and two mma chains run beside each other (one tile a task was
//    12% slower forward and 6% backward), B 2 k-steps deep to stay within
//    64 registers. Its kernels' code is under two thirds of the FMA loops'
//    (PERF.md §6 has the sizes).
//  * Operands are fp32 copies in shared memory, rows D + 4 floats long (4
//    mod 8 at D a multiple of 8). A row-major A ([m][k]) or B ([n][k]) is
//    read by ldmatrix: an 8 x 8 matrix of 16-bit elements is 8 x 4 fp32,
//    and the register ldmatrix gives a lane is the tf32 fragment's element.
//    A head starts at a multiple of 4 floats, 16 bytes, so ldmatrix reads
//    its slices too. ldmatrix cannot transpose 32-bit elements, so a
//    transposed operand (the weight gradients' A^T, P^T and ds^T, and every
//    [k][n] B) is read with 32-bit loads, 2-way bank conflicts at that
//    stride. A is split into hi and lo at its one use; split copies in
//    shared memory would double the working set.
//  * The weights: pack_weights_kernel<float> writes the six matrices once a
//    call as W and W^T in the order of the m16n8k8 B fragments, hi and lo
//    side by side, so a lane's k-step is one 16-byte load: 786 KB at
//    SASRec's widths, read from L2 and L1 (asking L1 for the next batch
//    ahead of its loads was slower).
//  * Two blocks an SM, both ways (tc_layout_f32): the copies are the fp32
//    values themselves, so df2b is t2, dattnb is dattn and the forward's
//    xhat1 is a1, and every buffer but the (L,) vectors takes the room of
//    those dead in its phase. The backward does not keep q | k | v through
//    its FFN: it recomputes them beside the output projection's products
//    from x read again, sends the residual cotangent to dx in device memory
//    once dattn is made, and reads x once more for the projections'
//    gradients. At SASRec's shape a block takes 74,288 bytes forward and
//    114,112 backward (one block an SM took 149,312 and ran the backward
//    10% slower). The FFN pair of products in the backward (f1 and dfa)
//    runs as tile tasks on every warp, the FFN bias gradient summed from
//    the exact df1 after the barrier (a warp a strip, as the bf16 instance
//    sums its fp32 values in the epilogue, was 8% slower). 768 or 1,024
//    threads a block at one block an SM were no faster.
//
// Limits, both instances: D, D / H and I multiples of 4, L <= 256, and the
// working set (tc_layout) within the card's opt-in shared memory. Any B.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// 512 threads a block in every kernel: 256 and 384 were slower, and 768 or
// 1,024 in the fp32 backward no faster (PERF.md §6)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;       // the bf16 forward's FFN inner columns per chunk
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNumParams = 16;
constexpr int kMaxRow = 256;      // most positions (the ds pass keeps a row in registers)

enum Param { WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, FF1W, FF1B, FF2W, FF2B, LN2G, LN2B };
enum Act { GELU, RELU, SWISH, TANH, SIGMOID };

struct Params {
  const float* p[kNumParams];
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

// ---------------------------------------------------------------- row helpers

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

// ========================================================= tensor-core products

typedef __nv_bfloat16 bf16;

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

// c += a b: one m16n8k8 tile, tf32 operands, fp32 sums
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for 3xTF32: hi is x's top 19 bits (a tf32 value, x cut
// toward 0, |x - hi| < 2^-10 |x|), lo the exact remainder, whose low bits
// the tensor cores drop (< 2^-20 |x|). Two ALU operations where rounding
// both parts (cvt.rna.tf32.f32 twice) took five and made the fp32 kernels
// 20% slower (PERF.md §6); a product keeps about 2^-19 of |a b|
// against 2^-21 with rounding, both far inside the 2e-4 the kernels are
// held to.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <typename E>
__device__ __forceinline__ E to_e(float v);
template <>
__device__ __forceinline__ bf16 to_e<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float to_e<float>(float v) { return v; }
__device__ __forceinline__ float from_e(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_e(float v) { return v; }

// the fp32 instance: operands are fp32 copies and every product is 3xTF32
template <typename E>
constexpr bool kF32 = sizeof(E) == 4;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// a fragment register holding k = kk and kk + 1: those at or past K read as 0
__device__ __forceinline__ uint32_t kmask(uint32_t v, int kk, int K) {
  return kk >= K ? 0u : (kk + 1 >= K ? (v & 0xffffu) : v);
}

// One k-step of a warp's 16 x 8 output tile, for each operand type: the
// fragments as the loaders give them, the product, and the mask of k at or
// past K. Fragments follow mma's register order: with gr = lane / 4 and
// q = lane % 4, bf16 a holds rows gr, gr + 8 by k 2q, 2q + 8 (pairs), b k
// 2q, 2q + 8 (pairs) by column gr; tf32 a holds rows gr, gr + 8 by k q,
// q + 4, b k q, q + 4 by column gr.
template <typename E>
struct Mma;

// bf16: one m16n8k16 a k-step
template <>
struct Mma<bf16> {
  static constexpr int kK = 16, kShift = 4, kKB = 4, kStrips = 1;
  typedef uint2 Packed;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  struct Acc {
    float c[4];
  };
  static __device__ __forceinline__ void zero(Acc& c) {
    c.c[0] = c.c[1] = c.c[2] = c.c[3] = 0.0f;
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B& b) {
    mma16816(c.c, a.r, b.r[0], b.r[1]);
  }
  static __device__ __forceinline__ void mask(A& a, B& b, int k0, int K) {
    const int lo = k0 + 2 * (threadIdx.x & 3), hi = lo + 8;
    b.r[0] = kmask(b.r[0], lo, K);
    b.r[1] = kmask(b.r[1], hi, K);
    a.r[0] = kmask(a.r[0], lo, K);
    a.r[1] = kmask(a.r[1], lo, K);
    a.r[2] = kmask(a.r[2], hi, K);
    a.r[3] = kmask(a.r[3], hi, K);
  }
  static __device__ __forceinline__ void result(const Acc& c, float out[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = c.c[e];
  }
};

// 3xTF32: a k-step of 8 is a_lo b_hi + a_hi b_lo + a_hi b_hi, three
// m16n8k8 products into one accumulator, the small terms first. B comes
// split (packed weights, or split at its load); A is split here, at its one
// use. (Three accumulators, one a term, so that their chains run side by
// side, were no faster at 64 registers a thread: PERF.md §6.)
template <>
struct Mma<float> {
  static constexpr int kK = 8, kShift = 3, kKB = 2, kStrips = 2;
  typedef uint4 Packed;  // hi(k q), hi(k q + 4), lo(k q), lo(k q + 4)
  struct A {
    float r[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  struct Acc {
    float c[4];
  };
  static __device__ __forceinline__ void zero(Acc& c) {
    c.c[0] = c.c[1] = c.c[2] = c.c[3] = 0.0f;
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B& b) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a.r[e], ah[e], al[e]);
    mma1688(c.c, al, b.hi[0], b.hi[1]);
    mma1688(c.c, ah, b.lo[0], b.lo[1]);
    mma1688(c.c, ah, b.hi[0], b.hi[1]);
  }
  static __device__ __forceinline__ void mask(A& a, B& b, int k0, int K) {
    const int k = k0 + (threadIdx.x & 3);
    if (k >= K) {
      a.r[0] = a.r[1] = 0.0f;
      b.hi[0] = b.lo[0] = 0u;
    }
    if (k + 4 >= K) {
      a.r[2] = a.r[3] = 0.0f;
      b.hi[1] = b.lo[1] = 0u;
    }
  }
  static __device__ __forceinline__ void result(const Acc& c, float out[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = c.c[e];
  }
};

__device__ __forceinline__ void split_b(float v0, float v1, Mma<float>::B& b) {
  split_tf32(v0, b.hi[0], b.lo[0]);
  split_tf32(v1, b.hi[1], b.lo[1]);
}

// Operand loaders. An A loader gives the 16 x kK fragment at rows m0, k0; a
// B loader the kK x 8 fragment at k0, columns n0. Rows past ``rows`` are
// clamped to the last one: what they give reaches only outputs past M or N,
// which are dropped, or k past K, which is masked. Elem names the operand
// type, and so the products' Mma.

// A from a matrix in shared memory, rows 16-byte aligned: [m][k], or [k][m]
// when T (A^T of what is stored). bf16: ldmatrix (.trans when T); fp32:
// ldmatrix of 8 x 4 fp32 blocks, or, when T, 32-bit loads (ldmatrix moves
// 16-bit elements and cannot transpose 32-bit ones)
template <typename E, bool T>
struct SmemA;

template <bool T>
struct SmemA<bf16, T> {
  typedef bf16 Elem;
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int m0, int k0, Mma<bf16>::A& a) const {
    const int lane = threadIdx.x & 31, mat = lane >> 3, i = lane & 7;
    if (!T) {
      const int row = min(m0 + i + (mat & 1) * 8, rows - 1);
      ldsm_x4(p + row * ld + k0 + (mat >> 1) * 8, a.r);
    } else {
      const int row = min(k0 + i + (mat >> 1) * 8, rows - 1);
      ldsm_x4_t(p + row * ld + m0 + (mat & 1) * 8, a.r);
    }
  }
};

template <>
struct SmemA<float, false> {
  typedef float Elem;
  const float* p;
  int ld, rows;
  __device__ __forceinline__ void load(int m0, int k0, Mma<float>::A& a) const {
    const int lane = threadIdx.x & 31, mat = lane >> 3, i = lane & 7;
    const int row = min(m0 + i + (mat & 1) * 8, rows - 1);
    uint32_t r[4];
    ldsm_x4(p + row * ld + k0 + (mat >> 1) * 4, r);
#pragma unroll
    for (int e = 0; e < 4; ++e) a.r[e] = __uint_as_float(r[e]);
  }
};

template <>
struct SmemA<float, true> {
  typedef float Elem;
  const float* p;
  int ld, rows;
  __device__ __forceinline__ void load(int m0, int k0, Mma<float>::A& a) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3, last = rows - 1;
    const float* r0 = p + min(k0 + q, last) * ld + m0 + gr;
    const float* r4 = p + min(k0 + q + 4, last) * ld + m0 + gr;
    a.r[0] = r0[0];
    a.r[1] = r0[8];
    a.r[2] = r4[0];
    a.r[3] = r4[8];
  }
};

// B from a matrix in shared memory, rows 16-byte aligned: [n][k], or [k][n]
// when T; as SmemA, the fp32 instance's fragments split at the load
template <typename E, bool T>
struct SmemB;

template <bool T>
struct SmemB<bf16, T> {
  typedef bf16 Elem;
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int n0, int k0, Mma<bf16>::B& b) const {
    const int lane = threadIdx.x & 31, mat = (lane >> 3) & 1, i = lane & 7;
    if (!T) {
      const int row = min(n0 + i, rows - 1);
      ldsm_x2(p + row * ld + k0 + mat * 8, b.r[0], b.r[1]);
    } else {
      const int row = min(k0 + i + mat * 8, rows - 1);
      ldsm_x2_t(p + row * ld + n0, b.r[0], b.r[1]);
    }
  }
};

template <>
struct SmemB<float, false> {
  typedef float Elem;
  const float* p;
  int ld, rows;
  __device__ __forceinline__ void load(int n0, int k0, Mma<float>::B& b) const {
    const int lane = threadIdx.x & 31, mat = (lane >> 3) & 1, i = lane & 7;
    const int row = min(n0 + i, rows - 1);
    uint32_t v0, v1;
    ldsm_x2(p + row * ld + k0 + mat * 4, v0, v1);
    split_b(__uint_as_float(v0), __uint_as_float(v1), b);
  }
};

template <>
struct SmemB<float, true> {
  typedef float Elem;
  const float* p;
  int ld, rows;
  __device__ __forceinline__ void load(int n0, int k0, Mma<float>::B& b) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3, last = rows - 1;
    const float* c = p + n0 + gr;
    split_b(c[min(k0 + q, last) * ld], c[min(k0 + q + 4, last) * ld], b);
  }
};

// A head's slice of q, k, v or dO starts at any multiple of 4 columns. In
// bf16 that is 8 bytes, which ldmatrix (16-byte rows) cannot read: [m][k] at
// any even column, read 32 bits at a time
struct HeadA16 {
  typedef bf16 Elem;
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int m0, int k0, Mma<bf16>::A& a) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
    const bf16* r0 = p + min(m0 + gr, rows - 1) * ld + k0 + 2 * q;
    const bf16* r8 = p + min(m0 + gr + 8, rows - 1) * ld + k0 + 2 * q;
    a.r[0] = *reinterpret_cast<const uint32_t*>(r0);
    a.r[1] = *reinterpret_cast<const uint32_t*>(r8);
    a.r[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    a.r[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
  }
};

// the same as a B operand: [n][k] (32-bit loads), or [k][n] when T (16-bit)
template <bool T>
struct HeadB16 {
  typedef bf16 Elem;
  const bf16* p;
  int ld, rows;
  __device__ __forceinline__ void load(int n0, int k0, Mma<bf16>::B& b) const {
    const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
    if (!T) {
      const bf16* r = p + min(n0 + gr, rows - 1) * ld + k0 + 2 * q;
      b.r[0] = *reinterpret_cast<const uint32_t*>(r);
      b.r[1] = *reinterpret_cast<const uint32_t*>(r + 8);
    } else {
      const int k = k0 + 2 * q, c = n0 + gr, last = rows - 1;
      b.r[0] = pack2(p[min(k, last) * ld + c], p[min(k + 1, last) * ld + c]);
      b.r[1] = pack2(p[min(k + 8, last) * ld + c], p[min(k + 9, last) * ld + c]);
    }
  }
};

// a head's loaders by operand type: in fp32 a head starts on 16 bytes, so
// the full-width loaders read it
template <typename E>
struct HeadOps;
template <>
struct HeadOps<bf16> {
  typedef HeadA16 A;
  template <bool T>
  using B = HeadB16<T>;
};
template <>
struct HeadOps<float> {
  typedef SmemA<float, false> A;
  template <bool T>
  using B = SmemB<float, T>;
};
template <typename E>
using HeadA = typename HeadOps<E>::A;
template <typename E, bool T>
using HeadB = typename HeadOps<E>::template B<T>;

// B from a packed weight matrix in device memory (pack_weights_kernel): the
// fragment of strip s and k-step t is lane-contiguous at (s kt + t) 32 +
// lane, 8 bytes a lane in bf16, 16 (hi and lo) in fp32; the loader starts
// ``s0`` strips and ``t0`` k-steps in (an FFN chunk)
template <typename E>
struct PackedB {
  typedef E Elem;
  typedef typename Mma<E>::Packed Packed;
  const void* p;
  int kt, s0, t0;
  __device__ __forceinline__ void load(int n0, int k0, typename Mma<E>::B& b) const {
    const Packed v = __ldg(static_cast<const Packed*>(p) +
                           ((size_t)(s0 + (n0 >> 3)) * kt + t0 + (k0 >> Mma<E>::kShift)) * 32 +
                           (threadIdx.x & 31));
    if constexpr (kF32<E>) {
      b.hi[0] = v.x;
      b.hi[1] = v.y;
      b.lo[0] = v.z;
      b.lo[1] = v.w;
    } else {
      b.r[0] = v.x;
      b.r[1] = v.y;
    }
  }
};

// The warp's accumulators for NS 16 x 8 tiles at rows m0, columns n0 + 8 j,
// over K: the strips' B fragments kKB k-steps at a time, then one A load and
// one k-step of products for each strip, the masked last k-step peeled
// off. A strip past N's last reads that last strip again, and its outputs
// are dropped. A task is one tile in bf16 and two side by side in fp32, so
// the loop body and the epilogue stay a few dozen instructions: every
// product is run once a sequence, and unrolled multi-tile bodies cost more
// in instruction fetch than they save (a strip's B fragments, read again
// for each of its tiles, come from L1); in fp32 the second strip shares the
// A fragment and its split, and runs a second mma chain beside the first.
template <int NS, typename AL, typename BL>
__device__ __forceinline__ void task_mma(const AL& A, const BL& Bl, int m0, int n0, int N, int K,
                                         float acc[NS][4]) {
  typedef Mma<typename AL::Elem> M;
  constexpr int kS = M::kK, kB = M::kKB;
  int nl[NS];
  nl[0] = n0;
#pragma unroll
  for (int j = 1; j < NS; ++j) nl[j] = min(n0 + 8 * j, ((N - 1) >> 3) << 3);
  typename M::Acc c[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) M::zero(c[j]);
  const int full = K >> M::kShift;  // k-steps that need no mask
  int t = 0;
  for (; t + kB <= full; t += kB) {
    typename M::B b[kB][NS];
#pragma unroll
    for (int u = 0; u < kB; ++u)
#pragma unroll
      for (int j = 0; j < NS; ++j) Bl.load(nl[j], (t + u) * kS, b[u][j]);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      typename M::A a;
      A.load(m0, (t + u) * kS, a);
#pragma unroll
      for (int j = 0; j < NS; ++j) M::mma(c[j], a, b[u][j]);
    }
  }
#pragma unroll 1
  for (; t * kS < K; ++t) {  // the rest one k-step at a time, the last masked
    const int k0 = t * kS;
    typename M::A a;
    typename M::B b[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) Bl.load(nl[j], k0, b[j]);
    A.load(m0, k0, a);
    if (k0 + kS > K)
#pragma unroll
      for (int j = 0; j < NS; ++j) M::mask(a, b[j], k0, K);
#pragma unroll
    for (int j = 0; j < NS; ++j) M::mma(c[j], a, b[j]);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) M::result(c[j], acc[j]);
}

// out(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, handed to epi(m, n,
// value) once each. The block's warps share the tasks, NS strips of a
// 16-row tile each.
template <typename AL, typename BL, typename Epi>
__device__ __forceinline__ void mma_product(const AL& A, const BL& Bl, int M, int N, int K,
                                            Epi epi) {
  constexpr int NS = Mma<typename AL::Elem>::kStrips;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int warps = blockDim.x >> 5;
  const int groups = ((N + 7) >> 3) / NS + (((N + 7) >> 3) % NS != 0);
  const int tasks = ((M + 15) >> 4) * groups;
  for (int task = warp; task < tasks; task += warps) {
    const int g = task / groups, n0 = (task - g * groups) * 8 * NS, m0 = g * 16;
    float acc[NS][4];
    task_mma<NS>(A, Bl, m0, n0, N, K, acc);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + gr + 8 * (e >> 1), col = n0 + 8 * j + 2 * q + (e & 1);
        if (row < M && col < N) epi(row, col, acc[j][e]);
      }
  }
}

// G[m ldg + col(n)] += sum_k A(m, k) B(k, n) for m < M, n < N, G in device
// memory with one owner per element (the block's partial); col maps a
// column to its offset in the row, worked out once a task for each of a
// lane's columns. A task loads its old values before its product, so their
// round trip runs under the mma chain, and first asks L2 for the next
// task's lines.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename AL, typename BL, typename Col>
__device__ __forceinline__ void mma_product_add(const AL& A, const BL& Bl, int M, int N, int K,
                                                float* __restrict__ G, int ldg, Col col_of) {
  constexpr int NS = Mma<typename AL::Elem>::kStrips;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int warps = blockDim.x >> 5;
  const int groups = ((N + 7) >> 3) / NS + (((N + 7) >> 3) % NS != 0);
  const int tasks = ((M + 15) >> 4) * groups;
  for (int task = warp; task < tasks; task += warps) {
    const int g = task / groups, n0 = (task - g * groups) * 8 * NS, m0 = g * 16;
    const int next = task + warps;
    if (next < tasks && lane < 16) {
      const int gn = next / groups, row = gn * 16 + lane;
      if (row < M) prefetch_l2(G + (size_t)row * ldg + col_of((next - gn * groups) * 8 * NS));
    }
    int cm[NS][2];
    float acc[NS][4], old[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      cm[j][0] = col_of(n0 + 8 * j + 2 * q);
      cm[j][1] = col_of(n0 + 8 * j + 2 * q + 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + gr + 8 * (e >> 1), col = n0 + 8 * j + 2 * q + (e & 1);
        old[j][e] = row < M && col < N ? G[(size_t)row * ldg + cm[j][e & 1]] : 0.0f;
      }
    }
    task_mma<NS>(A, Bl, m0, n0, N, K, acc);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + gr + 8 * (e >> 1), col = n0 + 8 * j + 2 * q + (e & 1);
        if (row < M && col < N) G[(size_t)row * ldg + cm[j][e & 1]] = old[j][e] + acc[j][e];
      }
  }
}

// Two products on the same (M, N) tiles, out1 = A1 B1 and out2 = A2 B2 over
// the same K, handed together to epi(m, n, v1, v2) once each; the block's
// warps share the tiles.
template <typename AL1, typename BL1, typename AL2, typename BL2, typename Epi>
__device__ __forceinline__ void mma_pair(const AL1& A1, const BL1& B1, const AL2& A2,
                                         const BL2& B2, int M, int N, int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int warps = blockDim.x >> 5;
  const int strips = (N + 7) >> 3, tasks = ((M + 15) >> 4) * strips;
  for (int task = warp; task < tasks; task += warps) {
    const int g = task / strips, n0 = (task - g * strips) * 8, m0 = g * 16;
    float acc1[1][4], acc2[1][4];
    task_mma<1>(A1, B1, m0, n0, N, K, acc1);
    task_mma<1>(A2, B2, m0, n0, N, K, acc2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + gr + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
      if (row < M && col < N) epi(row, col, acc1[0][e], acc2[0][e]);
    }
  }
}

// As mma_pair, with epi returning a value summed over each column;
// colsum(n, sum) receives the column's sum once. A warp takes a strip's
// every tile, so one warp sums a column in row order.
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
      float acc1[1][4], acc2[1][4];
      task_mma<1>(A1, B1, m0, n0, N, K, acc1);
      task_mma<1>(A2, B2, m0, n0, N, K, acc2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + gr + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
        if (row < M && col < N) cs[e & 1] += epi(row, col, acc1[0][e], acc2[0][e]);
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
  const void* p[kNumPacked];
  int kt[kNumPacked];
};

// One matrix to pack: B(k, n) = W(k, n), or W(n, k) when trans; W is one
// (rows, cols) matrix, or (split) the columns of three (rows, split) ones
// side by side (Wq | Wk | Wv).
struct PackMat {
  const float* src[3];
  int rows, cols, split, trans, K, N;
  long long start;  // in fragments (uint2 or uint4)
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

// a lane's fragment of strip s, k-step t: bf16 pairs (k 2q, 2q + 1 and 2q +
// 8, 2q + 9 of column gr); tf32 hi and lo of k q and q + 4
template <typename E>
__device__ __forceinline__ typename Mma<E>::Packed pack_one(const PackMat& m, int s, int t,
                                                            int lane);
template <>
__device__ __forceinline__ uint2 pack_one<bf16>(const PackMat& m, int s, int t, int lane) {
  const int n = s * 8 + (lane >> 2), k = t * 16 + 2 * (lane & 3);
  uint2 v;
  v.x = pack2(to_e<bf16>(pack_src(m, k, n)), to_e<bf16>(pack_src(m, k + 1, n)));
  v.y = pack2(to_e<bf16>(pack_src(m, k + 8, n)), to_e<bf16>(pack_src(m, k + 9, n)));
  return v;
}
template <>
__device__ __forceinline__ uint4 pack_one<float>(const PackMat& m, int s, int t, int lane) {
  const int n = s * 8 + (lane >> 2), k = t * 8 + (lane & 3);
  uint4 v;
  split_tf32(pack_src(m, k, n), v.x, v.z);
  split_tf32(pack_src(m, k + 4, n), v.y, v.w);
  return v;
}

// every packed matrix in fragment order, zero past K and N: rounded to
// bf16, or split into tf32 hi and lo
template <typename E>
__global__ void pack_weights_kernel(PackJob job, typename Mma<E>::Packed* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < job.total;
       i += (long long)gridDim.x * blockDim.x) {
    int mi = 0;
    while (mi + 1 < job.count && i >= job.m[mi + 1].start) ++mi;
    const PackMat& m = job.m[mi];
    const long long local = i - m.start;
    const int lane = (int)(local & 31), kt = (m.K + Mma<E>::kK - 1) >> Mma<E>::kShift;
    const long long blk = local >> 5;
    const int s = (int)(blk / kt), t = (int)(blk - (long long)s * kt);
    out[i] = pack_one<E>(m, s, t, lane);
  }
}

template <typename E>
__host__ __device__ inline long long packed_size(int K, int N) {
  return (long long)((K + Mma<E>::kK - 1) / Mma<E>::kK) * ((N + 7) / 8) * 32;
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

// The working sets, in bytes from the block's base; every offset a
// multiple of 16. bf16: persistent xb, qkv (q | k | v), ctx, a1b (bf16),
// the backward's dr (fp32), inv1, inv2, three (L,) sums, valid. Then two
// areas that share their room, as their contents are never live at once:
// the FFN's (xh1 from the output projection through the backward's
// LayerNorm 1, fa a chunk of act(f1), t2 its sum then xhat2 then df2, and in
// the backward df2b and df1) and the attention's (S (p0) and Pdp (P, dp,
// ds) of one head; in the backward dctx, dqkv, and dattn, dattnb before the
// heads). The backward walks the FFN in chunks of kChunkBwd: at SASRec's
// shape its block then takes under half the SM's shared memory, so two
// blocks share an SM. The fp32 instance's layout is tc_layout_f32's.
constexpr int kChunkBwd = 64;

struct TcLayout {
  size_t xb, qkv, ctx, a1b, xh1, dr, inv1, inv2, csum, rsum, psum, valid;
  size_t S, Pdp, dctx, dqkv, dattn, dattnb, fa, t2, df2b, df1, xq, xg, total;
};

inline size_t al16(size_t v) { return (v + 15) / 16 * 16; }

inline int tc_chunk(int I, bool backward) {
  const int c = backward ? kChunkBwd : kChunk;
  return I < c ? I : c;
}

inline TcLayout tc_layout_bf16(int L, int D, int I, bool backward) {
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
  t.xq = t.xg = t.xb;
  // 64 bytes of slack: a head's 32-bit loads may read 8 bytes past its last row
  t.total = (a > f ? a : f) + 64;
  return t;
}

// The fp32 instance's shared memory: every row of n floats n + 4 long (4
// mod 8 when n is a multiple of 8, so the 8 rows an ldmatrix reads fall in
// distinct banks); the copies are the fp32 values themselves, so df2b is
// t2, dattnb is dattn, and the forward's xhat1 is a1. Only the (L,) vectors
// stay put; every buffer takes the room of those dead in its phase. In
// units of bD (one (L, D + 4) buffer), bQ (q | k | v) and fS (one score
// matrix):
//   forward:  xb and ctx at 0 (x is read from device memory for the
//             residual); q | k | v at bD, its attention's S, Pdp after it;
//             then a1 (= xh1) at 1, t2 at 2, fa at 3
//   backward: its forward as xb, ctx 0, S and Pdp at bQ, q | k | v at
//             bQ + 2 fS; then xh1 1, a1b 2, t2 (xhat2, df2) 3, fa and df1
//             at 4, dr after them. After LayerNorm 1's backward, dr goes to
//             dx in device memory as dattn is made (dattn at 1, xh1's room)
//             and x is read again to xq (a1b's room); the output
//             projection's products then run beside q | k | v recomputed
//             from xq into their first room, dctx after them; the heads'
//             dqkv at 0, S and Pdp at bQ; x read once more to xg (bQ) for
//             the projections' gradients.
// At SASRec's shape the backward so holds under 115,712 bytes and two
// blocks share an SM, for one more q | k | v product and two reads of x a
// sequence; every shape the route admits fits.
inline TcLayout tc_layout_f32(int L, int D, int I, bool backward) {
  const int IC = tc_chunk(I, backward);
  const size_t bD = (size_t)L * (D + 4) * 4, bQ = (size_t)L * (3 * D + 4) * 4,
               bI = (size_t)L * (IC + 4) * 4, fS = (size_t)L * score_stride(L) * 4,
               vec = al16((size_t)L * 4);
  TcLayout t;
  size_t p = 0;
  t.inv1 = p; p += vec;
  t.inv2 = p; p += vec;
  t.csum = p; if (backward) p += vec;
  t.rsum = p; if (backward) p += vec;
  t.psum = p; if (backward) p += vec;
  t.valid = p; p += vec;
  t.xb = t.ctx = t.xq = t.xg = p;
  size_t end;
  if (!backward) {
    t.qkv = p + bD;
    t.S = t.qkv + bQ;
    t.Pdp = t.S + fS;
    t.xh1 = t.a1b = p + bD;
    t.t2 = t.df2b = p + 2 * bD;
    t.fa = t.df1 = p + 3 * bD;
    t.dr = t.dattn = t.dattnb = t.dctx = t.dqkv = p;  // the backward's only
    const size_t a = t.Pdp + fS, f = p + 3 * bD + bI;
    end = a > f ? a : f;
  } else {
    t.S = p + bQ;
    t.Pdp = t.S + fS;
    t.qkv = t.Pdp + fS;
    t.xh1 = t.dattn = t.dattnb = p + bD;
    t.a1b = t.xq = p + 2 * bD;
    t.t2 = t.df2b = p + 3 * bD;
    t.fa = p + 4 * bD;
    t.df1 = t.fa + bI;
    t.dr = t.df1 + bI;
    t.dctx = t.qkv + bQ;
    t.dqkv = p;
    t.xg = p + bQ;
    const size_t a = t.dctx + bD, f = t.dr + bD;
    end = a > f ? a : f;
  }
  // 64 bytes of slack: a transposed operand's loads may read up to 60 bytes
  // past its last row
  t.total = end + 64;
  return t;
}

inline TcLayout tc_layout(int L, int D, int I, bool backward, bool f32) {
  return f32 ? tc_layout_f32(L, D, I, backward) : tc_layout_bf16(L, D, I, backward);
}

template <typename E>
struct TcSmem {
  E *xb, *qkv, *ctx, *a1b, *dctx, *dqkv, *dattnb, *fa, *df2b, *df1, *xq, *xg;
  float *xh1, *dr, *inv1, *inv2, *csum, *rsum, *psum, *S, *Pdp, *dattn, *t2;
  int* valid;
};

template <typename E>
__device__ TcSmem<E> tc_carve(char* base, const TcLayout& t) {
  TcSmem<E> m;
  m.xb = reinterpret_cast<E*>(base + t.xb);
  m.qkv = reinterpret_cast<E*>(base + t.qkv);
  m.ctx = reinterpret_cast<E*>(base + t.ctx);
  m.a1b = reinterpret_cast<E*>(base + t.a1b);
  m.dctx = reinterpret_cast<E*>(base + t.dctx);
  m.dqkv = reinterpret_cast<E*>(base + t.dqkv);
  m.dattnb = reinterpret_cast<E*>(base + t.dattnb);
  m.fa = reinterpret_cast<E*>(base + t.fa);
  m.df2b = reinterpret_cast<E*>(base + t.df2b);
  m.df1 = reinterpret_cast<E*>(base + t.df1);
  m.xq = reinterpret_cast<E*>(base + t.xq);
  m.xg = reinterpret_cast<E*>(base + t.xg);
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

// ================================================================ row passes
// Each row pass runs once a sequence, so its loops stay rolled (its
// instruction fetch costs more than unrolling saves), and the read-only
// parameters are read through the non-coherent path.

// LayerNorm of each row of src (biased variance, 1 / sqrt(var + eps)):
// xhat in place when keep (with inv_out), or xhat g + b to out (row stride
// ld_out, device memory)
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

// dy (in place) -> dx of LayerNorm: (dy g - mean(dy g) - xhat mean(dy g xhat)) inv
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

// g[n] += sum_l a[l][n] (* b[l][n] when b is given)
__device__ void tc_colsum_add(float* g, const float* a, const float* b, int ld, int rows, int N) {
#pragma unroll 1
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
#pragma unroll 4
    for (int l = 0; l < rows; ++l) s += b ? a[l * ld + n] * b[l * ld + n] : a[l * ld + n];
    g[n] += s;
  }
}

// rows of a (L, D) block of device memory into shared memory, float4 each
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

// ============================================================ the layer
// One body for both instances, on the operand type E: bf16 copies and
// m16n8k16 products, or fp32 copies and 3xTF32 products.

// P and ds: rows of E at the stride of the fp32 rows they share
template <typename E>
__device__ __forceinline__ E* pb(const TcSmem<E>& m) { return reinterpret_cast<E*>(m.Pdp); }
template <typename E>
constexpr int kPW = (int)(sizeof(float) / sizeof(E));

// S = q_h k_h^T scale + mask (fp32)
template <typename E>
__device__ void tc_scores(const TcSmem<E>& m, const TcShape& sh, int h) {
  const int hd = sh.hd, LSf = sh.LSf, causal = sh.causal;
  const float scale = sh.scale;
  const int* valid = m.valid;
  float* S = m.S;
  mma_product(HeadA<E>{m.qkv + h * hd, sh.SBQ, sh.L},
              HeadB<E, false>{m.qkv + sh.D + h * hd, sh.SBQ, sh.L}, sh.L, sh.L, hd,
              [&](int i, int j, float v) {
                const bool ok = valid[j] > 0 && (causal ? j <= i : valid[i] > 0);
                S[i * LSf + j] = v * scale + (ok ? 0.0f : kNeg);
              });
}

// S -> p0 in place, row by row; P = p0 in E too when there is no attention
// dropout
template <typename E>
__device__ void tc_softmax(const TcSmem<E>& m, const TcShape& sh, bool write_p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, L = sh.L, LP = kPW<E> * sh.LSf;
  E* P = pb(m);
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
      if (write_p) P[i * LP + j] = to_e<E>(p);
    }
  }
}

// P = p0 keep over head h's (L, L) dropout site
template <typename E>
__device__ void tc_keep_probs(const TcSmem<E>& m, const TcShape& sh, int b, int h, unsigned k0,
                              unsigned k1) {
  const float* S = m.S;
  E* P = pb(m);
  const int LSf = sh.LSf, LP = kPW<E> * sh.LSf;
  for_keep(sh.L, sh.L, sh.attn_rate, b, h, sh.layer, k0, k1,
           [&](int i, int j, float mk) { P[i * LP + j] = to_e<E>(S[i * LSf + j] * mk); });
}

// q | k | v = x [Wq | Wk | Wv] + [bq | bk | bv], x from xs (the row stride
// of xb)
template <typename E>
__device__ __forceinline__ void tc_qkv(const TcSmem<E>& m, const E* xs, const TcShape& sh,
                                       const Params& W, const PackedSet& pk) {
  const int D = sh.D, SBQ = sh.SBQ;
  E* qkv = m.qkv;
  const float *bq = W.p[BQ], *bk = W.p[BK], *bv = W.p[BV];
  mma_product(SmemA<E, false>{xs, sh.SBD, sh.L}, PackedB<E>{pk.p[PQKV], pk.kt[PQKV], 0, 0}, sh.L,
              3 * D, D, [&](int l, int c, float v) {
                const float bias = c < D ? __ldg(bq + c)
                                         : (c < 2 * D ? __ldg(bk + c - D) : __ldg(bv + c - 2 * D));
                qkv[l * SBQ + c] = to_e<E>(v + bias);
              });
}

// The forward of sequence b with xb and valid in shared memory. Leaves qkv,
// ctx, a1b and xhat1; with KEEP also inv1, xhat2 (in t2) and inv2 for the
// backward. Without KEEP it writes y to device memory.
template <typename E, bool KEEP>
__device__ void tc_forward_seq(const TcSmem<E>& m, const TcShape& sh, const Params& W,
                               const PackedSet& pk, int b, unsigned k0, unsigned k1,
                               const float* __restrict__ x, float* __restrict__ y) {
  constexpr int kS = Mma<E>::kShift;
  const int L = sh.L, D = sh.D, hd = sh.hd, SBD = sh.SBD, SBQ = sh.SBQ, SBI = sh.SBI,
            FD = sh.FD, LP = kPW<E> * sh.LSf;
  E* qkv = m.qkv;
  tc_qkv(m, m.xb, sh, W, pk);
  __syncthreads();
  // attention, head by head; the next head's scores beside this head's P v
  tc_scores(m, sh, 0);
  __syncthreads();
  E* ctx = m.ctx;
  for (int h = 0; h < sh.H; ++h) {
    tc_softmax(m, sh, sh.attn_rate <= 0.0f);
    __syncthreads();
    if (sh.attn_rate > 0.0f) {
      tc_keep_probs(m, sh, b, h, k0, k1);
      __syncthreads();
    }
    mma_product(SmemA<E, false>{pb(m), LP, L}, HeadB<E, true>{qkv + 2 * D + h * hd, SBQ, L}, L,
                hd, L, [&](int i, int d, float v) { ctx[i * SBD + h * hd + d] = to_e<E>(v); });
    if (h + 1 < sh.H) tc_scores(m, sh, h + 1);
    __syncthreads();
  }
  // output projection, dropout, residual, LayerNorm 1
  float* xh1 = m.xh1;
  const float* bo = W.p[BO];
  mma_product(SmemA<E, false>{ctx, SBD, L}, PackedB<E>{pk.p[PO], pk.kt[PO], 0, 0}, L, D, D,
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
        // the fp32 forward keeps a1 alone: its xh1 is a1b
        if (KEEP || !kF32<E>) s[d] = xh;
        m.a1b[l * SBD + d] = to_e<E>(xh * __ldg(g + d) + __ldg(bb + d));
      }
    }
  }
  __syncthreads();
  // FFN in chunks of IC inner columns, its output summed in t2
  float* t2 = m.t2;
  E* fa = m.fa;
  const float *b1 = W.p[FF1B], *b2 = W.p[FF2B];
  const int act = sh.act;
  for (int c0 = 0; c0 < sh.I; c0 += sh.IC) {
    const int ic = min(sh.IC, sh.I - c0);
    mma_product(SmemA<E, false>{m.a1b, SBD, L}, PackedB<E>{pk.p[P1], pk.kt[P1], c0 >> 3, 0}, L,
                ic, D, [&](int l, int c, float v) {
                  fa[l * SBI + c] = to_e<E>(tc_act(act, v + __ldg(b1 + c0 + c)));
                });
    __syncthreads();
    const bool first = c0 == 0;
    mma_product(SmemA<E, false>{fa, SBI, L}, PackedB<E>{pk.p[P2], pk.kt[P2], 0, c0 >> kS}, L, D,
                ic, [&](int l, int n, float v) {
                  if (first) t2[l * FD + n] = v + __ldg(b2 + n);
                  else t2[l * FD + n] += v;
                });
    __syncthreads();
  }
  // residual a1 + dropout(f2): the fp32 copy is a1 itself, the bf16 instance
  // recomputes it in fp32
  const float *g1 = W.p[LN1G], *be1 = W.p[LN1B];
  const E* a1b = m.a1b;
  for_keep(L, D, sh.rate, b, sh.H + 1, sh.layer, k0, k1, [&](int l, int n, float mk) {
    if constexpr (kF32<E>)
      t2[l * FD + n] = a1b[l * SBD + n] + t2[l * FD + n] * mk;
    else
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

template <typename E>
__device__ __forceinline__ void tc_load_seq(const TcSmem<E>& m, const TcShape& sh,
                                            const float* __restrict__ x,
                                            const int* __restrict__ valid, int b) {
  const int L = sh.L, D = sh.D, nv = D >> 2;
  const float4* xs = reinterpret_cast<const float4*>(x + (size_t)b * L * D);
#pragma unroll 1
  for (int i = threadIdx.x; i < L * nv; i += blockDim.x) {
    const int l = i / nv, c = i - l * nv;
    const float4 v = xs[i];
    if constexpr (kF32<E>) {
      *reinterpret_cast<float4*>(m.xb + l * sh.SBD + 4 * c) = v;
    } else {
      uint2 w;
      w.x = pack2(to_e<bf16>(v.x), to_e<bf16>(v.y));
      w.y = pack2(to_e<bf16>(v.z), to_e<bf16>(v.w));
      *reinterpret_cast<uint2*>(m.xb + l * sh.SBD + 4 * c) = w;
    }
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x) m.valid[j] = valid[(size_t)b * L + j];
  __syncthreads();
}

template <typename E>
__device__ __forceinline__ void tc_forward(char* base, const float* __restrict__ x,
                                           const int* __restrict__ valid, const Params& W,
                                           const PackedSet& pk, const long long* __restrict__ seed,
                                           const TcShape& sh, const TcLayout& lay,
                                           float* __restrict__ y) {
  const TcSmem<E> m = tc_carve<E>(base, lay);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    tc_load_seq(m, sh, x, valid, b);
    tc_forward_seq<E, false>(m, sh, W, pk, b, k0, k1, x, y);
  }
}

template <typename E>
__device__ __forceinline__ void tc_backward(char* base, const float* __restrict__ x,
                                            const int* __restrict__ valid, const Params& W,
                                            const PackedSet& pk,
                                            const long long* __restrict__ seed,
                                            const TcShape& sh, const TcLayout& lay,
                                            const float* __restrict__ dy, float* __restrict__ dx,
                                            float* __restrict__ partials) {
  constexpr int kS = Mma<E>::kShift;
  const TcSmem<E> m = tc_carve<E>(base, lay);
  const unsigned long long s = seed ? (unsigned long long)*seed : 0ull;
  const unsigned k0 = (unsigned)s, k1 = (unsigned)(s >> 32);
  const int L = sh.L, D = sh.D, I = sh.I, hd = sh.hd, SBD = sh.SBD, SBQ = sh.SBQ,
            SBI = sh.SBI, FD = sh.FD, LSf = sh.LSf, LP = kPW<E> * sh.LSf, act = sh.act;
  const Offsets off = grad_offsets(D, I);
  float* G = partials + (size_t)blockIdx.x * off.o[kNumParams];
  for (int i = threadIdx.x; i < off.o[kNumParams]; i += blockDim.x) G[i] = 0.0f;
  __syncthreads();
  const int gbq = off.o[BQ], gbk = off.o[BK], gbv = off.o[BV];
  const auto same_col = [](int c) { return c; };
  float *dr = m.dr, *t2 = m.t2, *xh1 = m.xh1;
  E *df2b = m.df2b, *df1 = m.df1, *fa = m.fa, *dqkv = m.dqkv, *dctx = m.dctx;

  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    tc_load_seq(m, sh, x, valid, b);
    tc_forward_seq<E, true>(m, sh, W, pk, b, k0, k1, x, nullptr);   // t2 = xhat2

    // LayerNorm 2
    tc_load_rows(dr, FD, dy + (size_t)b * L * D, L, D);
    __syncthreads();
    tc_colsum_add(G + off.o[LN2G], dr, t2, FD, L, D);
    tc_colsum_add(G + off.o[LN2B], dr, nullptr, FD, L, D);
    __syncthreads();
    tc_ln_bwd_rows(dr, t2, m.inv2, W.p[LN2G], FD, L, D);        // dr = dr2
    __syncthreads();
    // FFN: df2 (fp32 in t2, and a copy in df2b); dr becomes da1
    for_keep(L, D, sh.rate, b, sh.H + 1, sh.layer, k0, k1, [&](int l, int n, float mk) {
      const float v = dr[l * FD + n] * mk;
      t2[l * FD + n] = v;
      if constexpr (!kF32<E>) df2b[l * SBD + n] = to_e<E>(v);
    });
    __syncthreads();
    tc_colsum_add(G + off.o[FF2B], t2, nullptr, FD, L, D);
    const float* b1 = W.p[FF1B];
    float* gb1 = G + off.o[FF1B];
    for (int c0 = 0; c0 < I; c0 += sh.IC) {
      const int ic = min(sh.IC, I - c0);
      // f1 = a1 W1 + b1 and dfa = df2 W2^T on the same tiles: fa = act(f1),
      // df1 = dfa act'(f1), and the FFN bias gradient: in bf16 summed from
      // the fp32 df1 a column at a time by the strip's warp; in fp32 df1 is
      // stored exact, so the tiles go to every warp and its columns are
      // summed after the barrier
      const SmemA<E, false> a1s{m.a1b, SBD, L}, df2s{df2b, SBD, L};
      const PackedB<E> w1s{pk.p[P1], pk.kt[P1], c0 >> 3, 0}, w2s{pk.p[P2T], pk.kt[P2T], c0 >> 3, 0};
      auto f1_df1 = [&](int l, int c, float v1, float v2) {
        const float f1 = v1 + __ldg(b1 + c0 + c);
        const float2 ag = tc_act2(act, f1);
        fa[l * SBI + c] = to_e<E>(ag.x);
        const float d = v2 * ag.y;
        df1[l * SBI + c] = to_e<E>(d);
        return d;
      };
      if constexpr (kF32<E>)
        mma_pair(a1s, w1s, df2s, w2s, L, ic, D, f1_df1);
      else
        mma_dual(a1s, w1s, df2s, w2s, L, ic, D, f1_df1,
                 [&](int c, float sum) { gb1[c0 + c] += sum; });
      __syncthreads();
      if constexpr (kF32<E>) tc_colsum_add(gb1 + c0, m.df1, nullptr, SBI, L, ic);
      mma_product_add(SmemA<E, true>{fa, SBI, L}, SmemB<E, true>{df2b, SBD, L}, ic, D, L,
                      G + off.o[FF2W] + (size_t)c0 * D, D, same_col);
      mma_product_add(SmemA<E, true>{m.a1b, SBD, L}, SmemB<E, true>{df1, SBI, L}, D, ic, L,
                      G + off.o[FF1W] + c0, I, same_col);
      mma_product(SmemA<E, false>{df1, SBI, L}, PackedB<E>{pk.p[P1T], pk.kt[P1T], 0, c0 >> kS},
                  L, D, ic, [&](int l, int n, float v) { dr[l * FD + n] += v; });
      __syncthreads();
    }
    // LayerNorm 1
    tc_colsum_add(G + off.o[LN1G], dr, xh1, FD, L, D);
    tc_colsum_add(G + off.o[LN1B], dr, nullptr, FD, L, D);
    __syncthreads();
    tc_ln_bwd_rows(dr, xh1, m.inv1, W.p[LN1G], FD, L, D);       // dr = dr1
    __syncthreads();
    // attention output projection: dattn (fp32, and a copy in dattnb), then
    // dWo and dctx. In fp32, dr1 goes to dx (the heads take its room) and x
    // is read again, to recompute q | k | v beside dWo and dctx.
    float* dattn = m.dattn;
    E* dattnb = m.dattnb;
    float* dxs = dx + (size_t)b * L * D;
    for_keep(L, D, sh.rate, b, sh.H, sh.layer, k0, k1, [&](int l, int n, float mk) {
      const float v = dr[l * FD + n] * mk;
      dattn[l * FD + n] = v;
      if constexpr (kF32<E>)
        dxs[l * D + n] = dr[l * FD + n];
      else
        dattnb[l * SBD + n] = to_e<E>(v);
    });
    if constexpr (kF32<E>) tc_load_rows(m.xq, SBD, x + (size_t)b * L * D, L, D);
    __syncthreads();
    tc_colsum_add(G + off.o[BO], dattn, nullptr, FD, L, D);
    mma_product_add(SmemA<E, true>{m.ctx, SBD, L}, SmemB<E, true>{dattnb, SBD, L}, D, D, L,
                    G + off.o[WO], D, same_col);
    mma_product(SmemA<E, false>{dattnb, SBD, L}, PackedB<E>{pk.p[POT], pk.kt[POT], 0, 0}, L, D,
                D, [&](int l, int n, float v) { dctx[l * SBD + n] = to_e<E>(v); });
    if constexpr (kF32<E>) tc_qkv(m, m.xq, sh, W, pk);
    __syncthreads();
    // attention, head by head: dq | dk | dv into dqkv
    E* P = pb(m);
    float* dp = m.Pdp;
    const E* qkv = m.qkv;
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
      mma_product(SmemA<E, true>{P, LP, L}, HeadB<E, true>{dctx + ho, SBD, L}, L, hd, L,
                  [&](int j, int d, float v) { dqkv[j * SBQ + 2 * D + ho + d] = to_e<E>(v); });
      {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
        for (int i = warp; i < L; i += kWarps) {
          float sum = 0.0f;
#pragma unroll 1
          for (int j = lane; j < L; j += 32) sum += from_e(P[i * LP + j]);
          sum = warp_sum(sum);
          if (lane == 0) m.psum[i] = sum;
        }
      }
      __syncthreads();
      // dp = dO v^T (over P's rows)
      mma_product(HeadA<E>{dctx + ho, SBD, L}, HeadB<E, false>{qkv + 2 * D + ho, SBQ, L}, L, L,
                  hd, [&](int i, int j, float v) { dp[i * LSf + j] = v; });
      __syncthreads();
      if (sh.attn_rate > 0.0f) {
        for_keep(L, L, sh.attn_rate, b, h, sh.layer, k0, k1,
                 [&](int i, int j, float mk) { dp[i * LSf + j] *= mk; });
        __syncthreads();
      }
      // ds = p0 (dp - sum_j dp p0) scale, written as E over dp's own row
      {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        constexpr int kR = kMaxRow / 32;
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
              const E d = to_e<E>(pv[r] * (dv[r] - sum) * sh.scale);
              P[i * LP + j] = d;
              rs += from_e(d);
            }
          }
          rs = warp_sum(rs);
          if (lane == 0) m.rsum[i] = rs;
        }
      }
      __syncthreads();
      // dq = ds k, dk = ds^T q, and the column sums of ds
      mma_product(SmemA<E, false>{P, LP, L}, HeadB<E, true>{qkv + D + ho, SBQ, L}, L, hd, L,
                  [&](int i, int d, float v) { dqkv[i * SBQ + ho + d] = to_e<E>(v); });
      mma_product(SmemA<E, true>{P, LP, L}, HeadB<E, true>{qkv + ho, SBQ, L}, L, hd, L,
                  [&](int j, int d, float v) { dqkv[j * SBQ + D + ho + d] = to_e<E>(v); });
      for (int j = threadIdx.x; j < L; j += blockDim.x) {
        float sum = 0.0f;
#pragma unroll 4
        for (int i = 0; i < L; ++i) sum += from_e(P[i * LP + j]);
        m.csum[j] = sum;
      }
      __syncthreads();
      // bias gradients of q, k, v: sum_l dq[l] = colsum(ds) k, sum_j dk[j] =
      // rowsum(ds) q, sum_j dv[j] = rowsum(P) dO
      for (int t = threadIdx.x; t < 3 * hd; t += blockDim.x) {
        const int w = t / hd, d = t - w * hd;
        const float* vec = w == 0 ? m.csum : (w == 1 ? m.rsum : m.psum);
        const E* col = w == 0 ? qkv + D + ho + d : (w == 1 ? qkv + ho + d : dctx + ho + d);
        const int ld = w == 2 ? SBD : SBQ;
        float sum = 0.0f;
#pragma unroll 4
        for (int i = 0; i < L; ++i) sum += vec[i] * from_e(col[i * ld]);
        G[(w == 0 ? gbq : (w == 1 ? gbk : gbv)) + ho + d] += sum;
      }
      // (the next head's first writes of csum, rsum and psum come after two
      // barriers)
    }
    __syncthreads();
    if constexpr (kF32<E>) {
      tc_load_rows(m.xg, SBD, x + (size_t)b * L * D, L, D);
      __syncthreads();
    }
    // projections: dWq | dWk | dWv = x^T dqkv as one product over the 3 D
    // columns of dqkv (whose k and v parts need not start on 16 bytes, as
    // ldmatrix would need): column c of dWk lies D^2 + D floats after that
    // of dWq, and a bias of D between, so D^2 past the row's columns; dx =
    // dr1 + dqkv [Wq | Wk | Wv]^T
    const int DD = D * D;
    mma_product_add(SmemA<E, true>{m.xg, SBD, L}, SmemB<E, true>{dqkv, SBQ, L}, D, 3 * D, L,
                    G + off.o[WQ], D,
                    [=](int c) { return c + (c >= D ? DD : 0) + (c >= 2 * D ? DD : 0); });
    mma_product(SmemA<E, false>{dqkv, SBQ, L}, PackedB<E>{pk.p[PQKVT], pk.kt[PQKVT], 0, 0}, L, D,
                3 * D, [&](int l, int n, float v) {
                  if constexpr (kF32<E>)
                    dxs[l * D + n] += v;
                  else
                    dxs[l * D + n] = dr[l * FD + n] + v;
                });
    __syncthreads();
  }
}

// The four kernels, each sized for two blocks an SM (64 registers a
// thread), which every working set at SASRec's widths allows.
__global__ void __launch_bounds__(kThreads, 2)
trm_layer_bf16_fwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                          PackedSet pk, const long long* __restrict__ seed, TcShape sh,
                          TcLayout lay, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  tc_forward<bf16>(reinterpret_cast<char*>(smem4), x, valid, W, pk, seed, sh, lay, y);
}

__global__ void __launch_bounds__(kThreads, 2)
trm_layer_bf16_bwd_kernel(const float* __restrict__ x, const int* __restrict__ valid, Params W,
                          PackedSet pk, const long long* __restrict__ seed, TcShape sh,
                          TcLayout lay, const float* __restrict__ dy, float* __restrict__ dx,
                          float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  tc_backward<bf16>(reinterpret_cast<char*>(smem4), x, valid, W, pk, seed, sh, lay, dy, dx,
                    partials);
}

__global__ void __launch_bounds__(kThreads, 2)
trm_layer_tf32x3_fwd_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                            Params W, PackedSet pk, const long long* __restrict__ seed,
                            TcShape sh, TcLayout lay, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  tc_forward<float>(reinterpret_cast<char*>(smem4), x, valid, W, pk, seed, sh, lay, y);
}

__global__ void __launch_bounds__(kThreads, 2)
trm_layer_tf32x3_bwd_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                            Params W, PackedSet pk, const long long* __restrict__ seed,
                            TcShape sh, TcLayout lay, const float* __restrict__ dy,
                            float* __restrict__ dx, float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  tc_backward<float>(reinterpret_cast<char*>(smem4), x, valid, W, pk, seed, sh, lay, dy, dx,
                     partials);
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

int check_widths(int B, int L, int D, int H, int I, int act, float attn_rate, float rate) {
  if (B < 1 || L < 1 || L > kMaxRow || D < 4 || H < 1 || I < 4 || D % H || D % 4 ||
      (D / H) % 4 || I % 4 || act < GELU || act > SIGMOID || attn_rate < 0.f ||
      attn_rate >= 1.f || rate < 0.f || rate >= 1.f)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int make_tc_shape(int B, int L, int D, int H, int I, int causal, int act, float eps,
                  float attn_rate, float rate, int layer, bool f32, bool backward, TcShape* sh) {
  const int err = check_widths(B, L, D, H, I, act, attn_rate, rate);
  if (err) return err;
  sh->B = B; sh->L = L; sh->D = D; sh->H = H; sh->I = I;
  sh->hd = D / H;
  sh->IC = tc_chunk(I, backward);
  sh->SBD = f32 ? D + 4 : sb(D);
  sh->SBQ = f32 ? 3 * D + 4 : sb(3 * D);
  sh->SBI = f32 ? sh->IC + 4 : sb(sh->IC);
  sh->FD = D + 4;
  sh->LSf = score_stride(L);
  sh->causal = causal; sh->act = act; sh->eps = eps;
  sh->scale = 1.0f / sqrtf((float)sh->hd);
  sh->attn_rate = attn_rate; sh->rate = rate; sh->layer = layer;
  return 0;
}

size_t smem_bytes(int L, int D, int I, bool backward, bool bf16) {
  return tc_layout(L, D, I, backward, !bf16).total;
}

// The packed weights: the forward's four (W), then, for the backward, the
// four transposed (W^T); their fragment count when ``out`` is null, else the
// launch's error code.
template <typename E>
long long pack_weights(const Params& W, int D, int I, bool backward,
                       typename Mma<E>::Packed* out, PackedSet* pk, cudaStream_t stream) {
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
      pk->kt[i] = (m.K + Mma<E>::kK - 1) / Mma<E>::kK;
    }
    start += packed_size<E>(m.K, m.N);
  }
  job.total = start;
  if (!out) return start;
  const long long blocks = (start + 255) / 256;
  pack_weights_kernel<E><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(job, out);
  return (long long)cudaGetLastError();
}

// floats of one call's packed weights
long long packed_floats(int D, int I, bool is_bf16, bool backward) {
  Params W = {};
  if (is_bf16) return pack_weights<bf16>(W, D, I, backward, nullptr, nullptr, 0) * 2;
  return pack_weights<float>(W, D, I, backward, nullptr, nullptr, 0) * 4;
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
  return backward ? plan_grid(trm_layer_tf32x3_bwd_kernel, smem, B, grid)
                  : plan_grid(trm_layer_tf32x3_fwd_kernel, smem, B, grid);
}

// Everything a launch needs but the pointers: the shape, the grid, and the
// weights packed into ``wr``.
struct Plan {
  TcShape sh;
  TcLayout lay;
  PackedSet pk;
  size_t smem;
  int grid;
};

int plan(const Params& W, int B, int L, int D, int H, int I, int causal, int act, float eps,
         float attn_rate, float rate, int layer, bool is_bf16, bool backward, float* wr,
         cudaStream_t stream, Plan* pl) {
  int err = make_tc_shape(B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, !is_bf16,
                          backward, &pl->sh);
  if (err) return err;
  pl->lay = tc_layout(L, D, I, backward, !is_bf16);
  pl->smem = pl->lay.total;
  err = grid_of(is_bf16, backward, pl->smem, B, &pl->grid);
  if (err) return err;
  if (!wr) return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)pack_weights<bf16>(W, D, I, backward, reinterpret_cast<uint2*>(wr), &pl->pk,
                                        stream)
              : (int)pack_weights<float>(W, D, I, backward, reinterpret_cast<uint4*>(wr),
                                         &pl->pk, stream);
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

// Floats of weight scratch a call needs: the packed weights, W (and W^T for
// the backward), bf16 fragments or fp32 hi and lo ones.
extern "C" long long trm_layer_scratch_floats(int D, int I, int bf16, int backward) {
  return packed_floats(D, I, bf16 != 0, backward != 0);
}

// The number of blocks the forward or the backward launches for B sequences
// (the backward's partials are (blocks, P)), or minus the CUDA error code:
// cudaErrorInvalidValue for widths outside the limits,
// cudaErrorInvalidConfiguration when the working set exceeds the shared
// memory a block may have.
extern "C" int trm_layer_blocks(int B, int L, int D, int H, int I, int bf16, int backward) {
  int err = check_widths(B, L, D, H, I, 0, 0.f, 0.f);
  if (err) return -err;
  int grid = 0;
  err = grid_of(bf16 != 0, backward != 0, smem_bytes(L, D, I, backward != 0, bf16 != 0), B, &grid);
  return err ? -err : grid;
}

// x (B, L, D) f32, valid (B, L) int32, params 16 device pointers in the order
// of enum Param (all f32, contiguous), seed one int64 on the device (null
// when both rates are 0), wr trm_layer_scratch_floats(D, I, bf16, 0) floats
// of scratch, y (B, L, D) f32. Returns the CUDA error code.
extern "C" int trm_layer_fwd(const float* x, const int* valid, const void* const* params,
                             const void* seed, int B, int L, int D, int H, int I, int causal,
                             int act, float eps, float attn_rate, float rate, int layer,
                             int bf16, float* wr, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params W;
  for (int i = 0; i < kNumParams; ++i) W.p[i] = static_cast<const float*>(params[i]);
  const long long* sd = static_cast<const long long*>(seed);
  Plan pl;
  const int err = plan(W, B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, bf16 != 0,
                       false, wr, s, &pl);
  if (err) return err;
  if (bf16)
    trm_layer_bf16_fwd_kernel<<<pl.grid, kThreads, pl.smem, s>>>(x, valid, W, pl.pk, sd, pl.sh,
                                                                 pl.lay, y);
  else
    trm_layer_tf32x3_fwd_kernel<<<pl.grid, kThreads, pl.smem, s>>>(x, valid, W, pl.pk, sd,
                                                                   pl.sh, pl.lay, y);
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
  Plan pl;
  int err = plan(W, B, L, D, H, I, causal, act, eps, attn_rate, rate, layer, bf16 != 0, true,
                 wr, s, &pl);
  if (err) return err;
  if (bf16)
    trm_layer_bf16_bwd_kernel<<<pl.grid, kThreads, pl.smem, s>>>(x, valid, W, pl.pk, sd, pl.sh,
                                                                 pl.lay, dy, dx, partials);
  else
    trm_layer_tf32x3_bwd_kernel<<<pl.grid, kThreads, pl.smem, s>>>(x, valid, W, pl.pk, sd,
                                                                   pl.sh, pl.lay, dy, dx,
                                                                   partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int P = grad_offsets(D, I).o[kNumParams];
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, s>>>(partials, pl.grid, P, grads);
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
