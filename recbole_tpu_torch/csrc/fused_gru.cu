// The GRU recurrence over a whole sequence, forward and backward, for Hopper.
//
// Replaces: recbole_tpu/ops/fused_gru.py::fused_gru (:192; Pallas kernels
// _fwd_kernel :53 and _bwd_kernel :64). Given the input projections
// xi = x wi + bi (B, L, 3H), computed outside, it runs a GRU layer's time
// loop, gates r, z, n in the torch convention:
//   hh = h wh + bh;  r = sigmoid(xi_r + hh_r);  z = sigmoid(xi_z + hh_z);
//   n = tanh(xi_n + r hh_n);  h = (1 - z) n + z h,
// and writes every h_t. The backward walks t = L-1 ... 0, reads h_{t-1} from
// the forward's output (h0 at t = 0), recomputes the gates, and writes dxi,
// dh0, dwh and dbh:
//   dh += dout_t;  dpre_n = dh (1 - z)(1 - n^2);  dpre_r = dpre_n hn r (1 - r);
//   dpre_z = dh (h_{t-1} - n) z (1 - z);  dhh = [dpre_r, dpre_z, dpre_n r];
//   dxi_t = [dpre_r, dpre_z, dpre_n];  dh = dh z + dhh wh^T;
//   dwh = sum_t h_{t-1}^T dhh_t;  dbh = sum_t sum_b dhh_t.
//
// Two instances (template flag BF). fp32: everything fp32, the JAX kernel's
// math. bf16: the rounding points of recbole_tpu/models/layers.py::gru_apply
// under a bfloat16 compute dtype: xi arrives and each h_t leaves in bf16; both
// operands of the recurrent product (h, wh) are rounded to bf16 and summed in
// fp32 (every term exact), plus fp32 bh; the gates and the hidden carry are
// fp32. Backward rounding (bf16 instance): dout arrives and dxi leaves in
// bf16, and the cotangent that comes back through the product, dhh wh^T, is
// rounded to bf16 before it joins dh, as JAX's autodiff of the scan rounds
// them. Two points differ from JAX, and the plain version
// (recbole_tpu_torch/ops/fused_gru.py) makes the same choice: dwh is summed
// in fp32 over all steps (JAX rounds each step's whole-batch contribution to
// bf16, which a block owning 16 rows cannot see), and the gates are
// recomputed from the bf16 outputs, where JAX's scan keeps the fp32 carry.
// The CPU tests hold the plain version against gru_apply at a bf16 bound
// that covers both.
//
// What bounds it on the H100 (GRU4Rec's step: B = 2048, L = 50, H = 128):
// the recurrent products are 10.07 GFLOP forward and 30.2 GFLOP backward, the
// bytes 105 MB forward and 210 MB backward in the bf16 instance (0.032 and
// 0.063 ms at 3.35 TB/s; the fp32 instance's products as 3xTF32 at a third
// of the TF32 rate 0.061 and 0.183 ms, its bytes 0.063 forward). The
// recurrence is serial in t, so a step's
// latency rules: on every route a block (or cluster) owns a set of sequences
// for the whole loop, keeps wh out of the step's device-memory traffic where
// it can, carries h (forward) or dh (backward) in registers or shared memory
// and never sends h through device memory. Blocks run in no order, so the
// parameter gradients are not summed across blocks in place: the recurrent
// backward writes each step's dhh (fp32) and a per-block (per-cluster) dbh
// partial; the dwh kernel then forms [h_{t-1}]^T dhh over chunks of the B L
// rows, one partial per chunk, and reduce_partials_kernel sums the partials
// in chunk (block) order. No float atomics: two runs give the same bits.
//
// Five routes for the recurrent kernels, chosen from H and the instance
// before launch (route_of; the numbers are fused_gru_route's):
//  4  bf16, H <= kMaxH = 128 (GRU4Rec's default): fused_gru_{fwd,bwd}_tc_kernel,
//     tensor cores in one block (the design is at the kernels below): a
//     block owns 16 sequences and all of wh in bf16 (98,304 bytes at H 128),
//     a warp 8 (forward) or 16 (backward) units in all three gates, the
//     recurrent products on mma.sync m16n8k16, fast gates, the next steps'
//     rows by cp.async during the product, one barrier a forward step and two
//     a backward step; units past H up to a multiple of 16 are dead.
//  5  fp32, H <= 128 (NARM's path): fused_gru_{fwd,bwd}_tf32_kernel, route
//     4's structure with every product as 3xTF32 on mma.sync m16n8k8 (the
//     design is at the kernels below): all of wh in fp32 once in the block's
//     shared memory (196,608 bytes at H 128), each operand split into hi and
//     lo as it is loaded; xi and dout come into registers a step ahead.
//  1  bf16, 128 < H <= cluster_max_hidden() = 384: wh split over a
//     thread-block cluster (fused_gru_{fwd,bwd}_cluster_kernel; the design
//     is at the cluster kernels below): 4 blocks up to H = 256, 8 above,
//     each holding its units' gate columns of wh in bf16, the recurrent
//     products on the tensor cores, h exchanged through distributed shared
//     memory.
//  2  fp32 above 128, bf16 above the cluster limit: the *_global kernels,
//     which keep wh in device memory, where at GRU widths it stays resident
//     in the 50 MB L2: gru_prep_wh_kernel writes wh rounded as the product
//     reads it, and its transpose for the backward's dhh wh^T, into scratch
//     once a call; each step a thread owns hidden units j, j + 256, ... for
//     all R rows of the block, reads its columns of wh in k-tiles of 4 rows
//     (neighbouring threads on neighbouring columns) against the block's h
//     rows in shared memory, and keeps the fp32 carry h (dh) in shared memory
//     beside them. The block owns R sequences, R a template parameter of its
//     kernels (16, 8, 4, 2 or 1, the largest whose shared memory fits,
//     chosen before launch by global_rows): the backward keeps R rows of h,
//     dh and dhh ((5 R + 3) H floats), so R 16 runs up to H 700, R 8 up to
//     1,348 and R 1 up to fused_gru_max_hidden() (7,264).
//  3  past that, route 2 at one sequence a block with its rows in device
//     memory.
// dwh is gru_dwh_tc_kernel (tensor cores, dhh entering as two bf16 terms) in
// the bf16 instance and gru_dwh_tf32_kernel (3xTF32) in the fp32 instance,
// at every H.
// H must be a multiple of 4 (the wrapper
// zero-pads any other H, which is exact: recbole_tpu_torch/ops/fused_gru.py).
// Any B and L.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 256;  // the global route's blocks
constexpr int kRows = 16;      // sequences a block owns on the one-block routes (4 and 5)
constexpr int kMaxH = 128;     // the one-block routes' largest H
constexpr size_t kSmemOptin = 232448;  // opt-in shared memory of a Hopper block

template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if (BF) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// The cluster kernels' gates, from the hardware exp2 and reciprocal: within
// about 1e-6 of sigm and tanhf (absolute), far inside the bf16 instance's
// rounding, at a fraction of the instructions (the gate math of 20-60
// (row, unit) pairs a thread is on every step's critical path).
__device__ __forceinline__ float sigm_fast(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_fast(float x) { return 2.0f * sigm_fast(2.0f * x) - 1.0f; }

// -------------------------------------------- wh in device memory (H > 128)

// wr = wh rounded as the product reads it (H, 3H), and wt = its transpose
// (3H, H), for the global-memory kernels
template <bool BF>
__global__ void gru_prep_wh_kernel(const float* __restrict__ wh, int H, float* __restrict__ wr,
                                   float* __restrict__ wt) {
  const int C = 3 * H;
  const size_t n = (size_t)H * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i / C), c = (int)(i - (size_t)k * C);
    const float v = rnd<BF>(wh[i]);
    wr[i] = v;
    wt[(size_t)c * H + k] = v;
  }
}

// acc[r][g] = sum_k hs[row r][k] * wr[k][j + g H] for all R rows, wr read
// from device memory (L2) four rows of k at a time
template <int R>
__device__ __forceinline__ void recurrent_product_global(const float* hs,
                                                         const float* __restrict__ wr, int H,
                                                         int j, float acc[R][3]) {
  const size_t C = 3 * (size_t)H;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
  for (int k = 0; k < H; k += 4) {
    float w[3][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 3; ++g) w[g][kk] = wr[(k + kk) * C + j + g * H];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 h = *reinterpret_cast<const float4*>(hs + r * H + k);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float a = acc[r][g];
        a = fmaf(h.x, w[g][0], a);
        a = fmaf(h.y, w[g][1], a);
        a = fmaf(h.z, w[g][2], a);
        a = fmaf(h.w, w[g][3], a);
        acc[r][g] = a;
      }
    }
  }
}

// the forward with wh in device memory: a block owns R sequences; its rows,
// two buffers of the block's rounded h rows and the fp32 carry, [3][R][H],
// lie in shared memory, or in device memory at rows_gm (3 R H floats a
// block) when they do not fit
template <bool BF, typename XT, int R>
__global__ void __launch_bounds__(kThreads)
fused_gru_fwd_global_kernel(const XT* __restrict__ xi, const float* __restrict__ h0,
                            const float* __restrict__ wr, const float* __restrict__ bh, int B,
                            int L, int H, float* __restrict__ rows_gm, XT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* hbuf = rows_gm ? rows_gm + (size_t)blockIdx.x * 3 * R * H
                        : reinterpret_cast<float*>(smem4);  // [2][R][H]
  float* hc = hbuf + 2 * R * H;                   // [R][H]
  const int b0 = blockIdx.x * R;
  const size_t C = 3 * (size_t)H;
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H, b = b0 + r;
    const float v = b < B ? h0[(size_t)b * H + j] : 0.0f;
    hc[i] = v;
    hbuf[i] = rnd<BF>(v);
  }
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < L; ++t) {
    const float* hs = hbuf + cur * R * H;
    float* nxt = hbuf + (cur ^ 1) * R * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[R][3];
      recurrent_product_global<R>(hs, wr, H, j, acc);
      const float bias[3] = {bh[j], bh[H + j], bh[2 * H + j]};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        const size_t base = ((size_t)b * L + t) * C + j;
        float x[3] = {0.0f, 0.0f, 0.0f};
        if (b < B)
          for (int g = 0; g < 3; ++g) x[g] = ld(xi, base + g * H);
        const float rr = sigm(x[0] + (acc[r][0] + bias[0]));
        const float z = sigm(x[1] + (acc[r][1] + bias[1]));
        const float n = tanhf(x[2] + rr * (acc[r][2] + bias[2]));
        const float h = (1.0f - z) * n + z * hc[r * H + j];
        hc[r * H + j] = h;
        nxt[r * H + j] = rnd<BF>(h);
        if (b < B) st(out, ((size_t)b * L + t) * H + j, h);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// the backward with wh in device memory, R sequences a block: its rows, the
// h_{t-1} rows, this step's dhh rows, the fp32 dh carry and the block's dbh
// sums, [R][H] + [R][3H] + [R][H] + [3H], lie in shared memory, or in device
// memory at rows_gm ((5 R + 3) H floats a block) when they do not fit
template <bool BF, typename XT, int R>
__global__ void __launch_bounds__(kThreads)
fused_gru_bwd_global_kernel(const XT* __restrict__ xi, const float* __restrict__ h0,
                            const float* __restrict__ wr, const float* __restrict__ wt,
                            const float* __restrict__ bh, const XT* __restrict__ out,
                            const XT* __restrict__ dout, int B, int L, int H,
                            float* __restrict__ rows_gm, XT* __restrict__ dxi,
                            float* __restrict__ dh0, float* __restrict__ dhh,
                            float* __restrict__ dbh_part) {
  extern __shared__ float4 smem4[];
  const int C = 3 * H;
  float* hs = rows_gm ? rows_gm + (size_t)blockIdx.x * (5 * R + 3) * H
                      : reinterpret_cast<float*>(smem4);  // [R][H]: h_{t-1} as the product reads it
  float* ds = hs + R * H;                       // [R][3H]: this step's dhh rows
  float* dhc = ds + R * C;                      // [R][H]: dh, fp32
  float* dbs = dhc + R * H;                     // [3H]: the block's dbh
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * R;

  auto h_prev = [&](int b, int t, int k) -> float {
    return t == 0 ? h0[(size_t)b * H + k] : ld(out, ((size_t)b * L + t - 1) * H + k);
  };
  auto load_hs = [&](int t) {
    for (int i = tid; i < R * H; i += blockDim.x) {
      const int rr = i / H, k = i - rr * H, b = b0 + rr;
      hs[i] = b < B ? rnd<BF>(h_prev(b, t, k)) : 0.0f;
    }
  };

  load_hs(L - 1);
  for (int i = tid; i < R * H; i += blockDim.x) dhc[i] = 0.0f;
  for (int i = tid; i < C; i += blockDim.x) dbs[i] = 0.0f;
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    for (int j = tid; j < H; j += blockDim.x) {
      float acc[R][3];
      recurrent_product_global<R>(hs, wr, H, j, acc);
      const float bias[3] = {bh[j], bh[H + j], bh[2 * H + j]};
      float dbj[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        const bool ok = b < B;
        const size_t base = ((size_t)b * L + t) * C + j;
        float x[3] = {0.0f, 0.0f, 0.0f}, hp = 0.0f, dy = 0.0f;
        if (ok) {
          for (int g = 0; g < 3; ++g) x[g] = ld(xi, base + g * H);
          hp = h_prev(b, t, j);
          dy = ld(dout, ((size_t)b * L + t) * H + j);
        }
        const float hr = acc[r][0] + bias[0], hz = acc[r][1] + bias[1],
                    hn = acc[r][2] + bias[2];
        const float rr = sigm(x[0] + hr);
        const float z = sigm(x[1] + hz);
        const float n = tanhf(x[2] + rr * hn);
        const float dh = dhc[r * H + j] + dy;
        const float dpre_n = dh * (1.0f - z) * (1.0f - n * n);
        const float dpre_r = dpre_n * hn * rr * (1.0f - rr);
        const float dpre_z = dh * (hp - n) * z * (1.0f - z);
        const float d[3] = {dpre_r, dpre_z, dpre_n * rr};
#pragma unroll
        for (int g = 0; g < 3; ++g) ds[r * C + g * H + j] = d[g];
        if (ok) {
          st(dxi, base, dpre_r);
          st(dxi, base + H, dpre_z);
          st(dxi, base + 2 * H, dpre_n);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            dhh[base + g * H] = d[g];
            dbj[g] += d[g];
          }
        }
        dhc[r * H + j] = dh * z;
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) dbs[g * H + j] += dbj[g];
    }
    __syncthreads();  // ds is complete, and nobody reads hs any more this step
    if (t > 0) load_hs(t - 1);
    // dh = dh z + round(dhh wh^T), wh^T read from device memory by column j
    for (int j = tid; j < H; j += blockDim.x) {
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = 0.0f;
      for (int c = 0; c < C; c += 4) {
        const float w0 = wt[(size_t)c * H + j], w1 = wt[(size_t)(c + 1) * H + j],
                    w2 = wt[(size_t)(c + 2) * H + j], w3 = wt[(size_t)(c + 3) * H + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(ds + r * C + c);
          float a = p[r];
          a = fmaf(d.x, w0, a);
          a = fmaf(d.y, w1, a);
          a = fmaf(d.z, w2, a);
          a = fmaf(d.w, w3, a);
          p[r] = a;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) dhc[r * H + j] += rnd<BF>(p[r]);
    }
    __syncthreads();  // hs holds the next step's rows; ds may be written again
  }
  for (int i = tid; i < R * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H, b = b0 + r;
    if (b < B) dh0[(size_t)b * H + j] = dhc[i];
  }
  for (int c = tid; c < C; c += blockDim.x) dbh_part[(size_t)blockIdx.x * C + c] = dbs[c];
}

// out[p] = sum of the n partials, in their order
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int n, long long P,
                                       float* __restrict__ out) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int b = 0; b < n; ++b) s += partials[(size_t)b * P + p];
  out[p] = s;
}

// ------------------------------------- tensor-core pieces (bf16 instance)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi): v to about 2^-16 of itself
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack2(a, b);
  const float2 h = unpack2(hi);
  lo = pack2(a - h.x, b - h.y);
}

// Element (row, col) of a row-major bf16 tile whose row holds S elements (S a
// multiple of 64): the 16-byte chunks of a row are XOR-swizzled by row % 8,
// so the eight rows an ldmatrix reads fall in eight distinct bank groups.
__device__ __forceinline__ int swz(int row, int col, int S) {
  return row * S + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// close the thread's group of copies, then wait for all but the newest group
__device__ __forceinline__ void cp_async_commit_wait_prior() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------- wh in a thread-block cluster (bf16, 128 < H)
//
// A cluster of CS blocks owns R = 16 MT sequences for the whole loop. Block c
// owns the Up hidden units [c Up, (c + 1) Up) (Up = ceil(H / CS) rounded up to
// 16; units past H are dead: zero wh, bh, xi and h0, so their h and dh stay
// exactly 0) and keeps the three gate columns of those units of wh, for all
// Kp = CS Up rows k, rounded to bf16, as whs[3 Up][Ks] (row n = g Up + u holds
// wh[k][g H + c Up + u] over k; Ks = Kp rounded up to 64, chunks swizzled).
// Warp w owns the units c Up + 8w + [0, 8): its three m16n8 accumulator tiles
// per 16 rows are the r, z and n columns of the same units, so a thread holds
// r, z and n of its (row, unit) pairs and the gate math and the fp32 carry
// stay in registers. The recurrent product h wh_slice (M R, N 3 Up, K Kp)
// runs on mma.sync m16n8k16, fed by ldmatrix from the block's copy of all R
// rows of h (bf16). Each step a block sends its new h slice into the next of
// two h buffers of every block of the cluster (distributed shared memory, 16
// bytes a store), then one cluster barrier (arrive.release / wait.acquire).
//
// The backward's recompute is the same product on h_{t-1}, read from the
// forward's output (h0 at t = 0) by cp.async a step ahead, into a region that
// it shares with the dhh tiles below (so that 80 rows fit at H 256).
// Its dhh wh^T is split by the block's own gate columns: the block's fp32 dhh
// goes through shared memory as two bf16 terms, hi = bf16(dhh) and lo =
// bf16(dhh - hi), and P_c = (hi + lo) wh_slice^T (M R, N Kp, K 3 Up; B by
// ldmatrix.trans from the same whs) is the block's partial for every unit.
// Warp w computes the tiles of units j Up + 8w + [0, 8) for every block j: the
// tile of its own block stays in registers, the others go into block j's
// receive buffer (slot c), and after a cluster barrier block j adds the CS
// partials in rank order, rounds the sum to bf16 once and forms
// dh = dh z + round(sum). A second, split barrier (arrive after the receive
// buffer is read, wait just before the next step's sends) keeps a fast block
// from writing into a buffer that is still being read.
//
// What bounds it at H 256 (B 2,048, L 50): the recurrent products are 40.3
// GFLOP forward and 121 backward, 0.041 and 0.122 ms at the bf16 tensor-core
// rate, and the bytes (xi and out; xi, out, dout, dxi and the fp32 dhh) take
// longer. But the loop is 50 serial steps, so a step's latency rules: one
// SM's product (R x 3 Up x Kp, fed from shared memory, whose bandwidth the
// ldmatrix reads of h bound before the tensor cores do), the exchange and
// the cluster barrier. Hence the rows a block (16 MT) are the fewest that
// fit the grid in one wave of resident clusters, wh never leaves shared
// memory, and the next step's xi (and dout, h_{t-1}) are in flight during
// the product.

constexpr int kClusterMaxUp = 64;  // units of a block: one warp per 8 of them

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// a block's units for H split over cs blocks, a multiple of 16
__host__ __device__ inline int cluster_up(int H, int cs) { return round_up((H + cs - 1) / cs, 16); }
__host__ __device__ inline int cluster_ks(int H, int cs) { return round_up(cs * cluster_up(H, cs), 64); }
// the row stride of the backward's dhh tiles: 3 Up elements, padded to an odd
// number of 16-byte chunks (conflict-free ldmatrix without a swizzle)
__host__ __device__ inline int cluster_s3(int up) { return 8 * ((3 * up / 8) | 1); }

// the backward's shared region (bf16 elements): h_{t-1}, or dhh's two terms
__host__ __device__ inline size_t cluster_union(int R, int ks, int s3) {
  const size_t h = (size_t)R * ks, d = (size_t)2 * R * s3;
  return h > d ? h : d;
}

inline size_t cluster_smem(int H, int cs, int mt, bool backward) {
  const int up = cluster_up(H, cs), ks = cluster_ks(H, cs), R = 16 * mt;
  const size_t w = (size_t)2 * 3 * up * ks;
  if (!backward) return w + (size_t)2 * 2 * R * ks;
  return w + 2 * cluster_union(R, ks, cluster_s3(up)) + (size_t)4 * (cs - 1) * R * up;
}

// The loads of a block's start run four items a thread at once (a round trip
// to L2 or device memory each), so that many are in flight.
constexpr int kStage = 4;

// whs <- the block's gate columns of wh, rounded to bf16, zero past H. An
// item is rows k, k + 1 of four units of one gate (two float4 loads, four
// bf16 pairs; H is a multiple of 4, so the four are all live or all dead).
__device__ void load_wh_slice(bf16* whs, const float* __restrict__ wh, int H, int c, int up,
                              int ks) {
  const int u4 = up / 4, per_k = 3 * u4, items = (ks / 2) * per_k;
  for (int i0 = threadIdx.x; i0 < items; i0 += kStage * blockDim.x) {
    float4 a[kStage], b[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * blockDim.x, k = 2 * (i / per_k), rest = i - (k / 2) * per_k;
      const int g = rest / u4, u = c * up + 4 * (rest - g * u4);
      a[s] = b[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < items && u < H && k < H) {
        const float* src = wh + (size_t)k * 3 * H + g * H + u;
        a[s] = *reinterpret_cast<const float4*>(src);
        b[s] = *reinterpret_cast<const float4*>(src + 3 * H);
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * blockDim.x, k = 2 * (i / per_k), rest = i - (k / 2) * per_k;
      const int g = rest / u4, n = g * up + 4 * (rest - g * u4);
      if (i >= items) continue;
      *reinterpret_cast<uint32_t*>(whs + swz(n, k, ks)) = pack2(a[s].x, b[s].x);
      *reinterpret_cast<uint32_t*>(whs + swz(n + 1, k, ks)) = pack2(a[s].y, b[s].y);
      *reinterpret_cast<uint32_t*>(whs + swz(n + 2, k, ks)) = pack2(a[s].z, b[s].z);
      *reinterpret_cast<uint32_t*>(whs + swz(n + 3, k, ks)) = pack2(a[s].w, b[s].w);
    }
  }
}

// hs[R][ks] <- round(h0) of the block's rows b0 .. b0 + R - 1, zero past B
// and past H (kp columns; four a float4 load)
__device__ void load_h0_rows(bf16* hs, const float* __restrict__ h0, int b0, int B, int H, int R,
                             int kp, int ks) {
  const int k4 = kp / 4, items = R * k4;
  for (int i0 = threadIdx.x; i0 < items; i0 += kStage * blockDim.x) {
    float4 v[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * blockDim.x, r = i / k4, k = 4 * (i - r * k4), b = b0 + r;
      v[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < items && b < B && k < H)
        v[s] = *reinterpret_cast<const float4*>(h0 + (size_t)b * H + k);
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * blockDim.x, r = i / k4, k = 4 * (i - r * k4);
      if (i < items)
        *reinterpret_cast<uint2*>(hs + swz(r, k, ks)) =
            make_uint2(pack2(v[s].x, v[s].y), pack2(v[s].z, v[s].w));
    }
  }
}

// acc[mt][g] += the rows of hs (R of them) times the warp's three gate tiles
template <int MT>
__device__ __forceinline__ void cluster_product(const bf16* hs, const bf16* whs, int kp, int ks,
                                                int up, int warp, int lane,
                                                float acc[MT][3][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < 3; ++g) acc[mt][g][0] = acc[mt][g][1] = acc[mt][g][2] = acc[mt][g][3] = 0.0f;
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int brow = warp * 8 + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
  const int bg = lane >> 4;  // gate 0 or 1 in the x4 load
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t b[3][2];
    ldsm_x4(whs + swz(bg * up + brow, k0 + bcol, ks), b[0][0], b[0][1], b[1][0], b[1][1]);
    ldsm_x2(whs + swz(2 * up + brow, k0 + bcol, ks), b[2][0], b[2][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm_x4(hs + swz(mt * 16 + arow, k0 + acol, ks), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int g = 0; g < 3; ++g) mma16816(acc[mt][g], a, b[g][0], b[g][1]);
    }
  }
}

// The four lanes of a quad hold units 2q, 2q + 1 of rows r (v0) and r + 8
// (v1); afterwards lanes q = 0, 2 hold row r's eight units and q = 1, 3 row
// r + 8's, as one 16-byte vector.
__device__ __forceinline__ uint4 quad_gather(uint32_t v0, uint32_t v1, int lane) {
  const int base = lane & ~3;
  uint32_t a[4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = __shfl_sync(0xffffffffu, v0, base + i);
    b[i] = __shfl_sync(0xffffffffu, v1, base + i);
  }
  return (lane & 1) ? make_uint4(b[0], b[1], b[2], b[3]) : make_uint4(a[0], a[1], a[2], a[3]);
}

// eight bf16 units u0 .. u0 + 7 of row p of a (rows, H) bf16 tensor, the
// live ones only (H a multiple of 4, so 0, 4 or 8 of them)
__device__ __forceinline__ void store_units8(bf16* p, int u0, int H, uint4 v) {
  if (u0 >= H) return;
  if ((H & 7) == 0) {
    *reinterpret_cast<uint4*>(p + u0) = v;
    return;
  }
  *reinterpret_cast<uint2*>(p + u0) = make_uint2(v.x, v.y);
  if (u0 + 4 < H) *reinterpret_cast<uint2*>(p + u0 + 4) = make_uint2(v.z, v.w);
}

template <int CS, int MT>
__global__ void __launch_bounds__(4 * kClusterMaxUp)
fused_gru_fwd_cluster_kernel(const bf16* __restrict__ xi, const float* __restrict__ h0,
                             const float* __restrict__ wh, const float* __restrict__ bh, int B,
                             int L, int H, bf16* __restrict__ out) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int up = cluster_up(H, CS), kp = CS * up, ks = cluster_ks(H, CS);
  bf16* whs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hb = whs + (size_t)3 * up * ks;  // [2][R][ks]: h as the product reads it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int b0 = (blockIdx.x / CS) * R;
  const int u0 = c * up + warp * 8, uu = u0 + 2 * q;  // the thread's units uu, uu + 1
  const bool alive = uu < H;
  const size_t C3 = 3 * (size_t)H;

  load_wh_slice(whs, wh, H, c, up, ks);
  load_h0_rows(hb, h0, b0, B, H, R, kp, ks);
  // the fp32 carry of the thread's (row, unit) pairs, in accumulator order:
  // [mt][0] (row gr, uu), [1] (gr, uu + 1), [2] (gr + 8, uu), [3] (gr + 8, uu + 1)
  float h[MT][4], bias[3][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + mt * 16 + gr + 8 * (e >> 1);
      h[mt][e] = (alive && b < B) ? h0[(size_t)b * H + uu + (e & 1)] : 0.0f;
    }
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int j = 0; j < 2; ++j) bias[g][j] = alive ? bh[g * H + uu + j] : 0.0f;
  uint32_t x[MT][2][3];  // xi of the step, bf16 pairs: [mt][row half][gate]
  auto load_xi = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + mt * 16 + gr + 8 * i;
        const bool ok = alive && b < B;
        const size_t base = ((size_t)b * L + t) * C3 + uu;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[mt][i][g] = ok ? __ldg(reinterpret_cast<const unsigned int*>(xi + base + g * H)) : 0u;
      }
  };
  load_xi(0);
  __syncthreads();
  cluster.sync();  // every block runs and holds wh and h0 before anyone sends

  int cur = 0;
  for (int t = 0; t < L; ++t) {
    float acc[MT][3][4];
    cluster_product<MT>(hb + (size_t)cur * R * ks, whs, kp, ks, up, warp, lane, acc);
    uint32_t hv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = e & 1;
        const float2 xr = unpack2(x[mt][i][0]), xz = unpack2(x[mt][i][1]),
                     xn = unpack2(x[mt][i][2]);
        const float rr = sigm_fast((j ? xr.y : xr.x) + (acc[mt][0][e] + bias[0][j]));
        const float z = sigm_fast((j ? xz.y : xz.x) + (acc[mt][1][e] + bias[1][j]));
        const float n = tanh_fast((j ? xn.y : xn.x) + rr * (acc[mt][2][e] + bias[2][j]));
        h[mt][e] = (1.0f - z) * n + z * h[mt][e];
      }
      hv[mt][0] = pack2(h[mt][0], h[mt][1]);
      hv[mt][1] = pack2(h[mt][2], h[mt][3]);
    }
    bf16* nxt = hb + (size_t)(cur ^ 1) * R * ks;
    uint4 v[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      v[mt] = quad_gather(hv[mt][0], hv[mt][1], lane);
      if (t + 1 < L) {
        // lanes q = 0, 1 send to the first half of the cluster, q = 2, 3 to the rest
        const int r = mt * 16 + gr + 8 * (q & 1);
#pragma unroll
        for (int jj = 0; jj < CS / 2; ++jj) {
          const int j = (q >> 1) * (CS / 2) + jj;
          bf16* dst = j == c ? nxt : cluster.map_shared_rank(nxt, j);
          *reinterpret_cast<uint4*>(dst + swz(r, u0, ks)) = v[mt];
        }
      }
    }
    // The out stores and the next step's xi loads go after the arrive: its
    // release would otherwise wait for them to reach device memory.
    if (t + 1 < L) cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int b = b0 + mt * 16 + gr + 8 * (q & 1);
      if (q < 2 && b < B) store_units8(out + ((size_t)b * L + t) * H, u0, H, v[mt]);
    }
    if (t + 1 < L) {
      load_xi(t + 1);
      cluster_wait();
    }
    cur ^= 1;
  }
}

// The backward on the same cluster and the same wh slice: dxi (bf16), dhh
// (fp32, for dwh), dh0 and the cluster's dbh partial (row blockIdx.x / CS).
template <int CS, int MT>
__global__ void __launch_bounds__(4 * kClusterMaxUp)
fused_gru_bwd_cluster_kernel(const bf16* __restrict__ xi, const float* __restrict__ h0,
                             const float* __restrict__ wh, const float* __restrict__ bh,
                             const bf16* __restrict__ out, const bf16* __restrict__ dout, int B,
                             int L, int H, bf16* __restrict__ dxi, float* __restrict__ dh0,
                             float* __restrict__ dhh, float* __restrict__ dbh_part) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int up = cluster_up(H, CS), kp = CS * up, ks = cluster_ks(H, CS), s3 = cluster_s3(up);
  bf16* whs = reinterpret_cast<bf16*>(smem_raw);
  // one region holds h_{t-1} as the product reads it ([R][ks]) until the
  // recompute is done, then dhh's hi and lo terms ([2][R][s3]) until the
  // dhh wh^T product is done, then the next step's h_{t-1}
  bf16* hb = whs + (size_t)3 * up * ks;
  bf16* dsc = hb;
  float* recv = reinterpret_cast<float*>(hb + cluster_union(R, ks, s3));  // [CS - 1][R][up]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int b0 = (blockIdx.x / CS) * R;
  const int u0 = c * up + warp * 8, uu = u0 + 2 * q, ul = warp * 8 + 2 * q;
  const bool alive = uu < H;
  const size_t C3 = 3 * (size_t)H;
  const int tid = threadIdx.x, nth = blockDim.x;
  // h_{t-1} rows go in 16-byte pieces when a row of out is 16-byte aligned
  const int piece = H % 8 ? 4 : 8, kn = kp / piece;

  // hb <- h_{tp} (the forward's output at tp; round(h0) when tp < 0), zero in
  // the rows past B and the units past H
  auto fetch_h = [&](int tp) {
    if (tp < 0) {
      load_h0_rows(hb, h0, b0, B, H, R, kp, ks);
      return;
    }
    for (int i = tid; i < R * kn; i += nth) {
      const int r = i / kn, k = piece * (i - r * kn), b = b0 + r;
      bf16* dst = hb + swz(r, k, ks);
      const bf16* src = out + ((size_t)b * L + tp) * H + k;
      if (piece == 8) {
        if (b >= B || k >= H)
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        else
          cp_async16(dst, src);
      } else if (b >= B || k >= H) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      } else {
        cp_async8(dst, src);
      }
    }
  };
  uint32_t x[MT][2][3], dy[MT][2];
  auto load_step = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + mt * 16 + gr + 8 * i;
        const bool ok = alive && b < B;
        const size_t row = (size_t)b * L + t;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[mt][i][g] = ok ? __ldg(reinterpret_cast<const unsigned int*>(xi + row * C3 + g * H + uu))
                           : 0u;
        dy[mt][i] = ok ? __ldg(reinterpret_cast<const unsigned int*>(dout + row * H + uu)) : 0u;
      }
  };

  load_wh_slice(whs, wh, H, c, up, ks);
  fetch_h(L - 2);
  load_step(L - 1);
  float dh[MT][4], bias[3][2], dbs[3][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[mt][e] = 0.0f;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bias[g][j] = alive ? bh[g * H + uu + j] : 0.0f;
      dbs[g][j] = 0.0f;
    }
  cluster.sync();  // every block runs before anyone sends
  cluster_arrive();  // the first step's receive buffers are free

  for (int t = L - 1; t >= 0; --t) {
    cp_async_wait_all();
    __syncthreads();  // hb holds h_{t-1}
    float acc[MT][3][4];
    cluster_product<MT>(hb, whs, kp, ks, up, warp, lane, acc);
    uint32_t hpv[MT][2];  // h_{t-1} of the thread's (row, unit) pairs, t > 0
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        hpv[mt][i] = *reinterpret_cast<const uint32_t*>(hb + swz(mt * 16 + gr + 8 * i, uu, ks));
    __syncthreads();  // nobody reads hb any more this step: the region holds dsc now
    // gates, dhh, dxi; acc[mt][1] keeps z for the dh update
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + gr + 8 * i, b = b0 + r;
        const bool ok = alive && b < B;
        float2 hp = make_float2(0.0f, 0.0f);
        if (t > 0)
          hp = unpack2(hpv[mt][i]);
        else if (ok)
          hp = *reinterpret_cast<const float2*>(h0 + (size_t)b * H + uu);
        const float2 xr = unpack2(x[mt][i][0]), xz = unpack2(x[mt][i][1]),
                     xn = unpack2(x[mt][i][2]), dyv = unpack2(dy[mt][i]);
        float d[3][2], dn[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const float hr = acc[mt][0][e] + bias[0][j], hz = acc[mt][1][e] + bias[1][j],
                      hn = acc[mt][2][e] + bias[2][j];
          const float rr = sigm_fast((j ? xr.y : xr.x) + hr);
          const float z = sigm_fast((j ? xz.y : xz.x) + hz);
          const float n = tanh_fast((j ? xn.y : xn.x) + rr * hn);
          dh[mt][e] += j ? dyv.y : dyv.x;
          const float dpre_n = dh[mt][e] * (1.0f - z) * (1.0f - n * n);
          d[0][j] = dpre_n * hn * rr * (1.0f - rr);
          d[1][j] = dh[mt][e] * ((j ? hp.y : hp.x) - n) * z * (1.0f - z);
          d[2][j] = dpre_n * rr;
          dn[j] = dpre_n;
          acc[mt][1][e] = z;
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          uint32_t hi, lo;
          split2(d[g][0], d[g][1], hi, lo);
          const int col = g * up + ul;
          *reinterpret_cast<uint32_t*>(dsc + (size_t)r * s3 + col) = hi;
          *reinterpret_cast<uint32_t*>(dsc + (size_t)(R + r) * s3 + col) = lo;
        }
        if (ok) {
          const size_t row = (size_t)b * L + t;
          bf16* dx = dxi + row * C3 + uu;
          *reinterpret_cast<uint32_t*>(dx) = pack2(d[0][0], d[0][1]);
          *reinterpret_cast<uint32_t*>(dx + H) = pack2(d[1][0], d[1][1]);
          *reinterpret_cast<uint32_t*>(dx + 2 * H) = pack2(dn[0], dn[1]);
          float* dd = dhh + row * C3 + uu;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            *reinterpret_cast<float2*>(dd + g * H) = make_float2(d[g][0], d[g][1]);
            dbs[g][0] += d[g][0];
            dbs[g][1] += d[g][1];
          }
        }
      }
    __syncthreads();  // dsc is complete
    // P = (hi + lo) wh_slice^T for the warp's units in every block j
    float p[CS][MT][4];
#pragma unroll
    for (int j = 0; j < CS; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) p[j][mt][0] = p[j][mt][1] = p[j][mt][2] = p[j][mt][3] = 0.0f;
    for (int s = 0; s < 3 * up; s += 16) {
      uint32_t bw[CS][2];
#pragma unroll
      for (int j = 0; j < CS; j += 2) {
        const int k0 = (j + (lane >> 4)) * up + warp * 8;
        ldsm_x4_t(whs + swz(s + (lane & 15), k0, ks), bw[j][0], bw[j][1], bw[j + 1][0],
                  bw[j + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ah[4], al[4];
        const size_t arow = (size_t)(mt * 16 + (lane & 15)) * s3 + s + (lane >> 4) * 8;
        ldsm_x4(dsc + arow, ah[0], ah[1], ah[2], ah[3]);
        ldsm_x4(dsc + (size_t)R * s3 + arow, al[0], al[1], al[2], al[3]);
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          mma16816(p[j][mt], ah, bw[j][0], bw[j][1]);
          mma16816(p[j][mt], al, bw[j][0], bw[j][1]);
        }
      }
    }
    __syncthreads();  // nobody reads dsc any more: the region takes the next h_{t-1}
    // the next step's xi and dout, in flight while the partials go out (done
    // long before the arrive's release below)
    if (t > 0) load_step(t - 1);
    cluster_wait();  // every block has read its receive buffer of the step before
    // each partial tile as 16-byte stores: lanes q and q ^ 1 swap halves, so
    // that an even q holds units ul .. ul + 3 of row gr and an odd q those of
    // row gr + 8 (from ul - 2)
    const bool odd = q & 1;
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      if (j == c) continue;
      float* dst = cluster.map_shared_rank(recv, j) + (size_t)(c < j ? c : c - 1) * R * up;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* v = p[j][mt];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        const int row = mt * 16 + gr + (odd ? 8 : 0), col = odd ? ul - 2 : ul;
        *reinterpret_cast<float4*>(dst + row * up + col) =
            odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
      }
    }
    cluster_arrive();
    // the next h_{t-1} goes after the arrive
    if (t > 0) fetch_h(t - 2);
    cluster_wait();  // the partials for this block's units have landed
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float2 sum = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          float2 v;
          if (j == c)
            v = make_float2(p[j][mt][2 * i], p[j][mt][2 * i + 1]);
          else
            v = *reinterpret_cast<const float2*>(recv + (size_t)(j < c ? j : j - 1) * R * up +
                                                 (mt * 16 + gr + 8 * i) * up + ul);
          sum.x += v.x;
          sum.y += v.y;
        }
        const int e = 2 * i;
        dh[mt][e] = dh[mt][e] * acc[mt][1][e] + rnd<true>(sum.x);
        dh[mt][e + 1] = dh[mt][e + 1] * acc[mt][1][e + 1] + rnd<true>(sum.y);
      }
    // this block's receive buffer may be written again (its reads are
    // done: their values are in dh), and nothing needs releasing
    cluster_arrive_relaxed();
  }
  cluster_wait();  // no block sends into this one any more
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = b0 + mt * 16 + gr + 8 * i;
      if (alive && b < B)
        *reinterpret_cast<float2*>(dh0 + (size_t)b * H + uu) =
            make_float2(dh[mt][2 * i], dh[mt][2 * i + 1]);
    }
  // the cluster's dbh over its rows: the eight lanes of a unit pair, in a fixed tree
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = dbs[g][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gr == 0 && alive) dbh_part[(size_t)(blockIdx.x / CS) * C3 + g * H + uu + j] = v;
    }
}

// The per-step floor of the cluster forward: each step only sends the
// block's h slice into every block of the cluster (the same stores as the
// forward) and waits at the cluster barrier, with no gate math, no loads or
// stores of device memory and (PRODUCT false) no product; PRODUCT adds the
// forward's recurrent product on whatever the buffers hold. Writes one
// value a thread to sink so that nothing is dropped.
template <int CS, int MT, bool PRODUCT>
__global__ void __launch_bounds__(4 * kClusterMaxUp)
gru_cluster_floor_kernel(int L, int H, float* __restrict__ sink) {
  constexpr int R = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int up = cluster_up(H, CS), ks = cluster_ks(H, CS);
  const bf16* whs = reinterpret_cast<const bf16*>(smem_raw);
  bf16* hb = reinterpret_cast<bf16*>(smem_raw) + (size_t)3 * up * ks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int u0 = c * up + warp * 8;
  cluster.sync();
  int cur = 0;
  uint32_t v0 = lane, v1 = ~lane;
  for (int t = 0; t + 1 < L; ++t) {
    if (PRODUCT) {
      float acc[MT][3][4];
      cluster_product<MT>(hb + (size_t)cur * R * ks, whs, CS * up, ks, up, warp, lane, acc);
      v1 += __float_as_uint(acc[MT - 1][2][3]);
    }
    bf16* nxt = hb + (size_t)(cur ^ 1) * R * ks;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 v = quad_gather(v0 + mt, v1 + t, lane);
      const int r = mt * 16 + gr + 8 * (q & 1);
#pragma unroll
      for (int jj = 0; jj < CS / 2; ++jj) {
        const int j = (q >> 1) * (CS / 2) + jj;
        *reinterpret_cast<uint4*>(cluster.map_shared_rank(nxt, j) + swz(r, u0, ks)) = v;
      }
    }
    cluster_arrive();
    cluster_wait();
    cur ^= 1;
    v0 += *reinterpret_cast<const uint32_t*>(hb + (size_t)cur * R * ks + swz(gr, u0 + 2 * q, ks));
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = (float)v0;
}

// partial[chunk] = sum over the chunk's rows n = (b, t) of h_{t-1}[b]^T dhh[n]
// on the tensor cores (bf16 instance): h_{t-1} is exact in bf16, dhh enters
// as hi + lo (two passes), sums in fp32. A block owns a 64 KW x 128 tile of
// dwh (k, c), KW x 4 warps of 64 x 32 outputs, and walks the chunk's rows 32
// at a time, loading the next rows into registers while it multiplies the
// ones in shared memory. KW = 4 above H 128 (one block an SM), so that dhh,
// the larger operand, is read once per column tile up to H 256; else 2 (two
// blocks an SM).
constexpr int kDT = 128, kDN = 32;  // columns of a tile, rows a pass

inline int dwh_tc_kw(int H) { return H > kDT ? 4 : 2; }

template <int KW>
__global__ void __launch_bounds__(128 * KW, 4 / KW)
gru_dwh_tc_kernel(const bf16* __restrict__ out, const float* __restrict__ h0,
                  const float* __restrict__ dhh, int B, int L, int H, int chunk_rows,
                  float* __restrict__ partials) {
  constexpr int BM = 64 * KW, NT = 128 * KW, DS = kDN * kDT / 4 / NT;
  __shared__ __align__(16) bf16 As[kDN * BM];       // [n][k]: h_{t-1}
  __shared__ __align__(16) bf16 Bs[2][kDN * kDT];   // [hi, lo][n][c]: dhh
  const int C = 3 * H, N = B * L;
  const int c0 = blockIdx.x * kDT, k0 = blockIdx.y * BM;
  const int n_begin = blockIdx.z * chunk_rows, n_end = min(N, n_begin + chunk_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // the warp's k and c offsets
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  // each thread stages 4 groups of 4 h values and DS groups of 4 dhh values
  uint2 hreg[4];
  float4 dreg[DS];
  auto fetch = [&](int n0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = threadIdx.x + s * NT, rr = i / (BM / 4), k = k0 + 4 * (i % (BM / 4));
      const int n = n0 + rr;
      hreg[s] = make_uint2(0u, 0u);
      if (n < n_end && k < H) {
        const int b = n / L, t = n - b * L;
        if (t == 0) {
          const float4 v = *reinterpret_cast<const float4*>(h0 + (size_t)b * H + k);
          hreg[s] = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
        } else {
          hreg[s] = *reinterpret_cast<const uint2*>(out + ((size_t)n - 1) * H + k);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      const int i = threadIdx.x + s * NT, n = n0 + i / (kDT / 4), cl = c0 + 4 * (i % (kDT / 4));
      dreg[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < n_end && cl < C) dreg[s] = *reinterpret_cast<const float4*>(dhh + (size_t)n * C + cl);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = threadIdx.x + s * NT;
      *reinterpret_cast<uint2*>(As + swz(i / (BM / 4), 4 * (i % (BM / 4)), BM)) = hreg[s];
    }
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      const int i = threadIdx.x + s * NT;
      const int o = swz(i / (kDT / 4), 4 * (i % (kDT / 4)), kDT);
      uint32_t h01, l01, h23, l23;
      split2(dreg[s].x, dreg[s].y, h01, l01);
      split2(dreg[s].z, dreg[s].w, h23, l23);
      *reinterpret_cast<uint2*>(Bs[0] + o) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(Bs[1] + o) = make_uint2(l01, l23);
    }
  };
  if (n_begin < n_end) fetch(n_begin);
  for (int n0 = n_begin; n0 < n_end; n0 += kDN) {
    stage();
    __syncthreads();
    if (n0 + kDN < n_end) fetch(n0 + kDN);
#pragma unroll
    for (int ks = 0; ks < kDN; ks += 16) {
      // A = h^T (k x n) from As[n][k], B = dhh (n x c) from Bs[n][c], both by .trans
      uint32_t bh[4][2], bl[4][2];
      const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        const int o = swz(ks + (mi & 1) * 8 + r8, wn + nt * 8 + (mi >> 1) * 8, kDT);
        ldsm_x4_t(Bs[0] + o, bh[nt][0], bh[nt][1], bh[nt + 1][0], bh[nt + 1][1]);
        ldsm_x4_t(Bs[1] + o, bl[nt][0], bl[nt][1], bl[nt + 1][0], bl[nt + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4_t(As + swz(ks + (mi >> 1) * 8 + r8, wm + mt * 16 + (mi & 1) * 8, BM), a[0],
                  a[1], a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma16816(acc[mt][nt], a, bh[nt][0], bh[nt][1]);
          mma16816(acc[mt][nt], a, bl[nt][0], bl[nt][1]);
        }
      }
    }
    __syncthreads();
  }
  float* part = partials + (size_t)blockIdx.z * H * C;
  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + wm + mt * 16 + gr + 8 * i, cl = c0 + wn + nt * 8 + 2 * q;
        if (k < H && cl < C)
          *reinterpret_cast<float2*>(part + (size_t)k * C + cl) =
              make_float2(acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
      }
}

// ------------------- tensor cores in one block (bf16 instance, H <= 128)
//
// A block owns kTcRows = 16 sequences for the whole loop and holds all of wh,
// rounded to bf16, in shared memory as the cluster kernels' whs with one
// block: whs[3 Hp][Ks] (row g Hp + u holds wh[k][g H + u] over k; Hp = H
// rounded up to 16, Ks = Hp rounded up to 64, chunks swizzled). Units past H
// are dead: zero wh, bh, xi and h0, so their h and dh stay exactly 0 and their
// zero rows of wh add exact zeros (tests/test_torch_gru.py checks the padding
// on the plain version). Warp w owns the units 8 NT w + [0, 8 NT) in all three
// gates, NT n8 tiles a gate, so Hp / (8 NT) warps a block: its r, z and n
// accumulator tiles are the same (row, unit) pairs, and the gate math and the
// fp32 carry h (dh) stay in registers. The recurrent product h wh (M 16, N
// 3 Hp, K Hp) runs on mma.sync m16n8k16, A by ldmatrix from the block's bf16
// copy of h, B by ldmatrix from whs. Each step the new h slice goes into the
// other of two h buffers (16-byte stores), then one __syncthreads. xi is
// staged two steps ahead (cp.async into three buffers, one group of copies a
// step, each waited for a step after it was issued), so no device-memory
// latency sits on the serial chain, and out leaves as 16-byte stores.
//
// The backward's recompute is the same product on h_{t-1}, staged with xi_t
// and dout_t a step ahead by cp.async from the forward's output (round(h0)
// at t = 0). dhh wh^T (M 16, N Hp, K 3 Hp) runs on the tensor cores from the
// same whs (B by ldmatrix.trans): the block's dhh goes through shared memory
// as two bf16 terms, hi = bf16(dhh) and lo = bf16(dhh - hi), two mma a tile
// and k-step, the sum rounded to bf16 once, then dh = dh z + round(sum). Two
// barriers a step: dhh's terms complete, then their reads done and the next
// step's staging landed. dxi (bf16) and dhh (fp32, for gru_dwh_tc_kernel)
// leave through shared memory too: the gates write the step's rows there
// beside dhh's terms, and after the first barrier a warp stores a (row,
// gate) at a time, H contiguous elements (stores from the gates' own (row,
// unit) layout touch 16 rows each: 0.35 ms for the recurrent backward
// against 0.31). The dbh partial is the block's, over its rows in a fixed
// tree.
//
// What bounds it at GRU4Rec's step (B 2,048, L 50, H 128): 128 blocks, one
// an SM, each 50 serial steps, so a step's latency and the SM's shared-memory
// bandwidth, not device memory (0.032 / 0.063 ms at 3.35 TB/s) or the tensor
// cores. A forward step at 16 warps reads 64 KB of h and 96 KB of wh by
// ldmatrix for 384 mma; a backward step at 8 warps 32 + 96 KB for the
// recompute and 192 + 96 KB for dhh wh^T (every warp reads all of dhh's hi
// and lo rows), 1,152 mma. scripts/torch_gru_probe.py reads a step's clocks
// by phase (H100, block 0): forward 2,237 product, 1,014 gates and exchange,
// 7 at the barrier; backward 1,667 issuing the next step's copies, 1,519
// recompute, 2,369 gates, 2,767 dhh wh^T, 1,857 storing the rows (every
// block stores in the same burst), 46 at the barriers. Measured choices
// (scripts/torch_gru_ab.py on copies of this source that differ in one
// choice, each set in one call): the forward at 16 warps (8 units a warp),
// 0.108 ms against 0.128 at 8; the backward at 8 warps, 0.348 against 0.383
// at 16 (the recurrent kernel); wh's B fragments loaded once into registers
// lost to ldmatrix every step (forward 0.122 and 0.136 at 16 and 8 warps,
// backward 0.359); four mma chains in dhh wh^T in place of one lost (0.383
// against 0.350); xi two steps ahead in place of one gained 5% forward;
// issuing the copies after the product in place of before lost 13% forward.

constexpr int kTcRows = 16;           // sequences a block
constexpr int kTcMaxKs = kMaxH / 16;  // k16 steps of the recurrent product at most
// n8 tiles a gate a warp (8 NT units a warp): the forward 1 (16 warps at H
// 128), the backward 2 (8 warps)
constexpr int kTcFwdNT = 1, kTcBwdNT = 2;
constexpr int kTcXiStages = 3;        // the forward's xi buffers: two steps ahead

__host__ __device__ inline int tc_hp(int H) { return round_up(H, 16); }
__host__ __device__ inline int tc_ks(int H) { return round_up(tc_hp(H), 64); }
// 32-bit words of a staged xi row (3H bf16) and dout row (H bf16), padded to
// 4 mod 8 words: a warp's reads (8 rows x 4 unit pairs) hit 32 distinct banks
__host__ __device__ inline int tc_xw(int H) { return round_up(3 * H / 2, 8) + 4; }
__host__ __device__ inline int tc_dw(int H) { return round_up(H / 2, 8) + 4; }

inline int tc_threads(int H, int nt) { return 32 * tc_hp(H) / (8 * nt); }
__host__ __device__ inline size_t tc_wh_bytes(int H) {
  return (size_t)2 * 3 * tc_hp(H) * tc_ks(H);
}
// one backward staging buffer: h_{t-1} rows [16][Ks] bf16, xi_t [16][xw] and
// dout_t [16][dw] words
__host__ __device__ inline size_t tc_stage_bytes(int H) {
  return (size_t)2 * kTcRows * tc_ks(H) + (size_t)4 * kTcRows * (tc_xw(H) + tc_dw(H));
}

inline size_t tc_smem(int H, bool backward) {
  if (!backward)  // wh, two h buffers, the xi buffers
    return tc_wh_bytes(H) + (size_t)2 * 2 * kTcRows * tc_ks(H) +
           (size_t)kTcXiStages * 4 * kTcRows * tc_xw(H);
  // wh, two staging buffers, dhh's hi and lo rows, the step's dxi (bf16) and
  // dhh (fp32) rows on their way out
  const int s3 = cluster_s3(tc_hp(H));
  return tc_wh_bytes(H) + 2 * tc_stage_bytes(H) + (size_t)(2 * 2 + 2 + 4) * kTcRows * s3;
}

// the B fragments of k16 step kk for the warp's gate tiles (units u0 + [0, 8 NT))
template <int NT>
__device__ __forceinline__ void tc_load_b(const bf16* whs, int kk, int hp, int ks, int u0,
                                          int lane, uint32_t b[3][NT][2]) {
  const int k0 = kk * 16 + ((lane >> 3) & 1) * 8;
  if constexpr (NT == 2) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ldsm_x4(whs + swz(g * hp + u0 + (lane & 7) + (lane >> 4) * 8, k0, ks), b[g][0][0],
              b[g][0][1], b[g][1][0], b[g][1][1]);
  } else {
    ldsm_x4(whs + swz((lane >> 4) * hp + u0 + (lane & 7), k0, ks), b[0][0][0], b[0][0][1],
            b[1][0][0], b[1][0][1]);
    ldsm_x2(whs + swz(2 * hp + u0 + (lane & 7), k0, ks), b[2][0][0], b[2][0][1]);
  }
}

// acc[g][nt] = the 16 rows of hs times the warp's gate tiles of wh
template <int NT>
__device__ __forceinline__ void tc_product(const bf16* hs, const bf16* whs, int nks, int hp,
                                           int ks, int u0, int lane, float acc[3][NT][4]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kTcMaxKs; ++kk) {
    if (kk < nks) {
      uint32_t a[4];
      ldsm_x4(hs + swz(lane & 15, kk * 16 + (lane >> 4) * 8, ks), a[0], a[1], a[2], a[3]);
      uint32_t b[3][NT][2];
      tc_load_b<NT>(whs, kk, hp, ks, u0, lane, b);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16816(acc[g][nt], a, b[g][nt][0], b[g][nt][1]);
    }
  }
}

// dst[r][.] <- the 3H (xi) or H (dout) bf16 of row (b0 + r, t) of src, rows
// past B left alone, by cp.async in 16-byte pieces (8-byte when H % 8)
__device__ __forceinline__ void tc_stage_rows(uint32_t* dst, int dwords, const bf16* src, int w,
                                              int b0, int B, int L, int t, int H) {
  const int piece = H % 8 ? 4 : 8, per = w / piece;
  for (int i = threadIdx.x; i < kTcRows * per; i += blockDim.x) {
    const int r = i / per, p = i - r * per, b = b0 + r;
    if (b >= B) continue;
    uint32_t* d = dst + (size_t)r * dwords + p * (piece / 2);
    const bf16* s = src + ((size_t)b * L + t) * w + p * piece;
    if (piece == 8)
      cp_async16(d, s);
    else
      cp_async8(d, s);
  }
}

// hs[16][ks] <- h_{tp} of the block's rows (the forward's output at tp, bf16),
// zero past B and past H (Hp columns)
__device__ __forceinline__ void tc_stage_h(bf16* hs, const bf16* out, int b0, int B, int L, int tp,
                                           int H, int ks) {
  const int piece = H % 8 ? 4 : 8, kn = tc_hp(H) / piece;
  for (int i = threadIdx.x; i < kTcRows * kn; i += blockDim.x) {
    const int r = i / kn, k = piece * (i - r * kn), b = b0 + r;
    bf16* d = hs + swz(r, k, ks);
    const bf16* s = out + ((size_t)b * L + tp) * H + k;
    if (piece == 8) {
      if (b >= B || k >= H)
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async16(d, s);
    } else if (b >= B || k >= H) {
      *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    } else {
      cp_async8(d, s);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(32 * kMaxH / (8 * NT))
fused_gru_fwd_tc_kernel(const bf16* __restrict__ xi, const float* __restrict__ h0,
                        const float* __restrict__ wh, const float* __restrict__ bh, int B, int L,
                        int H, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = tc_hp(H), ks = tc_ks(H), nks = hp / 16, xw = tc_xw(H), C3 = 3 * H;
  bf16* whs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hb = whs + (size_t)3 * hp * ks;                                  // [2][16][ks]
  uint32_t* xs = reinterpret_cast<uint32_t*>(hb + (size_t)2 * kTcRows * ks);  // [3][16][xw]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kTcRows, u0 = warp * 8 * NT;

  load_wh_slice(whs, wh, H, 0, hp, ks);
  load_h0_rows(hb, h0, b0, B, H, kTcRows, hp, ks);
  // xi_t goes into buffer t % 3, two steps ahead, one group of copies a step
  tc_stage_rows(xs, xw, xi, C3, b0, B, L, 0, H);
  cp_async_commit();
  if (L > 1) tc_stage_rows(xs + kTcRows * xw, xw, xi, C3, b0, B, L, 1, H);
  // the fp32 carry of the thread's (row, unit) pairs, in accumulator order:
  // [nt][0] (row gr, uu), [1] (gr, uu + 1), [2] (gr + 8, uu), [3] (gr + 8, uu + 1)
  float h[NT][4], bias[3][NT][2];
  bool alive[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int uu = u0 + nt * 8 + 2 * q;
    alive[nt] = uu < H;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + gr + 8 * (e >> 1);
      h[nt][e] = (alive[nt] && b < B) ? h0[(size_t)b * H + uu + (e & 1)] : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) bias[g][nt][j] = alive[nt] ? bh[g * H + uu + j] : 0.0f;
  }
  cp_async_commit_wait_prior();  // xi_0 has landed
  __syncthreads();

  int cur = 0, xb = 0;  // xb = t % 3
  for (int t = 0; t < L; ++t) {
    const int xn = xb ? xb - 1 : 2;  // (t + 2) % 3
    if (t + 2 < L) tc_stage_rows(xs + xn * kTcRows * xw, xw, xi, C3, b0, B, L, t + 2, H);
    float acc[3][NT][4];
    tc_product<NT>(hb + (size_t)cur * kTcRows * ks, whs, nks, hp, ks, u0, lane, acc);
    const uint32_t* x = xs + xb * kTcRows * xw;
    bf16* nxt = hb + (size_t)(cur ^ 1) * kTcRows * ks;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int uu = u0 + nt * 8 + 2 * q;
      uint32_t hv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gr + 8 * i;
        const bool ok = alive[nt] && b0 + r < B;
        float2 xv[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          xv[g] = ok ? unpack2(x[r * xw + (g * H + uu) / 2]) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const float rr = sigm_fast((j ? xv[0].y : xv[0].x) + (acc[0][nt][e] + bias[0][nt][j]));
          const float z = sigm_fast((j ? xv[1].y : xv[1].x) + (acc[1][nt][e] + bias[1][nt][j]));
          const float n =
              tanh_fast((j ? xv[2].y : xv[2].x) + rr * (acc[2][nt][e] + bias[2][nt][j]));
          h[nt][e] = (1.0f - z) * n + z * h[nt][e];
        }
        hv[i] = pack2(h[nt][2 * i], h[nt][2 * i + 1]);
      }
      // lanes q = 0, 1 hold the tile's eight units of rows gr, gr + 8
      const uint4 v = quad_gather(hv[0], hv[1], lane);
      if (q < 2) {
        const int r = gr + 8 * q;
        *reinterpret_cast<uint4*>(nxt + swz(r, u0 + nt * 8, ks)) = v;
        if (b0 + r < B) store_units8(out + ((size_t)(b0 + r) * L + t) * H, u0 + nt * 8, H, v);
      }
    }
    cp_async_commit_wait_prior();  // xi_{t+1} has landed
    __syncthreads();
    cur ^= 1;
    xb = xb == 2 ? 0 : xb + 1;
  }
}

template <int NT>
__global__ void __launch_bounds__(32 * kMaxH / (8 * NT))
fused_gru_bwd_tc_kernel(const bf16* __restrict__ xi, const float* __restrict__ h0,
                        const float* __restrict__ wh, const float* __restrict__ bh,
                        const bf16* __restrict__ out, const bf16* __restrict__ dout, int B, int L,
                        int H, bf16* __restrict__ dxi, float* __restrict__ dh0,
                        float* __restrict__ dhh, float* __restrict__ dbh_part) {
  static_assert(NT == 2, "dhh wh^T reads a warp's two n8 tiles of wh^T by one ldmatrix.x4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = tc_hp(H), ks = tc_ks(H), nks = hp / 16, xw = tc_xw(H), dw = tc_dw(H);
  const int s3 = cluster_s3(hp), C3 = 3 * H;
  bf16* whs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + tc_wh_bytes(H);
  const size_t sb = tc_stage_bytes(H);
  // staging buffer s: h_{t-1} [16][ks] bf16, then xi_t [16][xw] and dout_t [16][dw] words
  auto hrows = [&](int s) { return reinterpret_cast<bf16*>(stages + s * sb); };
  auto xrows = [&](int s) {
    return reinterpret_cast<uint32_t*>(stages + s * sb + (size_t)2 * kTcRows * ks);
  };
  bf16* dsc = reinterpret_cast<bf16*>(stages + 2 * sb);  // [hi, lo][16][s3]: dhh
  bf16* dxs = dsc + (size_t)2 * kTcRows * s3;              // [16][s3]: dxi
  float* dhs = reinterpret_cast<float*>(dxs + (size_t)kTcRows * s3);  // [16][s3]: dhh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kTcRows, u0 = warp * 8 * NT, nwarps = blockDim.x >> 5;

  // step t's h_{t-1} (round(h0) at t = 0), xi_t and dout_t into buffer t & 1
  auto stage = [&](int t) {
    const int s = t & 1;
    if (t == 0)
      load_h0_rows(hrows(s), h0, b0, B, H, kTcRows, hp, ks);
    else
      tc_stage_h(hrows(s), out, b0, B, L, t - 1, H, ks);
    tc_stage_rows(xrows(s), xw, xi, C3, b0, B, L, t, H);
    tc_stage_rows(xrows(s) + kTcRows * xw, dw, dout, H, b0, B, L, t, H);
  };

  load_wh_slice(whs, wh, H, 0, hp, ks);
  stage(L - 1);
  float dh[NT][4], bias[3][NT][2], dbs[3][NT][2];
  bool alive[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int uu = u0 + nt * 8 + 2 * q;
    alive[nt] = uu < H;
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[nt][e] = 0.0f;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bias[g][nt][j] = alive[nt] ? bh[g * H + uu + j] : 0.0f;
        dbs[g][nt][j] = 0.0f;
      }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    const int s = t & 1;
    if (t > 0) stage(t - 1);  // in flight during this step
    float acc[3][NT][4];
    tc_product<NT>(hrows(s), whs, nks, hp, ks, u0, lane, acc);
    const uint32_t* x = xrows(s);
    const uint32_t* dy = x + kTcRows * xw;
    // gates; dhh into dsc as hi and lo, and with dxi into the rows that leave
    // for device memory; acc[1] keeps z for the dh update
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int uu = u0 + nt * 8 + 2 * q;
      float d[3][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gr + 8 * i, b = b0 + r;
        const bool ok = alive[nt] && b < B;
        float2 xv[3], dyv = make_float2(0.0f, 0.0f), hpv = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          xv[g] = ok ? unpack2(x[r * xw + (g * H + uu) / 2]) : make_float2(0.0f, 0.0f);
        if (ok) {
          dyv = unpack2(dy[r * dw + uu / 2]);
          hpv = t > 0 ? unpack2(*reinterpret_cast<const uint32_t*>(hrows(s) + swz(r, uu, ks)))
                      : *reinterpret_cast<const float2*>(h0 + (size_t)b * H + uu);
        }
        float dn[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const float hr = acc[0][nt][e] + bias[0][nt][j], hz = acc[1][nt][e] + bias[1][nt][j],
                      hn = acc[2][nt][e] + bias[2][nt][j];
          const float rr = sigm_fast((j ? xv[0].y : xv[0].x) + hr);
          const float z = sigm_fast((j ? xv[1].y : xv[1].x) + hz);
          const float n = tanh_fast((j ? xv[2].y : xv[2].x) + rr * hn);
          dh[nt][e] += j ? dyv.y : dyv.x;
          const float dpre_n = dh[nt][e] * (1.0f - z) * (1.0f - n * n);
          d[0][e] = dpre_n * hn * rr * (1.0f - rr);
          d[1][e] = dh[nt][e] * ((j ? hpv.y : hpv.x) - n) * z * (1.0f - z);
          d[2][e] = dpre_n * rr;
          dn[j] = dpre_n;
          acc[1][nt][e] = z;
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float v0 = d[g][2 * i], v1 = d[g][2 * i + 1];
          uint32_t hi, lo;
          split2(v0, v1, hi, lo);
          const size_t o = (size_t)r * s3 + g * hp + uu;
          *reinterpret_cast<uint32_t*>(dsc + o) = hi;
          *reinterpret_cast<uint32_t*>(dsc + (size_t)kTcRows * s3 + o) = lo;
          *reinterpret_cast<uint32_t*>(dxs + o) = g == 2 ? pack2(dn[0], dn[1]) : pack2(v0, v1);
          *reinterpret_cast<float2*>(dhs + o) = make_float2(v0, v1);
          if (ok) {
            dbs[g][nt][0] += v0;
            dbs[g][nt][1] += v1;
          }
        }
      }
    }
    __syncthreads();  // dsc is complete
    // P = (hi + lo) wh^T for the warp's units
    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < 3 * hp; c += 16) {
      uint32_t bw[NT][2];
      ldsm_x4_t(whs + swz(c + (lane & 15), u0 + (lane >> 4) * 8, ks), bw[0][0], bw[0][1],
                bw[1][0], bw[1][1]);
      uint32_t ah[4], al[4];
      const size_t arow = (size_t)(lane & 15) * s3 + c + (lane >> 4) * 8;
      ldsm_x4(dsc + arow, ah[0], ah[1], ah[2], ah[3]);
      ldsm_x4(dsc + (size_t)kTcRows * s3 + arow, al[0], al[1], al[2], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma16816(p[nt], ah, bw[nt][0], bw[nt][1]);
        mma16816(p[nt], al, bw[nt][0], bw[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[nt][e] = dh[nt][e] * acc[1][nt][e] + rnd<true>(p[nt][e]);
    // the step's dxi and dhh rows to device memory, a warp a (row, gate) at a
    // time: H contiguous elements a store (four units a lane)
    for (int it = warp; it < 3 * kTcRows; it += nwarps) {
      const int r = it / 3, g = it - 3 * r, b = b0 + r;
      if (b >= B) continue;
      const size_t row = (size_t)b * L + t, o = (size_t)r * s3 + g * hp;
      for (int c = 4 * lane; c < H; c += 128) {
        *reinterpret_cast<uint2*>(dxi + row * C3 + g * H + c) =
            *reinterpret_cast<const uint2*>(dxs + o + c);
        *reinterpret_cast<float4*>(dhh + row * C3 + g * H + c) =
            *reinterpret_cast<const float4*>(dhs + o + c);
      }
    }
    cp_async_wait_all();  // the next step's staging has landed
    __syncthreads();      // and nobody reads dsc any more
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int uu = u0 + nt * 8 + 2 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = b0 + gr + 8 * i;
      if (alive[nt] && b < B)
        *reinterpret_cast<float2*>(dh0 + (size_t)b * H + uu) =
            make_float2(dh[nt][2 * i], dh[nt][2 * i + 1]);
    }
    // the block's dbh over its rows: the eight lanes of a unit pair, in a fixed tree
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = dbs[g][nt][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gr == 0 && alive[nt]) dbh_part[(size_t)blockIdx.x * C3 + g * H + uu + j] = v;
      }
  }
}

// ------------- 3xTF32 tensor cores in one block (fp32 instance, H <= 128)
//
// The fp32 instance (NARM's GRU, GRU4Rec under compute_dtype float32) in
// route 4's structure, its products fp32-exact on the tensor cores as
// 3xTF32: x = hi + lo with hi = x's top 19 bits (a tf32 value, x cut toward
// 0) and lo = x - hi exact, whose low bits the tensor cores drop; a k-step
// of 8 is a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, about 2^-20 of the
// product, is dropped), three mma.sync.m16n8k8 into one accumulator, the
// small terms first (trm_layer.cu's 3xTF32 products, whose split this file
// copies). The carry h (dh) and the gate math stay fp32, the gates from the
// hardware exp2 and reciprocal (sigm_fast, tanh_fast).
//
// A block owns kRows = 16 sequences for the whole loop and holds all of wh
// in fp32, once, in shared memory: whs[3 Hp][Ks] (row g Hp + u holds
// wh[k][g H + u] over k; Hp = H rounded up to 16, Ks = Hp rounded up to 32),
// 196,608 bytes at H 128. Pre-split hi and lo copies would take twice that,
// more than a block's 232,448, so each operand is split as it is loaded (two
// ALU operations an element). Rows of whs and of the h rows are XOR-swizzled
// by 16-byte chunk (tf_swz), so that the three ways they are read are free of
// bank conflicts: the forward product reads a lane's B fragments of two
// k-steps as one 16-byte load (the k of a k-step permuted, which a sum does
// not see: lane q takes k 4q .. 4q + 3 of a 16-wide slab, the first k-step
// 4q, 4q + 1 and the second 4q + 2, 4q + 3), and the h rows' A fragments the
// same way; the backward's dhh wh^T reads wh along its other index, which
// ldmatrix cannot transpose for 32-bit elements, as scalar loads (lane (gr,
// q) at rows c0 + 2q, c0 + 2q + 1, column n0 + gr). Units past H are dead:
// zero wh, bh, xi and h0, so their h and dh stay exactly 0.
//
// Forward: warp w owns units 8w + [0, 8) in all three gates (Hp / 8 warps, 16
// at H 128), so a thread holds r, z and n of its (row, unit) pairs and the
// gates and the fp32 carry stay in registers. Each step the new h slice goes
// into the other of two fp32 h buffers, then one __syncthreads. No room is
// left to stage xi in shared memory (a step's rows are 24,576 bytes), so
// each thread loads its own twelve xi values of step t + 1 into registers at
// the start of step t, where the product hides their latency; out leaves as
// 8-byte stores from the registers (a quad of lanes writes one 32-byte
// sector of a row).
//
// Backward: warp w owns units 16w + [0, 16) (8 warps at H 128, route 4's
// measured choice). The recompute is the forward's product on h_{t-1},
// whose rows lie in one fp32 buffer; xi_t and dout_t come into registers a
// step ahead as in the forward. The gates write the step's dhh rows (fp32,
// stride 8 mod 32 floats) into shared memory and store dxi and dhh to device
// memory from registers; after the first barrier the next step's h_{t-2} rows
// are copied into the h buffer by cp.async (its readers are done) while dhh
// wh^T (M 16, N Hp, K 3 Hp) runs from the dhh rows and whs, dhh split as it
// is loaded; then dh = dh z + dhh wh^T, the copies waited for, and the second
// barrier. The block's dbh partial is summed over its rows in a fixed tree.
// At H 128 a block takes 212,992 bytes forward and 229,888 backward.
//
// dwh is gru_dwh_tf32_kernel (below): [h_{t-1}]^T dhh over chunks of the B L
// rows as 3xTF32, both operands split as loaded, one partial a chunk.
//
// What bounds it at NARM's step (B 2,048, L 50, H 128): the recurrent
// products are 10.07 GFLOP forward and 30.2 backward, 0.061 and 0.183 ms at
// the 3xTF32 rate (a third of dense TF32's 494.7 TFLOP/s); the fp32 bytes
// (xi, out; xi, out, dout, dxi, dhh) 209.7 MB forward, 0.063 ms at 3.35 TB/s.
// But the loop is 50 serial steps of 128 blocks, one an SM, so what a step
// costs is one SM's 2,304 mma (forward; 4,608 backward) with their fragment
// loads and splits, the gates and the barrier. scripts/torch_gru_probe.py
// --fp32 reads a step's clocks by phase (H100, block 0): forward 7,878 the
// product, 773 the gates and stores, 2 at the barrier; backward 10,230 the
// recompute, 2,636 the gates, 860 issuing the copies, 9,648 dhh wh^T and the
// dh update, 47 at the barriers. Measured choices (scripts/torch_gru_ab.py
// --rows 8b on copies of this source that differ in one choice, each set in
// one call; graph ms forward, the recurrent backward kernel in brackets):
// fast gates 0.251 (0.645) against expf / tanhf 0.270 (0.687), the error
// the same (1.8e-6 against 1.7e-6 of out's largest value); the forward at
// 16 warps 0.251 against 0.260 at 8; the backward at 8 warps (0.645)
// against (0.659) at 16; h kept split (hi and lo rows written by the gates,
// 229,376 bytes) 0.293, the forward's 128 registers spilling; the product's
// depth fixed at H 128 (fully unrolled) 0.288, spilling; dhh wh^T with one
// accumulator a term (0.648) and unrolled 8 deep (0.668): no gain.

// n8 tiles a gate a warp (8 NT units a warp): the forward 1 (16 warps at H
// 128), the backward 2 (8 warps)
constexpr int kTfFwdNT = 1, kTfBwdNT = 2;
constexpr int kTfMaxKb = kMaxH / 16;  // 16-wide k slabs of the recurrent product at most

__host__ __device__ inline int tf_hp(int H) { return round_up(H, 16); }
__host__ __device__ inline int tf_ks(int H) { return round_up(tf_hp(H), 32); }
// the backward's dhh row stride: 8 mod 32 floats, so that a quad's 8-byte
// reads and writes of four rows hit distinct banks
__host__ __device__ inline int tf_sd(int H) { return round_up(3 * tf_hp(H), 32) + 8; }
inline int tf_threads(int H, int nt) { return 32 * tf_hp(H) / (8 * nt); }

inline size_t tf_smem(int H, bool backward) {
  const size_t wh = (size_t)4 * 3 * tf_hp(H) * tf_ks(H), rows = (size_t)4 * kRows * tf_ks(H);
  return wh + (backward ? rows + (size_t)4 * kRows * tf_sd(H) : 2 * rows);
}

// Element (row, k) of an fp32 tile whose rows hold ks floats (a multiple of
// 32): the 16-byte chunks of a row are XOR-swizzled by (row & 6) ^ ((row & 1)
// << 2). Rows 2p and 2p + 1 then differ in bit 2 of the swizzle (a lane's
// 16-byte fragment loads, eight lanes a phase), and rows c, c + 2, c + 4,
// c + 6 (c even), as c + 1, c + 3, c + 5, c + 7, in bits 1 and 2 (the scalar
// reads of dhh wh^T).
__device__ __forceinline__ int tf_swz(int row, int k, int ks) {
  const int f = (row & 6) ^ ((row & 1) << 2);
  return row * ks + (((k >> 2) ^ f) << 2) + (k & 3);
}

// x = hi + lo for 3xTF32: hi is x's top 19 bits (|x - hi| < 2^-10 |x|), lo
// the exact remainder, whose low bits the tensor cores drop (< 2^-20 |x|);
// a copy of trm_layer.cu's split_tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: one m16n8k8 tile, tf32 operands, fp32 sums
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as 3xTF32, the small terms first; b = (b0, b1) split into bh, bl
__device__ __forceinline__ void mma_3x(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                       const uint32_t bh[2], const uint32_t bl[2]) {
  mma1688(c, al, bh[0], bh[1]);
  mma1688(c, ah, bl[0], bl[1]);
  mma1688(c, ah, bh[0], bh[1]);
}

// the four A elements of a k-step (rows gr, gr + 8 by slots q, q + 4) split
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t ah[4],
                                        uint32_t al[4]) {
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
}

// whs[3 hp][ks] <- wh's gate columns, zero past H (an item: rows k .. k + 3
// of one column, read down the column, neighbouring threads on neighbouring
// columns; H is a multiple of 4, so the four rows are all live or all dead)
__device__ void tf_load_wh(float* whs, const float* __restrict__ wh, int H, int hp, int ks) {
  const int n3 = 3 * hp, items = n3 * (hp / 4);
  for (int i0 = threadIdx.x; i0 < items; i0 += kStage * blockDim.x) {
    float4 v[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * blockDim.x, n = i % n3, k = 4 * (i / n3), g = n / hp, u = n - g * hp;
      v[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < items && u < H && k < H) {
        const float* src = wh + (size_t)k * 3 * H + g * H + u;
        v[s] = make_float4(src[0], src[3 * H], src[6 * H], src[9 * H]);
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * blockDim.x, n = i % n3, k = 4 * (i / n3);
      if (i < items) *reinterpret_cast<float4*>(whs + tf_swz(n, k, ks)) = v[s];
    }
  }
}

// hs[16][ks] <- h_{t-1} of the block's rows (the forward's output at t - 1,
// h0 at t = 0) by cp.async, zero past B and past H (hp columns)
__device__ __forceinline__ void tf_stage_h(float* hs, const float* __restrict__ h0,
                                           const float* __restrict__ out, int b0, int B, int L,
                                           int t, int H, int hp, int ks) {
  const int k4 = hp / 4;
  for (int i = threadIdx.x; i < kRows * k4; i += blockDim.x) {
    const int r = i / k4, k = 4 * (i - r * k4), b = b0 + r;
    float* d = hs + tf_swz(r, k, ks);
    if (b >= B || k >= H)
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    else
      cp_async16(d, t == 0 ? h0 + (size_t)b * H + k : out + ((size_t)b * L + t - 1) * H + k);
  }
}

// acc[g][nt] = the 16 rows of hs (fp32) times the warp's unit tile nt (units
// u0 + 8 nt + [0, 8)) of gate g, 3xTF32: per 16-wide k slab a lane loads k
// 4q .. 4q + 3 of rows gr and gr + 8 and of its B column, two k-steps
template <int NT>
__device__ __forceinline__ void tf_product(const float* hs, const float* whs, int hp, int ks,
                                           int u0, int lane, float acc[3][NT][4]) {
  const int gr = lane >> 2, q = lane & 3, nkb = hp / 16;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][nt][e] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < kTfMaxKb; ++kb) {
    if (kb < nkb) {
      const int k = kb * 16 + 4 * q;
      const float4 x0 = *reinterpret_cast<const float4*>(hs + tf_swz(gr, k, ks));
      const float4 x1 = *reinterpret_cast<const float4*>(hs + tf_swz(gr + 8, k, ks));
      uint32_t ah[2][4], al[2][4];
      split_a(x0.x, x1.x, x0.y, x1.y, ah[0], al[0]);
      split_a(x0.z, x1.z, x0.w, x1.w, ah[1], al[1]);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 w =
              *reinterpret_cast<const float4*>(whs + tf_swz(g * hp + u0 + nt * 8 + gr, k, ks));
          uint32_t bh[2][2], bl[2][2];
          split_tf32(w.x, bh[0][0], bl[0][0]);
          split_tf32(w.y, bh[0][1], bl[0][1]);
          split_tf32(w.z, bh[1][0], bl[1][0]);
          split_tf32(w.w, bh[1][1], bl[1][1]);
          mma_3x(acc[g][nt], ah[0], al[0], bh[0], bl[0]);
          mma_3x(acc[g][nt], ah[1], al[1], bh[1], bl[1]);
        }
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxH / (8 * kTfFwdNT))
fused_gru_fwd_tf32_kernel(const float* __restrict__ xi, const float* __restrict__ h0,
                          const float* __restrict__ wh, const float* __restrict__ bh, int B,
                          int L, int H, float* __restrict__ out) {
  constexpr int NT = kTfFwdNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = tf_hp(H), ks = tf_ks(H), C3 = 3 * H;
  float* whs = reinterpret_cast<float*>(smem_raw);
  float* hb = whs + (size_t)3 * hp * ks;  // [2][16][ks]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kRows, u0 = warp * 8 * NT;
  // the thread's (row, unit) pairs: rows gr + 8 i (i = 0, 1) by units
  // uu[nt], uu[nt] + 1, in accumulator order e = 2 i + j
  int uu[NT];
  bool ok[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uu[nt] = u0 + nt * 8 + 2 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i) ok[nt][i] = uu[nt] < H && b0 + gr + 8 * i < B;
  }

  tf_load_wh(whs, wh, H, hp, ks);
  for (int i = threadIdx.x; i < kRows * (hp / 4); i += blockDim.x) {
    const int r = i / (hp / 4), k = 4 * (i - r * (hp / 4)), b = b0 + r;
    *reinterpret_cast<float4*>(hb + tf_swz(r, k, ks)) =
        b < B && k < H ? *reinterpret_cast<const float4*>(h0 + (size_t)b * H + k)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float h[NT][4], bias[3][NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[nt][e] = ok[nt][e >> 1] ? h0[(size_t)(b0 + gr + 8 * (e >> 1)) * H + uu[nt] + (e & 1)]
                                : 0.0f;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) bias[g][nt][j] = uu[nt] < H ? bh[g * H + uu[nt] + j] : 0.0f;
  }
  // xi_t of the thread's pairs, [nt][i][g]: loaded a step ahead into registers
  float2 xc[NT][2][3], xn[NT][2][3];
  auto load_x = [&](int t, float2 x[NT][2][3]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[nt][i][g] = ok[nt][i] ? *reinterpret_cast<const float2*>(
                                        xi + ((size_t)(b0 + gr + 8 * i) * L + t) * C3 + g * H +
                                        uu[nt])
                                  : make_float2(0.0f, 0.0f);
  };
  load_x(0, xc);
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < L; ++t) {
    if (t + 1 < L) load_x(t + 1, xn);
    float acc[3][NT][4];
    tf_product<NT>(hb + (size_t)cur * kRows * ks, whs, hp, ks, u0, lane, acc);
    float* nxt = hb + (size_t)(cur ^ 1) * kRows * ks;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const float2* x = xc[nt][i];
          const float rr = sigm_fast((j ? x[0].y : x[0].x) + (acc[0][nt][e] + bias[0][nt][j]));
          const float z = sigm_fast((j ? x[1].y : x[1].x) + (acc[1][nt][e] + bias[1][nt][j]));
          const float n = tanh_fast((j ? x[2].y : x[2].x) + rr * (acc[2][nt][e] + bias[2][nt][j]));
          h[nt][e] = (1.0f - z) * n + z * h[nt][e];
        }
        const int r = gr + 8 * i;
        const float2 v = make_float2(h[nt][2 * i], h[nt][2 * i + 1]);
        *reinterpret_cast<float2*>(nxt + tf_swz(r, uu[nt], ks)) = v;
        if (ok[nt][i])
          *reinterpret_cast<float2*>(out + ((size_t)(b0 + r) * L + t) * H + uu[nt]) = v;
      }
    __syncthreads();
    cur ^= 1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) xc[nt][i][g] = xn[nt][i][g];
  }
}

__global__ void __launch_bounds__(32 * kMaxH / (8 * kTfBwdNT))
fused_gru_bwd_tf32_kernel(const float* __restrict__ xi, const float* __restrict__ h0,
                          const float* __restrict__ wh, const float* __restrict__ bh,
                          const float* __restrict__ out, const float* __restrict__ dout, int B,
                          int L, int H, float* __restrict__ dxi, float* __restrict__ dh0,
                          float* __restrict__ dhh, float* __restrict__ dbh_part) {
  constexpr int NT = kTfBwdNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = tf_hp(H), ks = tf_ks(H), sd = tf_sd(H), C3 = 3 * H;
  float* whs = reinterpret_cast<float*>(smem_raw);
  float* hs = whs + (size_t)3 * hp * ks;  // [16][ks]: h_{t-1}
  float* ds = hs + (size_t)kRows * ks;    // [16][sd]: this step's dhh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kRows, u0 = warp * 8 * NT;
  int uu[NT];
  bool ok[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uu[nt] = u0 + nt * 8 + 2 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i) ok[nt][i] = uu[nt] < H && b0 + gr + 8 * i < B;
  }
  // xi_t [nt][i][g] and dout_t [nt][i] of the thread's pairs, a step ahead
  float2 xc[NT][2][3], xn[NT][2][3], yc[NT][2], yn[NT][2];
  auto load_xy = [&](int t, float2 x[NT][2][3], float2 y[NT][2]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t row = (size_t)(b0 + gr + 8 * i) * L + t;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[nt][i][g] = ok[nt][i]
                            ? *reinterpret_cast<const float2*>(xi + row * C3 + g * H + uu[nt])
                            : make_float2(0.0f, 0.0f);
        y[nt][i] = ok[nt][i] ? *reinterpret_cast<const float2*>(dout + row * H + uu[nt])
                             : make_float2(0.0f, 0.0f);
      }
  };

  tf_load_wh(whs, wh, H, hp, ks);
  tf_stage_h(hs, h0, out, b0, B, L, L - 1, H, hp, ks);
  load_xy(L - 1, xc, yc);
  float dh[NT][4], bias[3][NT][2], dbs[3][NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[nt][e] = 0.0f;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bias[g][nt][j] = uu[nt] < H ? bh[g * H + uu[nt] + j] : 0.0f;
        dbs[g][nt][j] = 0.0f;
      }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    if (t > 0) load_xy(t - 1, xn, yn);
    float acc[3][NT][4];
    tf_product<NT>(hs, whs, hp, ks, u0, lane, acc);
    // gates; dhh into ds and, with dxi, to device memory; acc[1] keeps z
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gr + 8 * i;
        const float2 hpv = *reinterpret_cast<const float2*>(hs + tf_swz(r, uu[nt], ks));
        float d[3][2], dn[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const float hr = acc[0][nt][e] + bias[0][nt][j], hz = acc[1][nt][e] + bias[1][nt][j],
                      hn = acc[2][nt][e] + bias[2][nt][j];
          const float rr = sigm_fast((j ? xc[nt][i][0].y : xc[nt][i][0].x) + hr);
          const float z = sigm_fast((j ? xc[nt][i][1].y : xc[nt][i][1].x) + hz);
          const float n = tanh_fast((j ? xc[nt][i][2].y : xc[nt][i][2].x) + rr * hn);
          dh[nt][e] += j ? yc[nt][i].y : yc[nt][i].x;
          const float dpre_n = dh[nt][e] * (1.0f - z) * (1.0f - n * n);
          d[0][j] = dpre_n * hn * rr * (1.0f - rr);
          d[1][j] = dh[nt][e] * ((j ? hpv.y : hpv.x) - n) * z * (1.0f - z);
          d[2][j] = dpre_n * rr;
          dn[j] = dpre_n;
          acc[1][nt][e] = z;
        }
        const size_t row = (size_t)(b0 + r) * L + t;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float2 v = make_float2(d[g][0], d[g][1]);
          *reinterpret_cast<float2*>(ds + (size_t)r * sd + g * hp + uu[nt]) = v;
          if (ok[nt][i]) {
            *reinterpret_cast<float2*>(dxi + row * C3 + g * H + uu[nt]) =
                g == 2 ? make_float2(dn[0], dn[1]) : v;
            *reinterpret_cast<float2*>(dhh + row * C3 + g * H + uu[nt]) = v;
            dbs[g][nt][0] += v.x;
            dbs[g][nt][1] += v.y;
          }
        }
      }
    __syncthreads();  // ds is complete, and nobody reads hs any more this step
    if (t > 0) tf_stage_h(hs, h0, out, b0, B, L, t - 1, H, hp, ks);
    // P = dhh wh^T for the warp's units: k-step slots q, q + 4 are the dhh
    // columns c0 + 2q, c0 + 2q + 1
    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.0f;
#pragma unroll 4
    for (int c0 = 0; c0 < 3 * hp; c0 += 8) {
      const int c = c0 + 2 * q;
      const float2 a0 = *reinterpret_cast<const float2*>(ds + (size_t)gr * sd + c);
      const float2 a1 = *reinterpret_cast<const float2*>(ds + (size_t)(gr + 8) * sd + c);
      uint32_t ah[4], al[4];
      split_a(a0.x, a1.x, a0.y, a1.y, ah, al);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = u0 + nt * 8 + gr;
        uint32_t bhi[2], blo[2];
        split_tf32(whs[tf_swz(c, n, ks)], bhi[0], blo[0]);
        split_tf32(whs[tf_swz(c + 1, n, ks)], bhi[1], blo[1]);
        mma_3x(p[nt], ah, al, bhi, blo);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[nt][e] = dh[nt][e] * acc[1][nt][e] + p[nt][e];
    cp_async_wait_all();  // the next step's h_{t-2} rows have landed
    __syncthreads();      // and nobody reads ds any more
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        yc[nt][i] = yn[nt][i];
#pragma unroll
        for (int g = 0; g < 3; ++g) xc[nt][i][g] = xn[nt][i][g];
      }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (ok[nt][i])
        *reinterpret_cast<float2*>(dh0 + (size_t)(b0 + gr + 8 * i) * H + uu[nt]) =
            make_float2(dh[nt][2 * i], dh[nt][2 * i + 1]);
    // the block's dbh over its rows: the eight lanes of a unit pair, in a fixed tree
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = dbs[g][nt][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gr == 0 && uu[nt] < H) dbh_part[(size_t)blockIdx.x * C3 + g * H + uu[nt] + j] = v;
      }
  }
}

// partial[chunk] = sum over the chunk's rows n = (b, t) of h_{t-1}[b]^T dhh[n]
// ((H, 3H)) as 3xTF32, the fp32 instance's dwh at every H. Grid (3H / 128,
// H / 128, chunks), 8 warps, a block tile 128 (k) x 128 (c), a warp 64 x 32
// (4 x 4 m16n8 tiles); each pass of 32 rows is copied by cp.async into one
// of two buffers (rows 8 mod 32 floats long, so the fragments' scalar reads,
// four rows by eight columns, hit 32 banks) while the other is multiplied,
// both operands split as they are loaded. A pass's products are summed by
// the tensor cores from zero and then added to the chunk's sum by ordinary
// fp32 adds: the tensor cores' own fp32 accumulation drifts down a long
// chain (summing a whole chunk in the mma accumulators gave 1.0e-4 of dwh's
// largest value at H 388, 25,600 rows a chunk, where the fp32 library
// product gives 1.6e-6 and this kernel 9.0e-7). The sum doubles the
// accumulator registers, so one block an SM; a warp tile of 32 x 32 at two
// blocks an SM (kTfDwhMT 2) took the same time at NARM's step (H100: 0.189,
// 0.191 against 0.193, 0.188 ms; dwh 0.166 ms before the sum).
constexpr int kTfDwhMT = 4;  // m16 tiles a warp along k
// tile rows (k) and columns (c), rows a pass
constexpr int kTfDM = 32 * kTfDwhMT, kTfDN = 128, kTfDR = 32;
// a staged row's floats, 8 mod 32
constexpr int kTfSA = kTfDM + 8, kTfSB = kTfDN + 8;

inline size_t tf_dwh_smem() { return sizeof(float) * 2 * kTfDR * (kTfSA + kTfSB); }

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(256, 4 / kTfDwhMT)
gru_dwh_tf32_kernel(const float* __restrict__ out, const float* __restrict__ h0,
                    const float* __restrict__ dhh, int B, int L, int H, int chunk_rows,
                    float* __restrict__ partials) {
  constexpr int MT = kTfDwhMT, BUF = kTfDR * (kTfSA + kTfSB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [buffer]: the h rows [kTfDR][kTfSA], then the dhh rows [kTfDR][kTfSB]
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int C = 3 * H, N = B * L;
  const int c0 = blockIdx.x * kTfDN, k0 = blockIdx.y * kTfDM;
  const int n_begin = blockIdx.z * chunk_rows, n_end = min(N, n_begin + chunk_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int wm = (warp >> 2) * 16 * MT, wn = (warp & 3) * 32;  // the warp's k and c offsets
  float sum[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j][0] = sum[i][j][1] = sum[i][j][2] = sum[i][j][3] = 0.0f;
  // rows n0 .. n0 + 31 of h_{t-1} (columns k0 ..) and dhh (columns c0 ..)
  // into buffer buf, zero past the chunk, H and 3H, in 16-byte pieces
  auto issue = [&](int n0, int buf) {
    float* As = sm + (size_t)buf * BUF;
    float* Bs = As + kTfDR * kTfSA;
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      const int i = threadIdx.x + s * 256, rr = i / (kTfDM / 4), cc = 4 * (i % (kTfDM / 4));
      const int n = n0 + rr, k = k0 + cc;
      const float* src = h0;
      const bool hv = n < n_end && k < H;
      if (hv) {
        const int b = n / L, t = n - b * L;
        src = t == 0 ? h0 + (size_t)b * H + k : out + ((size_t)n - 1) * H + k;
      }
      cp_async16_zfill(As + rr * kTfSA + cc, src, hv);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = threadIdx.x + s * 256, rr = i >> 5, cc = 4 * (i & 31), n = n0 + rr;
      const int c = c0 + cc;
      const bool dv = n < n_end && c < C;
      cp_async16_zfill(Bs + rr * kTfSB + cc, dv ? dhh + (size_t)n * C + c : dhh, dv);
    }
  };
  if (n_begin < n_end) issue(n_begin, 0);
  cp_async_commit();
  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += kTfDR) {
    if (n0 + kTfDR < n_end) issue(n0 + kTfDR, buf ^ 1);
    cp_async_commit_wait_prior();  // this pass's rows have landed
    __syncthreads();
    const float* As = sm + (size_t)buf * BUF;
    const float* Bs = As + kTfDR * kTfSA;
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kTfDR; kk += 8) {
      // A = h^T (k x n) from As[n][k], B = dhh (n x c) from Bs[n][c]: slot q
      // is row kk + q, slot q + 4 row kk + q + 4
      const float* aq = As + (kk + q) * kTfSA + wm + gr;  // slot q
      const float* aq4 = aq + 4 * kTfSA;                  // slot q + 4
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + gr;
        split_tf32(Bs[(kk + q) * kTfSB + col], bhi[nt][0], blo[nt][0]);
        split_tf32(Bs[(kk + q + 4) * kTfSB + col], bhi[nt][1], blo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ah[4], al[4];
        split_a(aq[mt * 16], aq[mt * 16 + 8], aq4[mt * 16], aq4[mt * 16 + 8], ah, al);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_3x(acc[mt][nt], ah, al, bhi[nt], blo[nt]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
    __syncthreads();
    buf ^= 1;
  }
  float* part = partials + (size_t)blockIdx.z * H * C;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + wm + mt * 16 + gr + 8 * i, cl = c0 + wn + nt * 8 + 2 * q;
        if (k < H && cl < C)
          *reinterpret_cast<float2*>(part + (size_t)k * C + cl) =
              make_float2(sum[mt][nt][2 * i], sum[mt][nt][2 * i + 1]);
      }
}

// ------------------------------------------------------------------- launch

// The route of a call, chosen from H and the instance before launch: H <=
// kMaxH wh in one block's shared memory on the tensor cores, bf16
// (fused_gru_{fwd,bwd}_tc_kernel) or fp32 as 3xTF32
// (fused_gru_{fwd,bwd}_tf32_kernel); wh split over a thread-block cluster
// (bf16 instance, kMaxH < H <= cluster_max_hidden()); or wh in device memory
// (the *_global kernels: fp32 above kMaxH, bf16 above the cluster limit).
// Route 3 of fused_gru_route is the global route with its rows in device
// memory; 0 was the fp32 FMA kernels that route 5 replaced.
enum Route { kRouteCluster = 1, kRouteGlobal = 2, kRouteTc = 4, kRouteTf32 = 5 };

// shared-memory floats of the global-memory instance at R sequences a block
inline size_t smem_floats_global(int H, bool backward, int R) {
  return backward ? (size_t)(5 * R + 3) * H : (size_t)3 * R * H;
}

// The global route's sequences a block, a template parameter of its kernels:
// the largest of 16, 8, 4, 2, 1 whose shared memory fits a block at H (0:
// none fits, and a block owns one sequence whose rows lie in device memory).
// The backward's (5 R + 3) H floats bound it: R 16 up to H 700, R 8 up to
// 1,348, R 1 up to 7,264; the forward's 3 R H floats up to 19,368.
constexpr int kGlobalRows[5] = {16, 8, 4, 2, 1};

inline int global_rows(int H, bool backward) {
  for (int R : kGlobalRows)
    if (sizeof(float) * smem_floats_global(H, backward, R) <= kSmemOptin) return R;
  return 0;
}

// the largest H whose backward rows fit a block's shared memory at one
// sequence a block (a multiple of 4); above it they lie in device memory
inline int max_hidden() {
  return (int)(kSmemOptin / (sizeof(float) * (5 + 3))) / 4 * 4;
}

// Cluster sizes, smallest first: 2 would hold H <= 2 kClusterMaxUp = 128,
// which the shared route takes. Rows a block: 16 MT, MT <= cluster_max_mt.
constexpr int kClusterSizes[2] = {4, 8};
inline int cluster_max_mt(int cs) { return cs == 4 ? 5 : 2; }

// the smallest cluster size whose layout fits H (the backward at 16 rows), else 0
inline int cluster_size(int H) {
  for (int cs : kClusterSizes)
    if (cluster_up(H, cs) <= kClusterMaxUp && cluster_smem(H, cs, 1, true) <= kSmemOptin)
      return cs;
  return 0;
}

inline int cluster_max_hidden() {
  static const int most = [] {
    int m = 0;
    for (int H = kMaxH + 4; H <= max_hidden(); H += 4)
      if (cluster_size(H)) m = H;
    return m;
  }();
  return most;
}

inline Route route_of(int H, bool bf16) {
  if (H <= kMaxH) return bf16 ? kRouteTc : kRouteTf32;
  return bf16 && H <= cluster_max_hidden() ? kRouteCluster : kRouteGlobal;
}

// floats of the device-memory rows a call needs: B blocks of 3 H (forward)
// or 8 H (backward) when the global route's rows do not fit a block, else 0
inline long long rows_floats(int B, int H, bool backward, bool bf16) {
  if (route_of(H, bf16) != kRouteGlobal || global_rows(H, backward)) return 0;
  return (long long)B * (backward ? 8 : 3) * H;
}

// the most bytes a block of the route takes (the cluster route: its most rows)
inline size_t smem_bytes(int H, bool backward, bool bf16) {
  switch (route_of(H, bf16)) {
    case kRouteTc: return tc_smem(H, backward);
    case kRouteTf32: return tf_smem(H, backward);
    case kRouteGlobal: {  // 0 when the rows lie in device memory
      const int R = global_rows(H, backward);
      return R ? sizeof(float) * smem_floats_global(H, backward, R) : 0;
    }
    default: break;
  }
  const int cs = cluster_size(H);
  size_t most = 0;
  for (int mt = 1; mt <= cluster_max_mt(cs); ++mt)
    if (cluster_smem(H, cs, mt, backward) <= kSmemOptin) most = cluster_smem(H, cs, mt, backward);
  return most;
}

int valid_shape(int B, int L, int H) { return B >= 1 && L >= 1 && H >= 4 && H % 4 == 0; }

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

int blocks_of(int B) { return (B + kRows - 1) / kRows; }
int global_blocks(int B, int R) { return (B + R - 1) / R; }

// one global-route kernel at R sequences a block; rows_gm (R = 1 only): the
// block's rows in device memory, no shared memory
template <bool BF, typename XT, int R>
int fwd_global(const XT* xi, const float* h0, const float* wr, const float* bh, int B, int L,
               int H, float* rows_gm, XT* out, cudaStream_t s) {
  const size_t smem = rows_gm ? 0 : sizeof(float) * smem_floats_global(H, false, R);
  const int err = allow_smem(fused_gru_fwd_global_kernel<BF, XT, R>, smem);
  if (err) return err;
  fused_gru_fwd_global_kernel<BF, XT, R><<<global_blocks(B, R), kThreads, smem, s>>>(
      xi, h0, wr, bh, B, L, H, rows_gm, out);
  return (int)cudaGetLastError();
}

template <bool BF, typename XT, int R>
int bwd_global(const XT* xi, const float* h0, const float* wr, const float* wt, const float* bh,
               const XT* out, const XT* dout, int B, int L, int H, float* rows_gm, XT* dxi,
               float* dh0, float* dhh, float* dbh_part, cudaStream_t s) {
  const size_t smem = rows_gm ? 0 : sizeof(float) * smem_floats_global(H, true, R);
  const int err = allow_smem(fused_gru_bwd_global_kernel<BF, XT, R>, smem);
  if (err) return err;
  fused_gru_bwd_global_kernel<BF, XT, R><<<global_blocks(B, R), kThreads, smem, s>>>(
      xi, h0, wr, wt, bh, out, dout, B, L, H, rows_gm, dxi, dh0, dhh, dbh_part);
  return (int)cudaGetLastError();
}

// dwh's chunks of the B L rows: a wave of gru_dwh_tc_kernel (bf16: 4 / KW
// blocks an SM) or of gru_dwh_tf32_kernel (fp32: 4 / kTfDwhMT)
constexpr int kDwhWave = 132;

int dwh_chunks(int B, int L, int H, bool bf16) {
  const int bm = bf16 ? 64 * dwh_tc_kw(H) : kTfDM, bn = bf16 ? kDT : kTfDN;
  const int tiles = ((3 * H + bn - 1) / bn) * ((H + bm - 1) / bm);
  const int most = (B * L + kDN - 1) / kDN;
  const int blocks = kDwhWave * 4 / (bf16 ? dwh_tc_kw(H) : kTfDwhMT);
  const int want = (blocks + tiles - 1) / tiles;
  return want < most ? want : most;
}

int chunk_rows(int B, int L, int H, bool bf16) {
  const int n = dwh_chunks(B, L, H, bf16), N = B * L;
  const int rows = (N + n - 1) / n;
  return (rows + kDN - 1) / kDN * kDN;
}

// wr and wt in scratch (global-memory instance)
template <bool BF>
int prep_wh(const float* wh, int H, float* scratch, cudaStream_t s) {
  if (!scratch) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)H * 3 * H;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  gru_prep_wh_kernel<BF><<<blocks, 256, 0, s>>>(wh, H, scratch, scratch + n);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- cluster launches

typedef void (*FwdClusterK)(const bf16*, const float*, const float*, const float*, int, int, int,
                            bf16*);
typedef void (*BwdClusterK)(const bf16*, const float*, const float*, const float*, const bf16*,
                            const bf16*, int, int, int, bf16*, float*, float*, float*);
typedef void (*FloorK)(int, int, float*);

template <template <int, int> class Pick>
typename Pick<4, 1>::type pick_kernel(int cs, int mt) {
  if (cs == 4) switch (mt) {
      case 1: return Pick<4, 1>::get();
      case 2: return Pick<4, 2>::get();
      case 3: return Pick<4, 3>::get();
      case 4: return Pick<4, 4>::get();
      case 5: return Pick<4, 5>::get();
    }
  if (cs == 8) switch (mt) {
      case 1: return Pick<8, 1>::get();
      case 2: return Pick<8, 2>::get();
    }
  return nullptr;
}
template <int CS, int MT>
struct PickFwd {
  typedef FwdClusterK type;
  static type get() { return fused_gru_fwd_cluster_kernel<CS, MT>; }
};
template <int CS, int MT>
struct PickBwd {
  typedef BwdClusterK type;
  static type get() { return fused_gru_bwd_cluster_kernel<CS, MT>; }
};
template <int CS, int MT>
struct PickFloor {
  typedef FloorK type;
  static type get() { return gru_cluster_floor_kernel<CS, MT, false>; }
};
template <int CS, int MT>
struct PickFloorProduct {
  typedef FloorK type;
  static type get() { return gru_cluster_floor_kernel<CS, MT, true>; }
};

cudaLaunchConfig_t cluster_config(int cs, int clusters, int threads, size_t smem,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of a kernel the current device holds at once, its
// shared-memory limit raised first. It depends on the device, the kernel and
// the bytes alone, so each is asked once and kept; the limit only rises.
struct ClusterFit {
  int dev;
  const void* kernel;
  size_t smem;
  int err, resident;
};

ClusterFit cluster_fit(const void* kernel, int cs, int threads, size_t smem) {
  static std::mutex mu;
  static std::vector<ClusterFit> seen;
  ClusterFit f = {0, kernel, smem, 0, 0};
  f.err = (int)cudaGetDevice(&f.dev);
  if (f.err) return f;
  std::lock_guard<std::mutex> hold(mu);
  size_t most = 48 * 1024;
  for (const ClusterFit& o : seen)
    if (o.dev == f.dev && o.kernel == kernel) {
      if (o.smem == smem) return o;
      most = std::max(most, o.smem);
    }
  if (smem > most)
    f.err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (!f.err) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cs, 1, threads, smem, 0, &attr);
    f.err = (int)cudaOccupancyMaxActiveClusters(&f.resident, kernel, &cfg);
  }
  if (!f.err) seen.push_back(f);
  return f;
}

// The cluster geometry of a call: cluster size cs (from H), rows a block
// 16 mt and the clusters of the grid. mt is the smallest whose grid is one
// wave of resident clusters, else the largest that fits (the fewest waves).
struct ClusterPlan {
  int err, cs, mt, clusters, resident, threads;
  size_t smem;
};

ClusterPlan cluster_plan(int B, int H, bool backward) {
  ClusterPlan p = {0, cluster_size(H), 0, 0, 0, 0, 0};
  if (!p.cs) {
    p.err = (int)cudaErrorInvalidValue;
    return p;
  }
  p.threads = 4 * cluster_up(H, p.cs);
  for (int mt = 1; mt <= cluster_max_mt(p.cs); ++mt) {
    const size_t smem = cluster_smem(H, p.cs, mt, backward);
    if (smem > kSmemOptin) break;
    const void* k = backward ? (const void*)pick_kernel<PickBwd>(p.cs, mt)
                             : (const void*)pick_kernel<PickFwd>(p.cs, mt);
    const ClusterFit f = cluster_fit(k, p.cs, p.threads, smem);
    if (f.err) {
      p.err = f.err;
      return p;
    }
    if (f.resident < 1) continue;
    p.mt = mt;
    p.clusters = (B + 16 * mt - 1) / (16 * mt);
    p.resident = f.resident;
    p.smem = smem;
    if (p.clusters <= f.resident) break;
  }
  if (!p.mt) p.err = (int)cudaErrorInvalidConfiguration;  // no cluster can be resident
  return p;
}

template <typename K, typename... Args>
int launch_cluster(K kernel, const ClusterPlan& p, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(p.cs, p.clusters, p.threads, p.smem, s, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? (int)err : (int)cudaGetLastError();
}

// ------------------------------------------------------- call launches

template <bool BF, typename XT>
int launch_fwd(const void* xi, const float* h0, const float* wh, const float* bh, int B, int L,
               int H, float* scratch, float* rows, void* out, cudaStream_t s) {
  const Route route = route_of(H, BF);
  const size_t smem = smem_bytes(H, false, BF);
  if (route == kRouteCluster) {
    const ClusterPlan p = cluster_plan(B, H, false);
    if (p.err) return p.err;
    return launch_cluster(pick_kernel<PickFwd>(p.cs, p.mt), p, s, static_cast<const bf16*>(xi),
                          h0, wh, bh, B, L, H, static_cast<bf16*>(out));
  }
  if (route == kRouteGlobal) {
    const int err = prep_wh<BF>(wh, H, scratch, s);
    if (err) return err;
    const XT* x = static_cast<const XT*>(xi);
    XT* o = static_cast<XT*>(out);
    switch (global_rows(H, false)) {
      case 16: return fwd_global<BF, XT, 16>(x, h0, scratch, bh, B, L, H, nullptr, o, s);
      case 8: return fwd_global<BF, XT, 8>(x, h0, scratch, bh, B, L, H, nullptr, o, s);
      case 4: return fwd_global<BF, XT, 4>(x, h0, scratch, bh, B, L, H, nullptr, o, s);
      case 2: return fwd_global<BF, XT, 2>(x, h0, scratch, bh, B, L, H, nullptr, o, s);
      case 1: return fwd_global<BF, XT, 1>(x, h0, scratch, bh, B, L, H, nullptr, o, s);
      case 0:
        if (!rows) return (int)cudaErrorInvalidValue;
        return fwd_global<BF, XT, 1>(x, h0, scratch, bh, B, L, H, rows, o, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (BF) {  // route kRouteTc
    auto kernel = fused_gru_fwd_tc_kernel<kTcFwdNT>;
    const int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<blocks_of(B), tc_threads(H, kTcFwdNT), smem, s>>>(
        static_cast<const bf16*>(xi), h0, wh, bh, B, L, H, static_cast<bf16*>(out));
  } else {  // route kRouteTf32
    const int err = allow_smem(fused_gru_fwd_tf32_kernel, smem);
    if (err) return err;
    fused_gru_fwd_tf32_kernel<<<blocks_of(B), tf_threads(H, kTfFwdNT), smem, s>>>(
        static_cast<const float*>(xi), h0, wh, bh, B, L, H, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// the rows of the recurrent backward's dbh partials: its blocks, or its clusters
int bwd_partials(int B, int H, bool bf16, int* err) {
  *err = 0;
  if (route_of(H, bf16) == kRouteGlobal) return global_blocks(B, std::max(global_rows(H, true), 1));
  if (route_of(H, bf16) != kRouteCluster) return blocks_of(B);
  const ClusterPlan p = cluster_plan(B, H, true);
  *err = p.err;
  return p.clusters;
}

// dwh = sum over the B L rows of h_{t-1}^T dhh: chunk partials, summed in order
template <bool BF, typename XT>
int launch_dwh(const void* out, const float* h0, const float* dhh, int B, int L, int H,
               float* dwh_part, float* dwh, cudaStream_t s) {
  const int chunks = dwh_chunks(B, L, H, BF), C = 3 * H, rows = chunk_rows(B, L, H, BF);
  if constexpr (BF) {
    const int kw = dwh_tc_kw(H);
    const dim3 grid((C + kDT - 1) / kDT, (H + 64 * kw - 1) / (64 * kw), chunks);
    if (kw == 4)
      gru_dwh_tc_kernel<4><<<grid, 512, 0, s>>>(static_cast<const bf16*>(out), h0, dhh, B, L, H,
                                                rows, dwh_part);
    else
      gru_dwh_tc_kernel<2><<<grid, 256, 0, s>>>(static_cast<const bf16*>(out), h0, dhh, B, L, H,
                                                rows, dwh_part);
  } else {
    const dim3 grid((C + kTfDN - 1) / kTfDN, (H + kTfDM - 1) / kTfDM, chunks);
    const int err = allow_smem(gru_dwh_tf32_kernel, tf_dwh_smem());
    if (err) return err;
    gru_dwh_tf32_kernel<<<grid, 256, tf_dwh_smem(), s>>>(static_cast<const float*>(out), h0, dhh,
                                                         B, L, H, rows, dwh_part);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long P = (long long)H * C;
  reduce_partials_kernel<<<(int)((P + 255) / 256), 256, 0, s>>>(dwh_part, chunks, P, dwh);
  return (int)cudaGetLastError();
}

template <bool BF, typename XT>
int launch_bwd(const void* xi, const float* h0, const float* wh, const float* bh,
               const void* out, const void* dout, int B, int L, int H, float* scratch,
               float* rows, void* dxi, float* dh0, float* dhh, float* dbh_part,
               float* dwh_part, float* dwh, float* dbh, cudaStream_t s) {
  const Route route = route_of(H, BF);
  const size_t smem = smem_bytes(H, true, BF);
  int parts = blocks_of(B);
  int err;
  if (route == kRouteCluster) {
    const ClusterPlan p = cluster_plan(B, H, true);
    if (p.err) return p.err;
    parts = p.clusters;
    err = launch_cluster(pick_kernel<PickBwd>(p.cs, p.mt), p, s, static_cast<const bf16*>(xi),
                         h0, wh, bh, static_cast<const bf16*>(out),
                         static_cast<const bf16*>(dout), B, L, H, static_cast<bf16*>(dxi), dh0,
                         dhh, dbh_part);
  } else if (route == kRouteGlobal) {
    err = prep_wh<BF>(wh, H, scratch, s);
    if (err) return err;
    const int R = global_rows(H, true);
    if (!R && !rows) return (int)cudaErrorInvalidValue;
    parts = global_blocks(B, R ? R : 1);
    const XT *x = static_cast<const XT*>(xi), *o = static_cast<const XT*>(out),
             *d = static_cast<const XT*>(dout);
    const float* wt = scratch + (size_t)H * 3 * H;
    XT* dx = static_cast<XT*>(dxi);
    switch (R) {
#define GRU_BWD_GLOBAL(RR, GM) \
  bwd_global<BF, XT, RR>(x, h0, scratch, wt, bh, o, d, B, L, H, GM, dx, dh0, dhh, dbh_part, s)
      case 16: err = GRU_BWD_GLOBAL(16, nullptr); break;
      case 8: err = GRU_BWD_GLOBAL(8, nullptr); break;
      case 4: err = GRU_BWD_GLOBAL(4, nullptr); break;
      case 2: err = GRU_BWD_GLOBAL(2, nullptr); break;
      case 1: err = GRU_BWD_GLOBAL(1, nullptr); break;
      case 0: err = GRU_BWD_GLOBAL(1, rows); break;
#undef GRU_BWD_GLOBAL
      default: err = (int)cudaErrorInvalidValue;
    }
  } else if constexpr (BF) {  // route kRouteTc
    auto kernel = fused_gru_bwd_tc_kernel<kTcBwdNT>;
    err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<parts, tc_threads(H, kTcBwdNT), smem, s>>>(
        static_cast<const bf16*>(xi), h0, wh, bh, static_cast<const bf16*>(out),
        static_cast<const bf16*>(dout), B, L, H, static_cast<bf16*>(dxi), dh0, dhh, dbh_part);
    err = (int)cudaGetLastError();
  } else {  // route kRouteTf32
    err = allow_smem(fused_gru_bwd_tf32_kernel, smem);
    if (err) return err;
    fused_gru_bwd_tf32_kernel<<<parts, tf_threads(H, kTfBwdNT), smem, s>>>(
        static_cast<const float*>(xi), h0, wh, bh, static_cast<const float*>(out),
        static_cast<const float*>(dout), B, L, H, static_cast<float*>(dxi), dh0, dhh, dbh_part);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  err = launch_dwh<BF, XT>(out, h0, dhh, B, L, H, dwh_part, dwh, s);
  if (err) return err;
  reduce_partials_kernel<<<(3 * H + 255) / 256, 256, 0, s>>>(dbh_part, parts, 3 * H, dbh);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest hidden size whose backward rows fit one block's shared memory
// (a multiple of 4; above it the global route keeps them in device memory,
// and only device memory bounds H), the largest that keeps wh in one block's
// shared memory, and the largest that the bf16 instance splits over a
// cluster; above it the global-memory instance runs.
extern "C" int fused_gru_max_hidden() { return max_hidden(); }
extern "C" int fused_gru_max_shared_hidden() { return kMaxH; }
extern "C" int fused_gru_max_cluster_hidden() { return cluster_max_hidden(); }

// The route a call of hidden size H takes: 1 cluster, 2 wh in device
// memory, 3 wh and the backward's rows in device memory, 4 tensor cores in
// one block (bf16, H <= 128), 5 3xTF32 on the tensor cores in one block
// (fp32, H <= 128).
extern "C" int fused_gru_route(int H, int bf16) {
  const Route r = route_of(H, bf16 != 0);
  return r == kRouteGlobal && !global_rows(H, true) ? 3 : (int)r;
}

// Floats of device-memory rows scratch a call of B sequences needs: B x 3 H
// (forward) or B x 8 H (backward) when the global route's rows do not fit a
// block's shared memory, else 0.
extern "C" long long fused_gru_rows_floats(int B, int H, int backward, int bf16) {
  return valid_shape(B, 1, H) ? rows_floats(B, H, backward != 0, bf16 != 0) : 0;
}

// Shared-memory bytes a block needs for hidden size H, forward or backward,
// on the route that H and the instance select (the cluster route: at its most
// rows a block).
extern "C" long long fused_gru_smem_bytes(int H, int backward, int bf16) {
  return (long long)smem_bytes(H, backward != 0, bf16 != 0);
}

// Floats of scratch a call needs: 6 H^2 on the global-memory route (the
// rounded wh and its transpose), else 0.
extern "C" long long fused_gru_scratch_floats(int H, int bf16) {
  return route_of(H, bf16 != 0) == kRouteGlobal ? 6LL * H * H : 0LL;
}

// The rows of the recurrent backward's (rows, 3H) dbh partials (its blocks,
// or its clusters), and of gru_dwh_tf32_kernel's / gru_dwh_tc_kernel's (chunks,
// H * 3H) dwh partials. A negative value is a CUDA error.
extern "C" int fused_gru_bwd_blocks(int B, int L, int H, int bf16) {
  if (!valid_shape(B, L, H)) return -(int)cudaErrorInvalidValue;
  int err;
  const int n = bwd_partials(B, H, bf16 != 0, &err);
  return err ? -err : n;
}

extern "C" int fused_gru_dwh_chunks(int B, int L, int H, int bf16) {
  return valid_shape(B, L, H) ? dwh_chunks(B, L, H, bf16 != 0) : -(int)cudaErrorInvalidValue;
}

// The cluster route's geometry for B sequences at hidden size H on the
// current device: plan[0..5] = cluster size, rows a block, clusters in the
// grid, clusters the device holds at once, threads a block, shared-memory
// bytes a block. Returns the CUDA error code.
extern "C" int fused_gru_cluster_plan(int B, int H, int backward, long long* plan) {
  if (B < 1 || route_of(H, true) != kRouteCluster) return (int)cudaErrorInvalidValue;
  const ClusterPlan p = cluster_plan(B, H, backward != 0);
  if (p.err) return p.err;
  const long long v[6] = {p.cs, 16LL * p.mt, p.clusters, p.resident, p.threads,
                          (long long)p.smem};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

// The per-step floor of the cluster forward at (B, L, H): L - 1 steps of the
// h exchange and the cluster barrier alone (product = 1: with the recurrent
// product), on the forward's geometry. sink holds clusters x cluster size x
// threads floats.
extern "C" int fused_gru_cluster_floor(int B, int L, int H, int product, float* sink,
                                       void* stream) {
  if (B < 1 || L < 1 || route_of(H, true) != kRouteCluster) return (int)cudaErrorInvalidValue;
  const ClusterPlan p = cluster_plan(B, H, false);
  if (p.err) return p.err;
  FloorK k = product ? pick_kernel<PickFloorProduct>(p.cs, p.mt) : pick_kernel<PickFloor>(p.cs, p.mt);
  const ClusterFit f = cluster_fit((const void*)k, p.cs, p.threads, p.smem);
  if (f.err) return f.err;
  return launch_cluster(k, p, static_cast<cudaStream_t>(stream), L, H, sink);
}

// xi (B, L, 3H), out (B, L, H): bf16 when bf16 = 1, else f32; h0 (B, H), wh
// (H, 3H), bh (3H,) f32, all contiguous; scratch fused_gru_scratch_floats(H,
// bf16) f32 and rows fused_gru_rows_floats(B, H, 0, bf16) f32 (each null
// when its size is 0). Returns the CUDA error code.
extern "C" int fused_gru_fwd(const void* xi, const float* h0, const float* wh, const float* bh,
                             int B, int L, int H, int bf16, float* scratch, float* rows,
                             void* out, void* stream) {
  if (!valid_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<true, __nv_bfloat16>(xi, h0, wh, bh, B, L, H, scratch, rows, out, s)
              : launch_fwd<false, float>(xi, h0, wh, bh, B, L, H, scratch, rows, out, s);
}

// The backward's last product alone: dwh (H, 3H) f32 from out (B, L, H; bf16
// when bf16 = 1, else f32), h0 (B, H) and dhh (B, L, 3H) f32, with dwh_part
// (fused_gru_dwh_chunks, H * 3H) f32. Returns the CUDA error code.
extern "C" int fused_gru_dwh(const void* out, const float* h0, const float* dhh, int B, int L,
                             int H, int bf16, float* dwh_part, float* dwh, void* stream) {
  if (!valid_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dwh<true, __nv_bfloat16>(out, h0, dhh, B, L, H, dwh_part, dwh, s)
              : launch_dwh<false, float>(out, h0, dhh, B, L, H, dwh_part, dwh, s);
}

// As fused_gru_fwd, with out and dout (B, L, H) in, and out: dxi (B, L, 3H)
// in xi's type, dh0 (B, H), dwh (H, 3H), dbh (3H,) f32; scratch as above,
// rows fused_gru_rows_floats(B, H, 1, bf16) f32 (null when 0), and dhh (B, L,
// 3H), dbh_part (fused_gru_bwd_blocks, 3H) and dwh_part (fused_gru_dwh_chunks,
// H * 3H) f32.
extern "C" int fused_gru_bwd(const void* xi, const float* h0, const float* wh, const float* bh,
                             const void* out, const void* dout, int B, int L, int H, int bf16,
                             float* scratch, float* rows, void* dxi, float* dh0, float* dhh,
                             float* dbh_part, float* dwh_part, float* dwh, float* dbh,
                             void* stream) {
  if (!valid_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<true, __nv_bfloat16>(xi, h0, wh, bh, out, dout, B, L, H, scratch,
                                                rows, dxi, dh0, dhh, dbh_part, dwh_part, dwh,
                                                dbh, s)
              : launch_bwd<false, float>(xi, h0, wh, bh, out, dout, B, L, H, scratch, rows,
                                         dxi, dh0, dhh, dbh_part, dwh_part, dwh, dbh, s);
}
