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
// bytes 105 MB forward and 210 MB backward in the bf16 instance; as fp32 FMAs
// (this first version does not use the tensor cores) the fp32 rate bounds
// them at 0.150 and 0.451 ms. The recurrence is serial in t, so a step's
// latency matters as much: each block owns kRows = 16 sequences for the whole
// loop (128 blocks at B = 2048 on 132 SMs), keeps wh (rounded in the bf16
// instance) in shared memory, padded so that both the column reads of the
// forward product and the row reads of dhh wh^T are free of bank conflicts,
// and never sends h through device memory: a thread owns one hidden unit j
// and 8 rows, carries their h (forward) or dh (backward) in registers, and
// exchanges only the rounded h rows (forward: one barrier a step, double
// buffered) or the dhh rows (backward: two barriers a step) through shared
// memory. Blocks run in no order, so the parameter gradients are not summed
// across blocks in place: the recurrent backward writes each step's dhh
// (fp32) and a per-block dbh partial; gru_dwh_kernel then forms
// [h_{t-1}]^T dhh over chunks of the B L rows, one partial per chunk, and
// reduce_partials_kernel sums the partials in chunk (block) order. No float
// atomics: two runs give the same bits.
//
// Limits: H a multiple of 4, at most kMaxH = 128 (two threads a hidden unit,
// 256 threads; fp32 wh and the step's rows take 231,424 bytes of shared
// memory at H = 128 in the backward). Any B and L.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // sequences a block owns
constexpr int kRT = 8;      // rows of a thread (two row groups of 8)
constexpr int kMaxH = 128;  // two threads a hidden unit
constexpr int kPad = 4;     // floats added to every row of wh in shared memory
// gru_dwh_kernel tiles
constexpr int kTK = 64, kTC = 64, kTN = 32;
constexpr int kDwhBlocks = 528;  // about four blocks an SM

__host__ __device__ inline int wh_stride(int H) { return 3 * H + kPad; }

// shared-memory floats: wh (H rows of 3H + kPad) and, forward, two buffers of
// the block's rounded h rows, or, backward, one buffer of h_{t-1} rows and one
// of dhh rows
inline size_t smem_floats(int H, bool backward) {
  const size_t w = (size_t)H * wh_stride(H);
  return backward ? w + (size_t)kRows * H + (size_t)kRows * 3 * H : w + 2 * (size_t)kRows * H;
}

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

// wh (H, 3H) into shared memory, rounded in the bf16 instance
template <bool BF>
__device__ void load_wh(float* whs, const float* __restrict__ wh, int H) {
  const int C = 3 * H, WS = wh_stride(H);
  for (int i = threadIdx.x; i < H * C; i += blockDim.x) {
    const int k = i / C, c = i - k * C;
    whs[k * WS + c] = rnd<BF>(wh[i]);
  }
}

// acc[r][g] = sum_k hs[row r][k] * whs[k][j + g H] for the thread's 8 rows
__device__ __forceinline__ void recurrent_product(const float* hs, const float* whs, int H,
                                                  int j, int r0, float acc[kRT][3]) {
  const int WS = wh_stride(H);
#pragma unroll
  for (int r = 0; r < kRT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
  for (int k = 0; k < H; k += 4) {
    float w[3][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 3; ++g) w[g][kk] = whs[(k + kk) * WS + j + g * H];
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const float4 h = *reinterpret_cast<const float4*>(hs + (r0 + r) * H + k);
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

// ------------------------------------------------------------------ forward

// XT: the type of xi and out (float, or __nv_bfloat16 in the bf16 instance)
template <bool BF, typename XT>
__global__ void __launch_bounds__(kThreads)
fused_gru_fwd_kernel(const XT* __restrict__ xi, const float* __restrict__ h0,
                     const float* __restrict__ wh, const float* __restrict__ bh, int B, int L,
                     int H, XT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* whs = reinterpret_cast<float*>(smem4);
  float* hbuf = whs + (size_t)H * wh_stride(H);  // [2][kRows][H], h as the product reads it
  const int tid = threadIdx.x;
  const bool active = tid < 2 * H;
  const int j = active ? tid % H : 0, r0 = active ? (tid / H) * kRT : 0;
  const int b0 = blockIdx.x * kRows;
  const size_t C = 3 * (size_t)H;

  load_wh<BF>(whs, wh, H);
  float h[kRT], bias[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int b = b0 + r0 + r;
    h[r] = (active && b < B) ? h0[(size_t)b * H + j] : 0.0f;
    if (active) hbuf[(r0 + r) * H + j] = rnd<BF>(h[r]);
  }
  if (active)
    for (int g = 0; g < 3; ++g) bias[g] = bh[g * H + j];
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < L; ++t) {
    float x[kRT][3];
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int b = b0 + r0 + r;
      const size_t base = ((size_t)b * L + t) * C + j;
#pragma unroll
      for (int g = 0; g < 3; ++g) x[r][g] = (active && b < B) ? ld(xi, base + g * H) : 0.0f;
    }
    float acc[kRT][3];
    recurrent_product(hbuf + cur * kRows * H, whs, H, j, r0, acc);
    float* nxt = hbuf + (cur ^ 1) * kRows * H;
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const float rr = sigm(x[r][0] + (acc[r][0] + bias[0]));
      const float z = sigm(x[r][1] + (acc[r][1] + bias[1]));
      const float n = tanhf(x[r][2] + rr * (acc[r][2] + bias[2]));
      h[r] = (1.0f - z) * n + z * h[r];
      const int b = b0 + r0 + r;
      if (active) {
        nxt[(r0 + r) * H + j] = rnd<BF>(h[r]);
        if (b < B) st(out, ((size_t)b * L + t) * H + j, h[r]);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// ----------------------------------------------------------------- backward

template <bool BF, typename XT>
__global__ void __launch_bounds__(kThreads)
fused_gru_bwd_kernel(const XT* __restrict__ xi, const float* __restrict__ h0,
                     const float* __restrict__ wh, const float* __restrict__ bh,
                     const XT* __restrict__ out, const XT* __restrict__ dout, int B, int L, int H,
                     XT* __restrict__ dxi, float* __restrict__ dh0, float* __restrict__ dhh,
                     float* __restrict__ dbh_part) {
  extern __shared__ float4 smem4[];
  float* whs = reinterpret_cast<float*>(smem4);
  const int WS = wh_stride(H);
  float* hs = whs + (size_t)H * WS;  // [kRows][H]: h_{t-1} as the product reads it
  float* ds = hs + kRows * H;        // [kRows][3H]: this step's dhh rows
  const int tid = threadIdx.x;
  const bool active = tid < 2 * H;
  const int j = active ? tid % H : 0, r0 = active ? (tid / H) * kRT : 0;
  const int b0 = blockIdx.x * kRows;
  const int C = 3 * H;

  // h_{t-1} of row b: the forward's output at t - 1, h0 at t = 0
  auto h_prev = [&](int b, int t, int k) -> float {
    return t == 0 ? h0[(size_t)b * H + k] : ld(out, ((size_t)b * L + t - 1) * H + k);
  };
  auto load_hs = [&](int t) {
    for (int i = tid; i < kRows * H; i += blockDim.x) {
      const int rr = i / H, k = i - rr * H, b = b0 + rr;
      hs[i] = b < B ? rnd<BF>(h_prev(b, t, k)) : 0.0f;
    }
  };

  load_wh<BF>(whs, wh, H);
  load_hs(L - 1);
  float dh[kRT], bias[3] = {0.0f, 0.0f, 0.0f}, dbh_acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < kRT; ++r) dh[r] = 0.0f;
  if (active)
    for (int g = 0; g < 3; ++g) bias[g] = bh[g * H + j];
  __syncthreads();

  for (int t = L - 1; t >= 0; --t) {
    float x[kRT][3], hp[kRT], dy[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int b = b0 + r0 + r;
      const bool ok = active && b < B;
      const size_t base = ((size_t)b * L + t) * C + j;
#pragma unroll
      for (int g = 0; g < 3; ++g) x[r][g] = ok ? ld(xi, base + g * H) : 0.0f;
      hp[r] = ok ? h_prev(b, t, j) : 0.0f;
      dy[r] = ok ? ld(dout, ((size_t)b * L + t) * H + j) : 0.0f;
    }
    float acc[kRT][3], z[kRT];
    recurrent_product(hs, whs, H, j, r0, acc);
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const float hr = acc[r][0] + bias[0], hz = acc[r][1] + bias[1], hn = acc[r][2] + bias[2];
      const float rr = sigm(x[r][0] + hr);
      z[r] = sigm(x[r][1] + hz);
      const float n = tanhf(x[r][2] + rr * hn);
      dh[r] += dy[r];
      const float dpre_n = dh[r] * (1.0f - z[r]) * (1.0f - n * n);
      const float dpre_r = dpre_n * hn * rr * (1.0f - rr);
      const float dpre_z = dh[r] * (hp[r] - n) * z[r] * (1.0f - z[r]);
      const float d[3] = {dpre_r, dpre_z, dpre_n * rr};
      const int b = b0 + r0 + r;
      if (active) {
#pragma unroll
        for (int g = 0; g < 3; ++g) ds[(r0 + r) * C + g * H + j] = d[g];
        if (b < B) {
          const size_t base = ((size_t)b * L + t) * C + j;
          st(dxi, base, dpre_r);
          st(dxi, base + H, dpre_z);
          st(dxi, base + 2 * H, dpre_n);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            dhh[base + g * H] = d[g];
            dbh_acc[g] += d[g];
          }
        }
      }
    }
    __syncthreads();  // ds is complete, and nobody reads hs any more this step
    if (t > 0) load_hs(t - 1);
    // dh = dh z + round(dhh wh^T): row j of wh against the block's dhh rows
    float p[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) p[r] = 0.0f;
    for (int c = 0; c < C; c += 4) {
      const float4 w = *reinterpret_cast<const float4*>(whs + j * WS + c);
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(ds + (r0 + r) * C + c);
        float a = p[r];
        a = fmaf(d.x, w.x, a);
        a = fmaf(d.y, w.y, a);
        a = fmaf(d.z, w.z, a);
        a = fmaf(d.w, w.w, a);
        p[r] = a;
      }
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) dh[r] = dh[r] * z[r] + rnd<BF>(p[r]);
    __syncthreads();  // hs holds the next step's rows; ds may be written again
  }
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int b = b0 + r0 + r;
    if (active && b < B) dh0[(size_t)b * H + j] = dh[r];
  }
  // the block's dbh: row group 0's sum, then row group 1's, in shared memory
  if (active)
    for (int g = 0; g < 3; ++g) ds[(r0 / kRT) * C + g * H + j] = dbh_acc[g];
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x)
    dbh_part[(size_t)blockIdx.x * C + c] = ds[c] + ds[C + c];
}

// partial[chunk] = sum over the chunk's rows n = (b, t) of h_{t-1}[b]^T dhh[n]
// ((H, 3H), h rounded as the product read it). Grid (3H / kTC, H / kTK,
// chunks), 256 threads, each a 4 x 4 tile of the block's kTK x kTC outputs.
template <bool BF, typename XT>
__global__ void __launch_bounds__(kThreads)
gru_dwh_kernel(const XT* __restrict__ out, const float* __restrict__ h0,
               const float* __restrict__ dhh, int B, int L, int H, int chunk_rows,
               float* __restrict__ partials) {
  __shared__ __align__(16) float As[kTN][kTK];
  __shared__ __align__(16) float Bs[kTN][kTC];
  const int C = 3 * H, N = B * L;
  const int c0 = blockIdx.x * kTC, k0 = blockIdx.y * kTK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_begin = blockIdx.z * chunk_rows;
  const int n_end = min(N, n_begin + chunk_rows);
  float acc[4][4] = {};
  for (int n0 = n_begin; n0 < n_end; n0 += kTN) {
    for (int i = threadIdx.x; i < kTN * kTK; i += blockDim.x) {
      const int nn = i / kTK, kk = i - nn * kTK, n = n0 + nn, k = k0 + kk;
      float v = 0.0f;
      if (n < n_end && k < H) {
        const int b = n / L, t = n - b * L;
        v = rnd<BF>(t == 0 ? h0[(size_t)b * H + k] : ld(out, ((size_t)n - 1) * H + k));
      }
      As[nn][kk] = v;
    }
    for (int i = threadIdx.x; i < kTN * kTC; i += blockDim.x) {
      const int nn = i / kTC, cc = i - nn * kTC, n = n0 + nn, c = c0 + cc;
      Bs[nn][cc] = (n < n_end && c < C) ? dhh[(size_t)n * C + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kTN; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(&As[nn][ty * 4]);
      const float4 d = *reinterpret_cast<const float4*>(&Bs[nn][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], dv[q], acc[i][q]);
    }
    __syncthreads();
  }
  float* part = partials + (size_t)blockIdx.z * H * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx * 4 + q;
      if (k < H && c < C) part[(size_t)k * C + c] = acc[i][q];
    }
  }
}

// out[p] = sum of the n partials, in their order
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int n, int P,
                                       float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int b = 0; b < n; ++b) s += partials[(size_t)b * P + p];
  out[p] = s;
}

// ------------------------------------------------------------------- launch

int valid_shape(int B, int L, int H) {
  return B >= 1 && L >= 1 && H >= 4 && H % 4 == 0 && H <= kMaxH;
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

int blocks_of(int B) { return (B + kRows - 1) / kRows; }

int dwh_chunks(int B, int L, int H) {
  const int tiles = ((3 * H + kTC - 1) / kTC) * ((H + kTK - 1) / kTK);
  const int most = (B * L + kTN - 1) / kTN;
  const int want = (kDwhBlocks + tiles - 1) / tiles;
  return want < most ? want : most;
}

int chunk_rows(int B, int L, int H) {
  const int n = dwh_chunks(B, L, H), N = B * L;
  const int rows = (N + n - 1) / n;
  return (rows + kTN - 1) / kTN * kTN;
}

template <bool BF, typename XT>
int launch_fwd(const void* xi, const float* h0, const float* wh, const float* bh, int B, int L,
               int H, void* out, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(H, false);
  int err = allow_smem(fused_gru_fwd_kernel<BF, XT>, smem);
  if (err) return err;
  fused_gru_fwd_kernel<BF, XT><<<blocks_of(B), kThreads, smem, s>>>(
      static_cast<const XT*>(xi), h0, wh, bh, B, L, H, static_cast<XT*>(out));
  return (int)cudaGetLastError();
}

template <bool BF, typename XT>
int launch_bwd(const void* xi, const float* h0, const float* wh, const float* bh,
               const void* out, const void* dout, int B, int L, int H, void* dxi, float* dh0,
               float* dhh, float* dbh_part, float* dwh_part, float* dwh, float* dbh,
               cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(H, true);
  int err = allow_smem(fused_gru_bwd_kernel<BF, XT>, smem);
  if (err) return err;
  const int blocks = blocks_of(B);
  fused_gru_bwd_kernel<BF, XT><<<blocks, kThreads, smem, s>>>(
      static_cast<const XT*>(xi), h0, wh, bh, static_cast<const XT*>(out),
      static_cast<const XT*>(dout), B, L, H, static_cast<XT*>(dxi), dh0, dhh, dbh_part);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int chunks = dwh_chunks(B, L, H), C = 3 * H;
  const dim3 grid((C + kTC - 1) / kTC, (H + kTK - 1) / kTK, chunks);
  gru_dwh_kernel<BF, XT><<<grid, kThreads, 0, s>>>(static_cast<const XT*>(out), h0, dhh, B, L,
                                                   H, chunk_rows(B, L, H), dwh_part);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_partials_kernel<<<(H * C + 255) / 256, 256, 0, s>>>(dwh_part, chunks, H * C, dwh);
  reduce_partials_kernel<<<(C + 255) / 256, 256, 0, s>>>(dbh_part, blocks, C, dbh);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest hidden size the kernels take.
extern "C" int fused_gru_max_hidden() { return kMaxH; }

// Shared-memory bytes a block needs for hidden size H, forward or backward.
extern "C" long long fused_gru_smem_bytes(int H, int backward) {
  return (long long)(sizeof(float) * smem_floats(H, backward != 0));
}

// The number of blocks of the recurrent backward (the rows of its (blocks,
// 3H) dbh partials), and of the chunks of gru_dwh_kernel (the rows of its
// (chunks, H * 3H) dwh partials).
extern "C" int fused_gru_bwd_blocks(int B, int L, int H) {
  return valid_shape(B, L, H) ? blocks_of(B) : -(int)cudaErrorInvalidValue;
}

extern "C" int fused_gru_dwh_chunks(int B, int L, int H) {
  return valid_shape(B, L, H) ? dwh_chunks(B, L, H) : -(int)cudaErrorInvalidValue;
}

// xi (B, L, 3H), out (B, L, H): bf16 when bf16 = 1, else f32; h0 (B, H), wh
// (H, 3H), bh (3H,) f32, all contiguous. Returns the CUDA error code.
extern "C" int fused_gru_fwd(const void* xi, const float* h0, const float* wh, const float* bh,
                             int B, int L, int H, int bf16, void* out, void* stream) {
  if (!valid_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<true, __nv_bfloat16>(xi, h0, wh, bh, B, L, H, out, s)
              : launch_fwd<false, float>(xi, h0, wh, bh, B, L, H, out, s);
}

// As fused_gru_fwd, with out and dout (B, L, H) in, and out: dxi (B, L, 3H)
// in xi's type, dh0 (B, H), dwh (H, 3H), dbh (3H,) f32; scratch: dhh (B, L,
// 3H), dbh_part (fused_gru_bwd_blocks, 3H) and dwh_part (fused_gru_dwh_chunks,
// H * 3H) f32.
extern "C" int fused_gru_bwd(const void* xi, const float* h0, const float* wh, const float* bh,
                             const void* out, const void* dout, int B, int L, int H, int bf16,
                             void* dxi, float* dh0, float* dhh, float* dbh_part,
                             float* dwh_part, float* dwh, float* dbh, void* stream) {
  if (!valid_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<true, __nv_bfloat16>(xi, h0, wh, bh, out, dout, B, L, H, dxi, dh0,
                                                dhh, dbh_part, dwh_part, dwh, dbh, s)
              : launch_bwd<false, float>(xi, h0, wh, bh, out, dout, B, L, H, dxi, dh0, dhh,
                                         dbh_part, dwh_part, dwh, dbh, s);
}
