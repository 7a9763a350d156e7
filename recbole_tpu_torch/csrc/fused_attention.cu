// Multi-head attention alone (mask, softmax, dropout, the two products),
// forward and backward, for Hopper, in fp32.
//
// Replaces: recbole_tpu/ops/fused_attention.py::fused_attention (:204;
// Pallas kernels _fwd_kernel :78 and _bwd_kernel :95), the kernel behind
// the JAX package's fused_attention: True (models/layers.py:390-423). Per
// sequence b and head h, on q, k, v (B, L, H, hd) f32 (the natural reshape
// of a (B, L, D) projection):
//   S = q k^T scale, -1e9 where key j is not valid or (causal) j > i;
//   P = softmax(S);  Pd = P keep / (1 - rate);  o = Pd v.
// A query row with no valid key comes out uniform, as in the reference.
// The backward recomputes P, regenerates the keep mask, and writes
//   dp = (dO v^T) keep / (1 - rate);  dS = P (dp - rowsum(dp P)) scale,
//   0 where the mask holds;  dq = dS k;  dk = dS^T q;  dv = Pd^T dO.
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
// rate's time. Design: one block of 128 threads per (sequence, head): the
// (L, hd) slices and the (L, L) scores live in shared memory (10 KB at
// L = 50), so no online softmax is needed and the scores never reach device
// memory; each block writes its own slices of o (dq, dk, dv), so nothing is
// summed across blocks and the kernels need no atomics. Rows are padded by
// one float so that reads along keys are free of bank conflicts.
//
// Dropout: Philox4x32-10 keyed by the seed (one int64 drawn on the device
// from the caller's generator) and counted by (element / 4, sequence, head,
// layer) with element = i L + j, the scheme of csrc/trm_layer.cu (its
// attention sites): the same bits in the forward and the backward, whatever
// block draws them. The Philox rounds below are a copy of that source's.
// fused_attention_dropout_masks writes the keep masks out for the plain
// version.
//
// Limits: shared memory (fused_attention_smem_bytes) within the card's
// opt-in limit (L up to about 140 at hd = 32); any B, H and hd.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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

// the (L, hd) slice of (sequence b, head h) of a (B, L, H, hd) tensor into
// shared memory rows of hd + 1 floats
__device__ void load_slice(float* dst, const float* __restrict__ src, const Shape& sh, int b,
                           int h) {
  const int hd = sh.hd, n = sh.L * hd;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i / hd, d = i - l * hd;
    dst[l * (hd + 1) + d] = src[(((size_t)b * sh.L + l) * sh.H + h) * hd + d];
  }
}

__device__ __forceinline__ size_t slice_at(const Shape& sh, int b, int h, int l, int d) {
  return (((size_t)b * sh.L + l) * sh.H + h) * sh.hd + d;
}

// S[i][j] = q_i . k_j * scale where key j is visible from query i, else -1e9
__device__ void scores(float* S, int LS, const float* qs, const float* ks, const int* valid,
                       const Shape& sh) {
  const int L = sh.L, hd = sh.hd;
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e - i * L;
    float s = kNeg;
    if (valid[j] > 0 && (!sh.causal || j <= i)) {
      float a = 0.0f;
      for (int d = 0; d < hd; ++d) a = fmaf(qs[i * (hd + 1) + d], ks[j * (hd + 1) + d], a);
      s = a * sh.scale;
    }
    S[i * LS + j] = s;
  }
}

// each row of S to its softmax, one warp a row
__device__ void softmax_rows(float* S, int LS, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < L; i += kWarps) {
    float* row = S + i * LS;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.0f / sum;
    for (int j = lane; j < L; j += 32) row[j] *= inv;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ key_valid,
                           const long long* __restrict__ seed, Shape sh, float* __restrict__ o) {
  extern __shared__ float smem[];
  const int L = sh.L, hd = sh.hd, LS = L + 1, LD = hd + 1;
  float* qs = smem;
  float* ks = qs + L * LD;
  float* vs = ks + L * LD;
  float* S = vs + L * LD;
  int* valid = reinterpret_cast<int*>(S + L * LS);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  load_slice(qs, q, sh, b, h);
  load_slice(ks, k, sh, b, h);
  load_slice(vs, v, sh, b, h);
  for (int l = threadIdx.x; l < L; l += blockDim.x) valid[l] = key_valid[(size_t)b * L + l];
  __syncthreads();
  scores(S, LS, qs, ks, valid, sh);
  __syncthreads();
  softmax_rows(S, LS, L);
  __syncthreads();
  if (drop.on) {
    for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
      const int i = e / L, j = e - i * L;
      S[i * LS + j] = drop.keep(e, b, h) ? S[i * LS + j] * drop.inv : 0.0f;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;
    float a = 0.0f;
    for (int j = 0; j < L; ++j) a = fmaf(S[i * LS + j], vs[j * LD + d], a);
    o[slice_at(sh, b, h, i, d)] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ key_valid,
                           const long long* __restrict__ seed, Shape sh,
                           const float* __restrict__ dout, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int L = sh.L, hd = sh.hd, LS = L + 1, LD = hd + 1;
  float* qs = smem;
  float* ks = qs + L * LD;
  float* vs = ks + L * LD;
  float* dos = vs + L * LD;
  float* P = dos + L * LD;
  float* dP = P + L * LS;
  int* valid = reinterpret_cast<int*>(dP + L * LS);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  load_slice(qs, q, sh, b, h);
  load_slice(ks, k, sh, b, h);
  load_slice(vs, v, sh, b, h);
  load_slice(dos, dout, sh, b, h);
  for (int l = threadIdx.x; l < L; l += blockDim.x) valid[l] = key_valid[(size_t)b * L + l];
  __syncthreads();
  scores(P, LS, qs, ks, valid, sh);
  // dP[i][j] = dO_i . v_j (the cotangent of the dropped probabilities)
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e - i * L;
    float a = 0.0f;
    for (int d = 0; d < hd; ++d) a = fmaf(dos[i * LD + d], vs[j * LD + d], a);
    dP[i * LS + j] = a;
  }
  __syncthreads();
  softmax_rows(P, LS, L);
  __syncthreads();
  // per row: dp = dP keep / (1 - rate); dS = P (dp - rowsum(dp P)) scale into
  // dP; P keep / (1 - rate) into P
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < L; i += kWarps) {
    float* p = P + i * LS;
    float* g = dP + i * LS;
    float t = 0.0f;
    for (int j = lane; j < L; j += 32) {
      if (drop.on) g[j] = drop.keep(i * L + j, b, h) ? g[j] * drop.inv : 0.0f;
      t = fmaf(g[j], p[j], t);
    }
    for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    for (int j = lane; j < L; j += 32) {
      const bool ok = valid[j] > 0 && (!sh.causal || j <= i);
      g[j] = ok ? p[j] * (g[j] - t) * sh.scale : 0.0f;
      if (drop.on) p[j] = drop.keep(i * L + j, b, h) ? p[j] * drop.inv : 0.0f;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;  // i: the query row for dq, the key row for dk, dv
    float aq = 0.0f, ak = 0.0f, av = 0.0f;
    for (int j = 0; j < L; ++j) {
      aq = fmaf(dP[i * LS + j], ks[j * LD + d], aq);
      ak = fmaf(dP[j * LS + i], qs[j * LD + d], ak);
      av = fmaf(P[j * LS + i], dos[j * LD + d], av);
    }
    const size_t at = slice_at(sh, b, h, i, d);
    dq[at] = aq;
    dk[at] = ak;
    dv[at] = av;
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

size_t smem_bytes(int L, int hd, bool backward) {
  const size_t slices = (size_t)(backward ? 4 : 3) * L * (hd + 1);
  const size_t mats = (size_t)(backward ? 2 : 1) * L * (L + 1);
  return sizeof(float) * (slices + mats) + sizeof(int) * (size_t)L;
}

int make_shape(int B, int L, int H, int hd, int causal, float scale, float rate, int layer,
               Shape* sh) {
  if (B < 1 || L < 1 || H < 1 || hd < 1 || rate < 0.0f || rate >= 1.0f ||
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

// Shared-memory bytes a block needs, forward or backward.
extern "C" long long fused_attention_smem_bytes(int L, int hd, int backward) {
  return (long long)smem_bytes(L, hd, backward != 0);
}

// q, k, v, o (B, L, H, hd) f32 contiguous; key_valid (B, L) int32 (> 0: a
// real key); seed one int64 on the device (null when rate is 0). Returns the
// CUDA error code.
extern "C" int fused_attention_fwd(const float* q, const float* k, const float* v,
                                   const int* key_valid, const void* seed, int B, int L, int H,
                                   int hd, int causal, float scale, float rate, int layer,
                                   float* o, void* stream) {
  Shape sh;
  int err = make_shape(B, L, H, hd, causal, scale, rate, layer, &sh);
  if (err) return err;
  if (rate > 0.0f && !seed) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L, hd, false);
  err = allow_smem(fused_attention_fwd_kernel, smem);
  if (err) return err;
  fused_attention_fwd_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_valid, static_cast<const long long*>(seed), sh, o);
  return (int)cudaGetLastError();
}

// As fused_attention_fwd, with dout in and dq, dk, dv out, all (B, L, H, hd).
extern "C" int fused_attention_bwd(const float* q, const float* k, const float* v,
                                   const int* key_valid, const void* seed, int B, int L, int H,
                                   int hd, int causal, float scale, float rate, int layer,
                                   const float* dout, float* dq, float* dk, float* dv,
                                   void* stream) {
  Shape sh;
  int err = make_shape(B, L, H, hd, causal, scale, rate, layer, &sh);
  if (err) return err;
  if (rate > 0.0f && !seed) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L, hd, true);
  err = allow_smem(fused_attention_bwd_kernel, smem);
  if (err) return err;
  fused_attention_bwd_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_valid, static_cast<const long long*>(seed), sh, dout, dq, dk, dv);
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
