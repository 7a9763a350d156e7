// One-pass in-place Adam over every float32 leaf of a training step, in one
// launch, for Hopper.
//
// Replaces: recbole_tpu/ops/fused_adam.py::adam_leaf_kernel (:75), the Pallas
// read-modify-write sweep that the JAX trainer's _fused_adam_apply
// (recbole_tpu/trainer/trainer.py:317-354) runs on one leaf at a time. It
// computes what recbole_tpu_torch/ops/fused_adam.py::adam_leaf_torch computes,
// in its order, each operation rounded once (no contraction into FMA; IEEE
// division and square root), so the kernel and the plain version agree bit
// for bit:
//   g  = g                              where clipping is off or |G| < max_norm,
//   g  = (g / |G|) max_norm             else (|G| read from the device)
//   g  = g + wd p                       (only where wd != 0)
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   u  = (lr (m' c1)) / (sqrt(v' c2) + eps)
//   u  = u + (lr dwd) p                 (only where dwd != 0: adamw)
//   p' = p - u
// with c1 = 1 / (1 - b1^t) and c2 = 1 / (1 - b2^t) from the host's integer
// step count (JAX's bias-correction arrangement, not torch.optim.Adam's).
// wd is the coupled L2 weight decay of the JAX package's
// optax.add_decayed_weights before optax.adam (recbole_tpu/trainer/
// trainer.py:64-75): the decayed term joins the gradient before the moments,
// after the zero head and a null gradient have made it 0, as the JAX chain
// adds it after the [PAD] row's gradient is zeroed. It is a multiply and an
// add, each rounded, as the plain version's g + wd * p; at wd = 0 the term is
// skipped (a uniform branch), so every other path is bit for bit what it was
// (adding 0 * p would turn a -0 gradient into +0 and 0 * inf into NaN).
// The clip is optax.clip_by_global_norm, first in the JAX chain
// (recbole_tpu/trainer/trainer.py:60-63): |G| is the global norm of the
// step's gradients (the zero heads left out), computed beforehand on the
// device (by grad_sq_kernel and grad_norm_finish_kernel below, over the same
// leaf records) and read here through a pointer, so the host never waits
// for it; a gradient is scaled as optax scales it, a
// division and then a multiply, each rounded, and left alone when |G| <
// max_norm. dwd is adamw's decoupled decay (optax.adamw's
// add_decayed_weights after the Adam scaling, before the learning rate): lr
// dwd times the old p joins the update. Both are uniform branches too:
// with the clip's pointer null and dwd = 0 the arithmetic is what it was.
//
// What bounds it on the H100: it reads p, m, v, g and writes p, m, v, 28
// bytes an element (24 where the gradient is zero) for 14 flops, so memory
// bandwidth bounds it: DeepFM-Criteo's 28.3M elements are 0.24 ms at 3.35
// TB/s. Below a few MB, as in BPR's, SASRec's or RippleNet's steps, what is
// left is the launch: one per leaf cost the host a launch each.
//
// Design. One launch sweeps a whole step. The leaves travel by value in the
// kernel's parameter space, a __grid_constant__ struct read from the
// constant bank (no host-to-device copy of a pointer table); CUDA 12.1 lifts
// that space to 32,764 bytes, so up to kMaxLeaves leaves go in one launch,
// and a longer list takes as many launches as it needs (the host splits
// it). Each leaf is cut into chunks of kChunk elements; a leaf record holds
// the prefix of the chunk counts before it, so the step's chunks are one
// index space that DeepFM's one 28.2M-element table and its eleven tiny
// leaves share. Block b takes chunk b and finds its leaf by a binary search
// of the prefix (warp-uniform reads of the constant bank). The first design,
// a grid of the card's resident blocks that walk the chunks in turn, was
// slower at the large leaf sets (scripts/torch_adam_ab.py on an NVIDIA H100
// 80GB HBM3 at 700 W, in a CUDA graph: DeepFM-Criteo's 0.2775 against
// 0.2608 ms, LightGCN's 0.1284 against 0.1206), likely because a resident
// block's stores and its next chunk's loads do not overlap. A thread issues
// all its loads of a chunk (two 16-byte loads each of p, m, v and g) before
// it computes. The 16-byte path is taken where a leaf's four addresses are
// 16-byte aligned: the host decides it for p, m and v once, when it builds
// the leaf records; g, whose address changes every step, is checked here,
// so that a step's host work is to pass the gradients' addresses. Other
// leaves, and the last len % 4 elements of a leaf, go element by element,
// coalesced.
//
// The trainer's two per-step fix-ups are folded in: a leaf whose g is null
// has a zero gradient (a leaf the loss does not reach), and the first
// zero_head elements of a leaf take a zero gradient (the [PAD] row of a
// pad_zero_params table, which the reference's Embedding(padding_idx=0)
// never updates). Both compute with g = 0.0f, as the plain version does on
// a zero-filled gradient, so p, m and v come out bit for bit the same as
// with the fill; g is not read there.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;                            // float4 groups a thread, per array
constexpr int kChunk = kThreads * kVecPerThread * 4;        // 2,048 elements
constexpr int kElemsPerThread = kChunk / kThreads;          // the element path: 8 a thread
constexpr int kMaxLeaves = 512;

// One leaf of the launch: the layout ops/fused_adam.py's LEAF_DTYPE writes.
struct Leaf {
  float* p;
  float* m;
  float* v;
  const float* g;       // null: a zero gradient (written per call from grads)
  long long n;          // elements (> 0)
  long long zero_head;  // leading elements whose gradient counts as zero
  int chunk_start;      // chunks of the launch's leaves before this one
  int vec;              // 1: p, m and v 16-byte aligned
};
static_assert(sizeof(Leaf) == 56, "Leaf must match LEAF_DTYPE");

struct Scalars {
  const float* norm;  // the gradients' global norm on the device; null: no clip
  float c1, c2, b1, omb1, b2, omb2, lr, eps, wd, max_norm, lrdwd;
  int n_leaves, total_chunks;
};

// the clip, read once a thread: whether this step scales its gradients
struct Clip {
  bool on;
  float norm, max_norm;
};

__device__ __forceinline__ Clip read_clip(const Scalars& s) {
  Clip c = {false, 1.0f, s.max_norm};
  if (s.norm) {
    c.norm = __ldg(s.norm);
    c.on = !(c.norm < s.max_norm);
  }
  return c;
}

template <int CAP>
struct Table {
  Scalars s;
  Leaf leaf[CAP];
};
static_assert(sizeof(Table<kMaxLeaves>) <= 32764, "kernel parameters are at most 32,764 bytes");

__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g, const Scalars& s,
                                      const Clip& c) {
  if (c.on) g = __fmul_rn(__fdiv_rn(g, c.norm), c.max_norm);
  if (s.wd != 0.0f) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  const float m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  float upd = __fdiv_rn(__fmul_rn(s.lr, __fmul_rn(m2, s.c1)),
                        __fadd_rn(__fsqrt_rn(__fmul_rn(v2, s.c2)), s.eps));
  if (s.lrdwd != 0.0f) upd = __fadd_rn(upd, __fmul_rn(s.lrdwd, p));
  p = __fsub_rn(p, upd);
  m = m2;
  v = v2;
}

// the element path: element i of the chunk is thread i % kThreads's
// (i / kThreads)-th, so a warp's accesses are contiguous
__device__ __forceinline__ void chunk_elems(const Leaf& L, long long base, int len,
                                            const Scalars& s, const Clip& c) {
  float* __restrict__ p = L.p + base;
  float* __restrict__ m = L.m + base;
  float* __restrict__ v = L.v + base;
  const float* __restrict__ g = L.g ? L.g + base : nullptr;
  const long long head = L.zero_head - base;
  float P[kElemsPerThread], M[kElemsPerThread], V[kElemsPerThread], G[kElemsPerThread];
#pragma unroll
  for (int k = 0; k < kElemsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) {
      P[k] = p[i];
      M[k] = m[i];
      V[k] = v[i];
      G[k] = (g && i >= head) ? g[i] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kElemsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) {
      adam1(P[k], M[k], V[k], G[k], s, c);
      p[i] = P[k];
      m[i] = M[k];
      v[i] = V[k];
    }
  }
}

__device__ __forceinline__ void adam4(float4& p, float4& m, float4& v, float4 g, long long head,
                                      long long e, const Scalars& s, const Clip& c) {
  if (e < head) {  // the group reaches into the zero head
    if (e + 0 < head) g.x = 0.0f;
    if (e + 1 < head) g.y = 0.0f;
    if (e + 2 < head) g.z = 0.0f;
    if (e + 3 < head) g.w = 0.0f;
  }
  adam1(p.x, m.x, v.x, g.x, s, c);
  adam1(p.y, m.y, v.y, g.y, s, c);
  adam1(p.z, m.z, v.z, g.z, s, c);
  adam1(p.w, m.w, v.w, g.w, s, c);
}

// the 16-byte path: float4 group q of the chunk is thread q % kThreads's
__device__ __forceinline__ void chunk_vec(const Leaf& L, long long base, int len,
                                          const Scalars& s, const Clip& c) {
  float4* __restrict__ p = reinterpret_cast<float4*>(L.p + base);
  float4* __restrict__ m = reinterpret_cast<float4*>(L.m + base);
  float4* __restrict__ v = reinterpret_cast<float4*>(L.v + base);
  const float4* __restrict__ g = L.g ? reinterpret_cast<const float4*>(L.g + base) : nullptr;
  const long long head = L.zero_head - base;
  const int groups = len >> 2;
  float4 P[kVecPerThread], M[kVecPerThread], V[kVecPerThread], G[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q < groups) {
      P[k] = p[q];
      M[k] = m[q];
      V[k] = v[q];
      G[k] = (g && 4LL * q + 4 > head) ? g[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q < groups) {
      adam4(P[k], M[k], V[k], G[k], head, 4LL * q, s, c);
      p[q] = P[k];
      m[q] = M[k];
      v[q] = V[k];
    }
  }
  // the leaf's last len % 4 elements (only its last chunk can be short)
  const int i = 4 * groups + threadIdx.x;
  if (i < len) {
    float* pe = L.p + base;
    float* me = L.m + base;
    float* ve = L.v + base;
    float pi = pe[i], mi = me[i], vi = ve[i];
    const float gi = (L.g && i >= head) ? L.g[base + i] : 0.0f;
    adam1(pi, mi, vi, gi, s, c);
    pe[i] = pi;
    me[i] = mi;
    ve[i] = vi;
  }
}

// the leaf of chunk c: the last whose chunks start at or before c
// (chunk_start rises strictly: the host leaves out leaves of no element)
template <int CAP>
__device__ __forceinline__ const Leaf& leaf_of(const Table<CAP>& t, int c) {
  int lo = 0, hi = t.s.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk_start <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  return t.leaf[lo];
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const __grid_constant__ Table<CAP> t) {
  const Scalars& s = t.s;
  const int c = blockIdx.x;
  const Leaf& L = leaf_of(t, c);
  const long long base = (long long)(c - L.chunk_start) * kChunk;
  const long long rest = L.n - base;
  const int len = rest < kChunk ? (int)rest : kChunk;
  const Clip clip = read_clip(s);
  if (L.vec && !(reinterpret_cast<uintptr_t>(L.g) & 15))
    chunk_vec(L, base, len, s, clip);
  else
    chunk_elems(L, base, len, s, clip);
}

// The clip's norm. The sum of a block's floats in a fixed order: each
// warp's by shuffles, then warp 0 sums the warps' in order; thread 0 holds
// the block's sum.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sum[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

// block c: the sum of squares of chunk c's gradient (a null gradient and the
// zero head count as 0), the Adam kernel's chunks and element order, into
// partial[c]
template <int CAP>
__global__ void __launch_bounds__(kThreads)
grad_sq_kernel(const __grid_constant__ Table<CAP> t, float* __restrict__ partial) {
  const int c = blockIdx.x;
  const Leaf& L = leaf_of(t, c);
  const long long base = (long long)(c - L.chunk_start) * kChunk;
  const long long rest = L.n - base;
  const int len = rest < kChunk ? (int)rest : kChunk;
  float acc = 0.0f;
  if (L.g) {
    const float* __restrict__ g = L.g + base;
    const long long head = L.zero_head - base;
#pragma unroll
    for (int k = 0; k < kElemsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < len && i >= head) acc = __fmaf_rn(g[i], g[i], acc);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[c] = acc;
}

// one block: the sum of the n partials (thread i those at i, i + kThreads,
// ... in turn, then block_sum) and its square root into *norm
__global__ void __launch_bounds__(kThreads)
grad_norm_finish_kernel(const float* __restrict__ partial, int n, float* __restrict__ norm) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc = __fadd_rn(acc, partial[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) *norm = __fsqrt_rn(acc);
}

template <int CAP>
void fill(Table<CAP>& t, const Leaf* leaves, const float* const* grads, int n_leaves,
          int total_chunks, const Scalars& s) {
  t.s = s;
  t.s.n_leaves = n_leaves;
  t.s.total_chunks = total_chunks;
  memcpy(t.leaf, leaves, sizeof(Leaf) * n_leaves);
  for (int i = 0; i < n_leaves; ++i) t.leaf[i].g = grads[i];
}

template <int CAP>
int launch(const Leaf* leaves, const float* const* grads, int n_leaves, int total_chunks,
           const Scalars& s, cudaStream_t stream) {
  Table<CAP> t;
  fill(t, leaves, grads, n_leaves, total_chunks, s);
  adam_multi_kernel<CAP><<<total_chunks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

template <int CAP>
int launch_sq(const Leaf* leaves, const float* const* grads, int n_leaves, int total_chunks,
              float* partial, cudaStream_t stream) {
  Table<CAP> t;
  fill(t, leaves, grads, n_leaves, total_chunks, Scalars{});
  grad_sq_kernel<CAP><<<total_chunks, kThreads, 0, stream>>>(t, partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int adam_multi_chunk() { return kChunk; }

extern "C" int adam_multi_max_leaves() { return kMaxLeaves; }

// One launch over n_leaves records (each n > 0, chunk_start their chunk
// prefix, total_chunks the sum) with the step's gradient addresses (null: a
// zero gradient), weight decay wd (0: none), the clip (norm: a device
// pointer to the gradients' global norm, null for none; max_norm) and
// adamw's decoupled decay as lr dwd (0: none), on stream. The parameter
// block is the smallest instance that holds the list: Table<kMaxLeaves> alone (28.7 KB of parameters) cost
// the host 2-25 us more a call than Table<16> / <64> at BPR's, DeepFM's,
// SASRec's and LightGCN's sets, with the same device time
// (scripts/torch_adam_ab.py --kernels-only, both builds in turns in one call,
// an NVIDIA H100 80GB HBM3 at 700 W).
extern "C" int adam_multi_f32(const void* leaves, const void* grads, int n_leaves,
                              int total_chunks, float c1, float c2, float b1, float omb1,
                              float b2, float omb2, float lr, float eps, float wd,
                              const float* norm, float max_norm, float lrdwd, void* stream) {
  if (n_leaves <= 0 || total_chunks <= 0) return (int)cudaErrorInvalidValue;
  const Leaf* l = static_cast<const Leaf*>(leaves);
  const float* const* g = static_cast<const float* const*>(grads);
  const Scalars s = {norm, c1, c2, b1, omb1, b2, omb2, lr, eps, wd, max_norm, lrdwd, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves <= 16) return launch<16>(l, g, n_leaves, total_chunks, s, st);
  if (n_leaves <= 64) return launch<64>(l, g, n_leaves, total_chunks, s, st);
  if (n_leaves <= kMaxLeaves) return launch<kMaxLeaves>(l, g, n_leaves, total_chunks, s, st);
  return (int)cudaErrorInvalidValue;
}

// The clip's norm over the same records: block c's sum of squares into
// partial[c] (total_chunks floats), one launch for up to kMaxLeaves leaves;
// the host gives each launch its own run of partial.
extern "C" int adam_grad_sq_f32(const void* leaves, const void* grads, int n_leaves,
                                int total_chunks, float* partial, void* stream) {
  if (n_leaves <= 0 || total_chunks <= 0) return (int)cudaErrorInvalidValue;
  const Leaf* l = static_cast<const Leaf*>(leaves);
  const float* const* g = static_cast<const float* const*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves <= 16) return launch_sq<16>(l, g, n_leaves, total_chunks, partial, st);
  if (n_leaves <= 64) return launch_sq<64>(l, g, n_leaves, total_chunks, partial, st);
  if (n_leaves <= kMaxLeaves)
    return launch_sq<kMaxLeaves>(l, g, n_leaves, total_chunks, partial, st);
  return (int)cudaErrorInvalidValue;
}

// then the square root of the n partials' sum into *norm (device memory)
extern "C" int adam_grad_norm_finish_f32(const float* partial, int n, float* norm, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  grad_norm_finish_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(partial, n, norm);
  return (int)cudaGetLastError();
}
