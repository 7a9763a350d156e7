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
// A query row with no valid key comes out uniform over the L keys, as in the
// reference. The backward recomputes P, regenerates the keep mask, and writes
//   dp = (dO v^T) keep / (1 - rate);  dS = P (dp - t) scale, t = rowsum(dp P)
//   (= dO . o), 0 where the mask holds;  dq = dS k;  dk = dS^T q;  dv = Pd^T dO.
// The mask is a select (attention_xla :224), so a masked score has no
// gradient; the JAX kernel adds -1e9 and its backward passes a cotangent to
// the masked scores of a row with no valid key (it differs only there).
// The JAX kernel builds a key-only mask in the bidirectional case (its
// _build_mask :39-47 and attention_xla :224), and so do these.
//
// What bounds it on the H100 (SASRec's step: B = 2048, H = 2, L = 50,
// hd = 32): bytes. The forward moves q, k, v in and o out (104.9 MB,
// 0.031 ms at 3.35 TB/s) for 0.67 GFLOP over the causal pairs; the backward
// q, k, v, dO in and dq, dk, dv out (157.3 MB, 0.047 ms) for 1.67 GFLOP, both
// far below the fp32 rate's time (0.010 / 0.025 ms).
//
// Two routes, chosen from (L, hd) before launch (route_of; exported as
// fused_attention_route):
//
// * Whole sequence, L <= 64 (kWholeMaxL) when the backward's block fits the
//   shared memory (any hd up to 188 at L 64): a block of 256 threads per
//   (sequence, head) holds the head's q, k, v (dO) rows, loaded by 16-byte
//   cp.async (4-byte when hd is not a multiple of 4 or a pointer is not
//   16-byte aligned), and draws the block's keep bits while the copies are
//   in flight. It forms all L x L scores at once in registers: 4 x 4 tiles
//   whose rows and columns are 16 apart (8 float4 loads for 64 FMAs; the 16
//   lanes of a half warp read 16 consecutive k rows, which a row stride of
//   an odd number of float4s puts in distinct banks), so that a row lies
//   with the 16 lanes of a half warp and its max and sum are four shuffles
//   each: an exact softmax, no online rescale, no pass over the scores in
//   shared memory. The backward is one kernel: it recomputes P, forms dp,
//   t = rowsum(dp P) the same way (so it reads neither o nor any statistics
//   of the forward), dS, and the three L x hd products; each output element
//   is written by the block of its (sequence, head): no atomics, two runs
//   give the same bits. The L x hd products run on 4 x CW register tiles
//   (CW = 2 up to hd 32, else 4: at most one shared load for two FMAs).
//   Causal: a pair of 16-row bands above the diagonal is not computed, and
//   the L x hd products stop their depth at the diagonal, except for the
//   rows with no valid key (a prefix of the sequence, uniform over all L
//   keys). At SASRec's shape (L 50, hd 32) a block takes 36,832 bytes
//   forward and 55,136 backward, and the register bounds (64 forward, 85
//   backward) let an SM hold 4 forward or 3 backward blocks. fp32 on the
//   CUDA cores throughout: the TF32 tensor cores would move the result away
//   from the fp32 plain version unless split into hi + lo terms, and the
//   products are a fraction of the bytes' time.
// * Key-tiled, any L (and any hd the whole route does not hold): tiles of
//   kT = 32 queries and 32 keys, so that shared memory holds tiles only, and
//   hd in chunks of at most kHc = 128 columns (a grid dimension over the
//   output's chunks; the scores and dO v^T summed over every chunk). The
//   forward takes a block of 128 threads per (sequence, head, query tile,
//   output chunk) and streams the key tiles with an online softmax (running
//   row max m and row sum l, the accumulator rescaled when m grows), then
//   writes o and the rows' m and l. The backward recomputes each score tile
//   from q, k and the saved m and l (P = exp(s - m) / l; m and l are kept
//   apart because -1e9 + log l rounds back to -1e9 in fp32): one kernel per
//   (sequence, head, query tile, chunk) writes dq and t = dO . o over the key
//   tiles, then one per (sequence, head, key tile, chunk) writes dk and dv
//   over the query tiles. No atomics here either. Causal: a key tile
//   entirely after a query tile is skipped for rows that have a valid key
//   (masked_tile). Tile rows are padded by one float so that reads along keys
//   are free of bank conflicts; tiles arrive by 16-byte loads where hd
//   allows. Keys beyond L take no part (an exact zero weight), unlike masked
//   keys, which keep the -1e9 score and its reference semantics.
//
// Dropout: Philox4x32-10 keyed by the seed (one int64 drawn on the device
// from the caller's generator) and counted by (element / 4, sequence, head,
// layer) with element = i L + j, the scheme of csrc/trm_layer.cu (its
// attention sites): the same bits in the forward and the backward, whatever
// block or tile draws them. Each call of the generator serves the four
// elements of its aligned group (whole route: a thread per group; tiled
// route: the groups that cover a tile's rows, into a bit mask). The Philox
// rounds below are a copy of that source's. fused_attention_dropout_masks
// writes the keep masks out for the plain version.
//
// Limits: any B, H (B H blocks on the grid's x axis) and hd; L up to 46,340
// (the element counter is 32 bits).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by recbole_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr size_t kSmemOptin = 232448;  // opt-in shared memory of a Hopper block
constexpr int kMaxL = 46340;           // L L fits the 32-bit element counter

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
  // the four words of aligned group g (elements 4 g .. 4 g + 3) of (sequence
  // b, head h); element 4 g + c is kept when word c >= thr
  __device__ __forceinline__ U4 group(unsigned g, int b, int h) const {
    return philox4x32_10(g, (unsigned)b, (unsigned)h, layer, k0, k1);
  }
  // keep (1) or drop (0) element e of (sequence b, head h)
  __device__ __forceinline__ bool keep(int e, int b, int h) const {
    return group((unsigned)e >> 2, b, h).v[e & 3] >= thr;
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
  int vec;     // 16-byte global accesses: hd % 4 == 0 and every pointer 16-byte aligned
  int C, nch;  // key-tiled route: the hd chunk a tile holds, and the chunks of hd
};

__device__ __forceinline__ size_t slice_at(const Shape& sh, int b, int h, int l, int d) {
  return (((size_t)b * sh.L + l) * sh.H + h) * sh.hd + d;
}

__device__ __forceinline__ bool visible(const int* valid, const Shape& sh, int qi, int kj) {
  return valid[kj] > 0 && (!sh.causal || kj <= qi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ================================================= whole-sequence route

constexpr int kWholeMaxL = 64;
constexpr int kWT = 256;  // threads of a whole-sequence block

// n rounded up to a multiple of 4 whose count of float4s is odd: a row
// stride at which 8 consecutive rows read as float4 fall in distinct banks
__host__ __device__ inline int odd_quads(int n) { return 4 * (((n + 3) / 4) | 1); }

// The layout of a whole-sequence block: Lr = L rounded up to 4 rows of the q,
// k, v (dO) slabs at stride s, the L x L matrices (P; dS in the backward) at
// stride sp, Lr valid flags (and 4 ints of padding), 64 keep bytes a row.
struct Whole {
  int Lr, s, sp, hd4;
};

__host__ __device__ inline Whole whole_layout(int L, int hd) {
  Whole w;
  w.Lr = (L + 3) & ~3;
  w.hd4 = (hd + 3) & ~3;
  w.s = odd_quads(hd);
  w.sp = odd_quads(w.Lr);
  return w;
}

inline size_t whole_bytes(int L, int hd, bool backward) {
  const Whole w = whole_layout(L, hd);
  const size_t floats = (size_t)(backward ? 4 : 3) * w.Lr * w.s +
                        (size_t)(backward ? 2 : 1) * w.Lr * w.sp;
  return sizeof(float) * floats + sizeof(int) * ((size_t)w.Lr + 4) + (size_t)64 * w.Lr;
}

// the width of the L x hd products' micro-tiles
inline int whole_cw(int hd) { return ((hd + 3) & ~3) <= 32 ? 2 : 4; }

// rows l < L of head h of a (B, L, H, hd) tensor into dst rows of w.s floats
// by cp.async (16 bytes a copy when sh.vec, else 4); columns hd .. s - 1 and
// rows L .. Lr - 1 are zeroed (the products read them)
__device__ void whole_load(float* dst, const float* __restrict__ src, const Shape& sh,
                           const Whole& w, int b, int h) {
  const int L = sh.L, hd = sh.hd, tid = threadIdx.x;
  const float* base = src + slice_at(sh, b, h, 0, 0);
  const size_t stride = (size_t)sh.H * hd;
  // n copies a row: hd / 4 of 16 bytes, or hd of 4; up to kWT of them, a
  // thread copies one column of every (kWT / n)-th row (one division)
  const int n = sh.vec ? hd >> 2 : hd, z = sh.vec ? 4 : 1;
  if (n <= kWT) {
    const int step = kWT / n, l0 = tid / n, c = (tid - l0 * n) * z;
    if (l0 < step)
      for (int l = l0; l < L; l += step) {
        if (sh.vec) cp_async16(dst + l * w.s + c, base + l * stride + c);
        else cp_async4(dst + l * w.s + c, base + l * stride + c);
      }
  } else {
    for (int i = tid; i < L * n; i += kWT) {
      const int l = i / n, c = (i - l * n) * z;
      if (sh.vec) cp_async16(dst + l * w.s + c, base + l * stride + c);
      else cp_async4(dst + l * w.s + c, base + l * stride + c);
    }
  }
  // zeros: columns hd .. s - 1 of the rows < L (at most 8 a row), all of rows L .. Lr - 1
  const int pad = w.s - hd, r = tid >> 3, d = tid & 7;
  if (d < pad)
    for (int l = r; l < L; l += kWT / 8) dst[l * w.s + hd + d] = 0.0f;
  for (int i = tid; i < (w.Lr - L) * w.s; i += kWT) dst[L * w.s + i] = 0.0f;
}

// The keep byte of element (i, j) in keep8. Row i holds 64 bytes in the
// order the score threads read them: column j = tj + 16 c at 4 tj + c, so
// thread (ti, tj) reads its four columns of a row as one 32-bit word.
__device__ __forceinline__ int keep_at(int i, int j) { return 64 * i + 4 * (j & 15) + (j >> 4); }

// The first valid key e0 (L if none), by every warp from two loads a lane
// and two ballots; warp 0 also writes the key flags vf[j] (0 past L). In a
// causal block the rows i < e0 are those with no visible key.
__device__ int whole_valid(int* vf, const int* __restrict__ key_valid, const Shape& sh,
                           const Whole& w, int b) {
  const int lane = threadIdx.x & 31, L = sh.L;
  const int* valid = key_valid + (size_t)b * L;
  const bool v0 = lane < L && valid[lane] > 0, v1 = lane + 32 < L && valid[lane + 32] > 0;
  const unsigned m0 = __ballot_sync(0xffffffffu, v0), m1 = __ballot_sync(0xffffffffu, v1);
  if (threadIdx.x < 32) {
    if (lane < w.Lr) vf[lane] = v0;
    if (lane + 32 < w.Lr) vf[lane + 32] = v1;
  }
  return m0 ? __ffs(m0) - 1 : (m1 ? 31 + __ffs(m1) : L);
}

// The scores and the softmax, in registers. Thread (ti, tj) = (tid / 16,
// tid % 16) owns the pairs of rows ti + 16 a and columns tj + 16 c (a, c <
// 4): it forms s = q_i . k_j scale where key j is visible from query i (-1e9
// where it is not), and with GRAD also dO_i . v_j; causal, a band pair c > a
// lies above the diagonal and is not computed. The operands are read as
// float4 along d: 8 (16) shared loads for 64 (128) FMAs; the 16 lanes of a
// half warp read 16 consecutive k rows, which a row stride of an odd number
// of float4s puts in distinct banks. A row's 64 columns lie with the 16
// lanes of a half warp, so its max, its sum and (GRAD) t = rowsum(dp P) are
// four shuffles each. Out: Pb = P keep / (1 - rate) (Pd) and, with GRAD,
// Gb = dS = P (dp - t) scale where visible, dp = dO v^T keep / (1 - rate);
// both 0 in the columns L .. Lr - 1 of rows i < L (the rows past L are never
// read into a stored output).
template <bool CAUSAL, bool GRAD>
__device__ void whole_scores(const Shape& sh, const Whole& w, const Drop& drop, const float* Qs,
                             const float* Ks, const float* dOs, const float* Vs, const int* vf,
                             const unsigned char* keep8, float* Pb, float* Gb) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15, L = sh.L;
  float sa[4][4], ga[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) sa[a][c] = ga[a][c] = 0.0f;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // the 4 x 4 pairs of A B^T over one float4 of d, into acc
  auto pairs4 = [&](const float* A, const float* Bm, int d, float acc[4][4]) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 16 * a, j = tj + 16 * a;
      x[a] = i < L ? ld4(A + i * w.s + d) : zero;
      y[a] = j < L ? ld4(Bm + j * w.s + d) : zero;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (CAUSAL && c > a) continue;
        if (ti + 16 * a >= L || tj + 16 * c >= L) continue;
        acc[a][c] = dot4(x[a], y[c], acc[a][c]);
      }
  };
  for (int d = 0; d < w.hd4; d += 4) {
    pairs4(Qs, Ks, d, sa);
    if (GRAD) pairs4(dOs, Vs, d, ga);
  }
  const float dscale = drop.on ? drop.inv : 1.0f, log2e = 1.4426950408889634f;
  bool key[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) key[c] = tj + 16 * c < L && vf[tj + 16 * c];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + 16 * a;
    if ((ti & ~1) + 16 * a >= L) continue;  // both rows of the warp past L (warp-uniform)
    // the scores in units of log2 e, so that the exponential is exp2f
    float s[4], p[4];
    bool vis[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c;
      vis[c] = i < L && key[c] && (!CAUSAL || j <= i);
      s[c] = vis[c] ? sa[a][c] * sh.scale * log2e : (i < L && j < L ? kNeg * log2e : -INFINITY);
    }
    float m = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
#pragma unroll
    for (int o = 8; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[c] = m == -INFINITY ? 0.0f : exp2f(s[c] - m);
      l += p[c];
    }
#pragma unroll
    for (int o = 8; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    const float inv_l = i < L ? 1.0f / l : 0.0f;
    const unsigned kw =
        drop.on && i < L ? *reinterpret_cast<const unsigned*>(keep8 + keep_at(i, tj)) : ~0u;
    float pd[4], dp[4], t = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c;
      p[c] *= inv_l;
      const bool kept = j < L && ((kw >> (8 * c)) & 0xffu);
      pd[c] = kept ? p[c] * dscale : 0.0f;
      if (GRAD) {
        dp[c] = kept && vis[c] ? ga[a][c] * dscale : 0.0f;
        t = fmaf(dp[c], p[c], t);
      }
    }
    if (GRAD) {
#pragma unroll
      for (int o = 8; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    }
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c;
      if (j >= w.Lr) continue;
      Pb[i * w.sp + j] = pd[c];
      if (GRAD) Gb[i * w.sp + j] = vis[c] ? p[c] * (dp[c] - t) * sh.scale : 0.0f;
    }
  }
}

// Whether element e = i L + j is kept: a thread per aligned group of four
// (one Philox call each). Causal: an element above the diagonal of a row
// with a visible key has P = 0 whatever its bit, and a group of four such
// draws nothing (its bytes stay unwritten).
template <bool CAUSAL>
__device__ void whole_keep_bits(const Shape& sh, const Whole& w, const Drop& drop, int b, int h,
                                int e0, unsigned char* keep8) {
  const int L = sh.L, n = L * L, groups = (n + 3) >> 2;
  for (int g = threadIdx.x; g < groups; g += kWT) {
    const int e = g << 2, i0 = e / L, j0 = e - i0 * L;
    bool need = !CAUSAL;
    if (CAUSAL) {
      int i = i0, j = j0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (e + c < n && (j <= i || i < e0)) need = true;
        if (++j == L) {
          j = 0;
          ++i;
        }
      }
    }
    if (!need) continue;
    const U4 bits = drop.group((unsigned)g, b, h);
    int i = i0, j = j0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (e + c < n) keep8[keep_at(i, j)] = bits.v[c] >= drop.thr;
      if (++j == L) {
        j = 0;
        ++i;
      }
    }
  }
}

template <int CW>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void ld(const float* p, float* v) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
  __device__ static void st(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void ld(const float* p, float* v) {
    const float4 x = ld4(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static void st(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// acc[r][c] = sum over j < j1 (a multiple of 4) of A[4 q + r][j] B[j][c0 + c]:
// per 4 j, 4 float4 loads of A and 4 CW-wide loads of B for 16 CW FMAs
template <int CW>
__device__ __forceinline__ void row_product(const float* A, int sa, const float* Bm, int sb,
                                            int q, int c0, int j1, float acc[4][CW]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.0f;
  for (int j = 0; j < j1; j += 4) {
    float4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (4 * q + r) * sa + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bv[CW];
      Vec<CW>::ld(Bm + (j + u) * sb + c0, bv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = u == 0 ? a[r].x : u == 1 ? a[r].y : u == 2 ? a[r].z : a[r].w;
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(x, bv[c], acc[r][c]);
      }
    }
  }
}

// acc[r][c] = sum over i in [i0, i1) of A[i][4 q + r] B[i][c0 + c]: per i one
// float4 of A (the four output rows at once) and one CW-wide load of B
template <int CW>
__device__ __forceinline__ void col_product(const float* A, int sa, const float* Bm, int sb,
                                            int q, int c0, int i0, int i1, float acc[4][CW]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const float4 a = ld4(A + i * sa + 4 * q);
    float bv[CW];
    Vec<CW>::ld(Bm + i * sb + c0, bv);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// rows 4 q .. 4 q + 3 (those < L), columns c0 .. c0 + CW - 1 (those < hd) of
// head h of a (B, L, H, hd) output
template <int CW>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const Shape& sh, int b, int h,
                                           int q, int c0, const float acc[4][CW]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * q + r;
    if (i >= sh.L) break;
    float* p = dst + slice_at(sh, b, h, i, c0);
    if (sh.vec) {
      Vec<CW>::st(p, acc[r]);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (c0 + c < sh.hd) p[c] = acc[r][c];
    }
  }
}

template <bool CAUSAL, int CW>
__global__ void __launch_bounds__(kWT, 4)
fused_attention_whole_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ key_valid,
                                 const long long* __restrict__ seed, Shape sh, Whole w,
                                 float* __restrict__ o) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + w.Lr * w.s;
  float* Vs = Ks + w.Lr * w.s;
  float* Pb = Vs + w.Lr * w.s;
  int* vf = reinterpret_cast<int*>(Pb + w.Lr * w.sp);
  unsigned char* keep8 = reinterpret_cast<unsigned char*>(vf + w.Lr + 4);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H;
  whole_load(Qs, q, sh, w, b, h);
  whole_load(Ks, k, sh, w, b, h);
  cp_async_commit();
  whole_load(Vs, v, sh, w, b, h);
  cp_async_commit();
  // the keep bits while the copies are in flight
  const int e0 = whole_valid(vf, key_valid, sh, w, b);
  const Drop drop = make_drop(seed, sh.rate, sh.layer);
  if (drop.on) whole_keep_bits<CAUSAL>(sh, w, drop, b, h, e0, keep8);
  cp_async_wait<1>();
  __syncthreads();
  whole_scores<CAUSAL, false>(sh, w, drop, Qs, Ks, nullptr, nullptr, vf, keep8, Pb, nullptr);
  cp_async_wait<0>();
  __syncthreads();
  // o = Pd v: a task per (4 rows, CW columns); causal rows with a visible key
  // stop at the diagonal
  const int nc = w.hd4 / CW, tasks = (w.Lr / 4) * nc;
  for (int t = threadIdx.x; t < tasks; t += kWT) {
    const int qq = t / nc, c0 = (t - qq * nc) * CW;
    const int j1 = CAUSAL && e0 <= 4 * qq ? min(w.Lr, 4 * qq + 4) : w.Lr;
    float acc[4][CW];
    row_product<CW>(Pb, w.sp, Vs, w.s, qq, c0, j1, acc);
    store_rows<CW>(o, sh, b, h, qq, c0, acc);
  }
}

template <bool CAUSAL, int CW>
__global__ void __launch_bounds__(kWT, 3)
fused_attention_whole_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ key_valid,
                                 const long long* __restrict__ seed, Shape sh, Whole w,
                                 const float* __restrict__ dout, float* __restrict__ dq,
                                 float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + w.Lr * w.s;
  float* Vs = Ks + w.Lr * w.s;
  float* dOs = Vs + w.Lr * w.s;
  float* Pb = dOs + w.Lr * w.s;
  float* Gb = Pb + w.Lr * w.sp;
  int* vf = reinterpret_cast<int*>(Gb + w.Lr * w.sp);
  unsigned char* keep8 = reinterpret_cast<unsigned char*>(vf + w.Lr + 4);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H;
  whole_load(Qs, q, sh, w, b, h);
  whole_load(Ks, k, sh, w, b, h);
  whole_load(Vs, v, sh, w, b, h);
  whole_load(dOs, dout, sh, w, b, h);
  cp_async_commit();
  // the keep bits while the copies are in flight
  const int e0 = whole_valid(vf, key_valid, sh, w, b);
  const Drop drop = make_drop(seed, sh.rate, sh.layer);
  if (drop.on) whole_keep_bits<CAUSAL>(sh, w, drop, b, h, e0, keep8);
  cp_async_wait<0>();
  __syncthreads();
  whole_scores<CAUSAL, true>(sh, w, drop, Qs, Ks, dOs, Vs, vf, keep8, Pb, Gb);
  __syncthreads();
  // dq = dS k (rows i; causal, dS is 0 past the diagonal and in the rows
  // with no visible key), dk = dS^T q (rows j; causal, depth i >= j), dv =
  // Pd^T dO (rows j; depth i >= j, and every i when some rows have no
  // visible key: their Pd is uniform)
  const int nc = w.hd4 / CW, per = (w.Lr / 4) * nc;
  for (int t = threadIdx.x; t < 3 * per; t += kWT) {
    const int which = t / per, u = t - which * per, qq = u / nc, c0 = (u - qq * nc) * CW;
    float acc[4][CW];
    if (which == 0) {
      row_product<CW>(Gb, w.sp, Ks, w.s, qq, c0, CAUSAL ? min(w.Lr, 4 * qq + 4) : w.Lr, acc);
      store_rows<CW>(dq, sh, b, h, qq, c0, acc);
    } else if (which == 1) {
      col_product<CW>(Gb, w.sp, Qs, w.s, qq, c0, CAUSAL ? 4 * qq : 0, sh.L, acc);
      store_rows<CW>(dk, sh, b, h, qq, c0, acc);
    } else {
      col_product<CW>(Pb, w.sp, dOs, w.s, qq, c0, CAUSAL && e0 == 0 ? 4 * qq : 0, sh.L, acc);
      store_rows<CW>(dv, sh, b, h, qq, c0, acc);
    }
  }
}

// ======================================================= key-tiled route

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;       // queries and keys of a tile (one key a lane)
constexpr int kTS = kT + 1;  // the row stride of a score tile
constexpr int kHc = 128;     // the widest chunk of hd a tile holds
constexpr int kGroupsRow = 9;  // aligned groups of 4 that cover 32 keys of a row

// columns c0 .. c0 + wd - 1 of rows r0 .. r0 + kT - 1 of the (L, hd) slice of
// (sequence b, head h) into shared rows of C + 1 floats; rows past L are zero.
// 16-byte loads when sh.vec (wd and c0 are then multiples of 4).
__device__ void load_tile(float* dst, const float* __restrict__ src, const Shape& sh, int b,
                          int h, int r0, int c0, int wd) {
  const int LD = sh.C + 1;
  if (sh.vec) {
    const int q = wd >> 2;
    for (int i = threadIdx.x; i < kT * q; i += blockDim.x) {
      const int l = i / q, d = (i - l * q) << 2, row = r0 + l;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < sh.L) x = __ldg(reinterpret_cast<const float4*>(src + slice_at(sh, b, h, row, c0 + d)));
      float* p = dst + l * LD + d;
      p[0] = x.x;
      p[1] = x.y;
      p[2] = x.z;
      p[3] = x.w;
    }
  } else {
    for (int i = threadIdx.x; i < kT * wd; i += blockDim.x) {
      const int l = i / wd, d = i - l * wd, row = r0 + l;
      dst[l * LD + d] = row < sh.L ? src[slice_at(sh, b, h, row, c0 + d)] : 0.0f;
    }
  }
}

// the columns of chunk c of hd: [c C, c C + width)
__device__ __forceinline__ int chunk_width(const Shape& sh, int c) {
  return min(sh.C, sh.hd - c * sh.C);
}

// S[i][j] (+)= q_i . k_j over one chunk of wd columns (first: =) for the
// visible pairs of query i0 + i and key j0 + j; with last, S becomes the
// score: scaled where visible, -1e9 where masked, -inf where the query or the
// key lies past L
__device__ void score_tile(float* S, const float* qs, const float* ks, const int* valid,
                           const Shape& sh, int i0, int j0, int wd, bool first, bool last) {
  const int LD = sh.C + 1;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) {
    const int i = e / kT, j = e - i * kT, qi = i0 + i, kj = j0 + j;
    const bool in = qi < sh.L && kj < sh.L, vis = in && visible(valid, sh, qi, kj);
    float a = first ? 0.0f : S[i * kTS + j];
    if (vis)
      for (int d = 0; d < wd; ++d) a = fmaf(qs[i * LD + d], ks[j * LD + d], a);
    if (last) a = vis ? a * sh.scale : (in ? kNeg : -INFINITY);
    S[i * kTS + j] = a;
  }
}

// G[i][j] (+)= a_i . b_j over one chunk for the visible pairs (the others
// are never read)
__device__ void dot_tile(float* G, const float* as, const float* bs, const int* valid,
                         const Shape& sh, int i0, int j0, int wd, bool first) {
  const int LD = sh.C + 1;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) {
    const int i = e / kT, j = e - i * kT, qi = i0 + i, kj = j0 + j;
    float a = first ? 0.0f : G[i * kTS + j];
    if (qi < sh.L && kj < sh.L && visible(valid, sh, qi, kj))
      for (int d = 0; d < wd; ++d) a = fmaf(as[i * LD + d], bs[j * LD + d], a);
    G[i * kTS + j] = a;
  }
}

// kb[i] bit j: whether element (i0 + i, j0 + j) of (b, h) is kept, from one
// Philox call per aligned group of 4 flat elements e = row L + key (at most
// kGroupsRow groups cover a row's 32 keys). kb is zeroed before the barrier
// that precedes this call.
__device__ void tile_keep_bits(unsigned* kb, const Shape& sh, const Drop& drop, int b, int h,
                               int i0, int j0) {
  const int L = sh.L, nj = min(kT, L - j0);
  for (int t = threadIdx.x; t < kT * kGroupsRow; t += blockDim.x) {
    const int i = t / kGroupsRow, qi = i0 + i;
    if (qi >= L) continue;
    const int lo = qi * L + j0, g = (lo >> 2) + (t - i * kGroupsRow);
    if (4 * g >= lo + nj) continue;
    const U4 bits = drop.group((unsigned)g, b, h);
    unsigned m = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * g + c - lo;
      if (j >= 0 && j < nj && bits.v[c] >= drop.thr) m |= 1u << j;
    }
    if (m) atomicOr(kb + i, m);
  }
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
  const int L = sh.L, LD = sh.C + 1;
  float* qs = smem;
  float* ks = qs + kT * LD;
  float* vs = ks + kT * LD;
  float* acc = vs + kT * LD;
  float* S = acc + kT * LD;
  float* m = S + kT * kTS;
  float* l = m + kT;
  float* corr = l + kT;
  unsigned* kb = reinterpret_cast<unsigned*>(corr + kT);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, i0 = blockIdx.y * kT;
  const int co = blockIdx.z, wo = chunk_width(sh, co), last = sh.nch - 1;
  const bool one = sh.nch == 1;  // q's tile stays; else every chunk is loaded in turn
  const int* valid = key_valid + (size_t)b * L;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  if (one) load_tile(qs, q, sh, b, h, i0, 0, sh.hd);
  for (int e = threadIdx.x; e < kT * LD; e += blockDim.x) acc[e] = 0.0f;
  for (int i = threadIdx.x; i < kT; i += blockDim.x) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  for (int j0 = 0; j0 < L; j0 += kT) {
    if (masked_tile(sh, i0, j0, [&](int i) { return m[i]; })) break;  // and every later tile
    if (drop.on && threadIdx.x < kT) kb[threadIdx.x] = 0u;
    for (int c = 0; c <= last; ++c) {
      const int wd = chunk_width(sh, c);
      if (!one) load_tile(qs, q, sh, b, h, i0, c * sh.C, wd);
      load_tile(ks, k, sh, b, h, j0, c * sh.C, wd);
      if (c == last) load_tile(vs, v, sh, b, h, j0, co * sh.C, wo);
      __syncthreads();
      if (c == 0 && drop.on) tile_keep_bits(kb, sh, drop, b, h, i0, j0);
      score_tile(S, qs, ks, valid, sh, i0, j0, wd, c == 0, c == last);
      __syncthreads();
    }
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
        p = (kb[i] >> lane) & 1u ? p * drop.inv : 0.0f;
      S[i * kTS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float cr = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        corr[i] = cr;
        l[i] = l[i] * cr + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kT * wo; e += blockDim.x) {
      const int i = e / wo, d = e - i * wo;
      float a = acc[i * LD + d] * corr[i];
      for (int j = 0; j < kT; ++j) a = fmaf(S[i * kTS + j], vs[j * LD + d], a);
      acc[i * LD + d] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kT * wo; e += blockDim.x) {
    const int i = e / wo, d = e - i * wo;
    if (i0 + i < L) o[slice_at(sh, b, h, i0 + i, co * sh.C + d)] = acc[i * LD + d] / l[i];
  }
  if (co == 0) {
    const size_t row0 = ((size_t)b * sh.H + h) * L;
    for (int i = threadIdx.x; i < kT; i += blockDim.x)
      if (i0 + i < L) {
        stats[2 * (row0 + i0 + i)] = m[i];
        stats[2 * (row0 + i0 + i) + 1] = l[i];
      }
  }
}

// P and dS of one (query tile, key tile) pair: P (dropped: Pd) into Pt and
// dS into G, which holds dO . v on entry. ms, ls, ts: the query rows' m, l
// and t = dO . o; kb: the tile's keep bits.
__device__ void prob_grad_tile(float* Pt, float* G, const float* ms, const float* ls,
                               const float* ts, const unsigned* kb, const int* valid,
                               const Shape& sh, const Drop& drop, int i0, int j0) {
  const int L = sh.L;
  for (int e = threadIdx.x; e < kT * kT; e += blockDim.x) {
    const int i = e / kT, j = e - i * kT, qi = i0 + i, kj = j0 + j;
    float p = 0.0f, ds = 0.0f;
    if (qi < L && kj < L) {
      p = expf(Pt[i * kTS + j] - ms[i]) / ls[i];
      const bool keep = !drop.on || ((kb[i] >> j) & 1u);
      const float dp = keep ? G[i * kTS + j] * (drop.on ? drop.inv : 1.0f) : 0.0f;
      if (visible(valid, sh, qi, kj)) ds = p * (dp - ts[i]) * sh.scale;
      p = keep ? p * (drop.on ? drop.inv : 1.0f) : 0.0f;
    }
    Pt[i * kTS + j] = p;
    G[i * kTS + j] = ds;
  }
}

// the query rows' m, l (from the forward) and t = dO . o over all of hd, for
// rows i0 ..
__device__ void load_row_stats(float* ms, float* ls, float* ts, const float* __restrict__ stats,
                               const float* __restrict__ o, const float* __restrict__ dout,
                               const Shape& sh, int b, int h, int i0) {
  const size_t row0 = ((size_t)b * sh.H + h) * sh.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < kT; i += kWarps) {
    const int qi = i0 + i;
    float t = 0.0f;
    if (qi < sh.L)
      for (int d = lane; d < sh.hd; d += 32) {
        const size_t at = slice_at(sh, b, h, qi, d);
        t = fmaf(dout[at], o[at], t);
      }
    for (int w = 16; w; w >>= 1) t += __shfl_xor_sync(0xffffffffu, t, w);
    if (lane == 0) {
      ts[i] = t;
      ms[i] = qi < sh.L ? stats[2 * (row0 + qi)] : 0.0f;
      ls[i] = qi < sh.L ? stats[2 * (row0 + qi) + 1] : 1.0f;
    }
  }
}

// dq of one (sequence, head, query tile, chunk), over the key tiles
__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ key_valid,
                              const long long* __restrict__ seed, Shape sh,
                              const float* __restrict__ o, const float* __restrict__ stats,
                              const float* __restrict__ dout, float* __restrict__ dq) {
  extern __shared__ float smem[];
  const int L = sh.L, LD = sh.C + 1;
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
  unsigned* kb = reinterpret_cast<unsigned*>(ts + kT);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, i0 = blockIdx.y * kT;
  const int co = blockIdx.z, wo = chunk_width(sh, co), last = sh.nch - 1;
  const bool one = sh.nch == 1;
  const int* valid = key_valid + (size_t)b * L;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  if (one) {
    load_tile(qs, q, sh, b, h, i0, 0, sh.hd);
    load_tile(dos, dout, sh, b, h, i0, 0, sh.hd);
  }
  for (int e = threadIdx.x; e < kT * LD; e += blockDim.x) acc[e] = 0.0f;
  load_row_stats(ms, ls, ts, stats, o, dout, sh, b, h, i0);
  __syncthreads();
  const size_t row0 = ((size_t)b * sh.H + h) * L;
  for (int j0 = 0; j0 < L; j0 += kT) {
    if (masked_tile(sh, i0, j0, [&](int i) { return stats[2 * (row0 + i0 + i)]; })) break;
    if (drop.on && threadIdx.x < kT) kb[threadIdx.x] = 0u;
    for (int c = 0; c <= last; ++c) {
      const int wd = chunk_width(sh, c), c0 = c * sh.C;
      if (!one) {
        load_tile(qs, q, sh, b, h, i0, c0, wd);
        load_tile(dos, dout, sh, b, h, i0, c0, wd);
      }
      load_tile(ks, k, sh, b, h, j0, c0, wd);
      load_tile(vs, v, sh, b, h, j0, c0, wd);
      __syncthreads();
      if (c == 0 && drop.on) tile_keep_bits(kb, sh, drop, b, h, i0, j0);
      score_tile(Pt, qs, ks, valid, sh, i0, j0, wd, c == 0, c == last);
      dot_tile(G, dos, vs, valid, sh, i0, j0, wd, c == 0);
      __syncthreads();
    }
    prob_grad_tile(Pt, G, ms, ls, ts, kb, valid, sh, drop, i0, j0);
    if (co != last) load_tile(ks, k, sh, b, h, j0, co * sh.C, wo);
    __syncthreads();
    for (int e = threadIdx.x; e < kT * wo; e += blockDim.x) {
      const int i = e / wo, d = e - i * wo;
      float a = acc[i * LD + d];
      for (int j = 0; j < kT; ++j) a = fmaf(G[i * kTS + j], ks[j * LD + d], a);
      acc[i * LD + d] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kT * wo; e += blockDim.x) {
    const int i = e / wo, d = e - i * wo;
    if (i0 + i < L) dq[slice_at(sh, b, h, i0 + i, co * sh.C + d)] = acc[i * LD + d];
  }
}

// dk and dv of one (sequence, head, key tile, chunk), over the query tiles
__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const int* __restrict__ key_valid,
                                const long long* __restrict__ seed, Shape sh,
                                const float* __restrict__ o, const float* __restrict__ stats,
                                const float* __restrict__ dout, float* __restrict__ dk,
                                float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int L = sh.L, LD = sh.C + 1;
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
  unsigned* kb = reinterpret_cast<unsigned*>(ts + kT);
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H, j0 = blockIdx.y * kT;
  const int co = blockIdx.z, wo = chunk_width(sh, co), last = sh.nch - 1;
  const bool one = sh.nch == 1;
  const int* valid = key_valid + (size_t)b * L;
  const Drop drop = make_drop(seed, sh.rate, sh.layer);

  if (one) {
    load_tile(ks, k, sh, b, h, j0, 0, sh.hd);
    load_tile(vs, v, sh, b, h, j0, 0, sh.hd);
  }
  for (int e = threadIdx.x; e < kT * LD; e += blockDim.x) dka[e] = dva[e] = 0.0f;
  const size_t row0 = ((size_t)b * sh.H + h) * L;
  for (int i0 = 0; i0 < L; i0 += kT) {
    if (masked_tile(sh, i0, j0, [&](int i) { return stats[2 * (row0 + i0 + i)]; })) continue;
    if (drop.on && threadIdx.x < kT) kb[threadIdx.x] = 0u;
    for (int c = 0; c <= last; ++c) {
      const int wd = chunk_width(sh, c), c0 = c * sh.C;
      if (!one) {
        load_tile(ks, k, sh, b, h, j0, c0, wd);
        load_tile(vs, v, sh, b, h, j0, c0, wd);
      }
      load_tile(qs, q, sh, b, h, i0, c0, wd);
      load_tile(dos, dout, sh, b, h, i0, c0, wd);
      __syncthreads();
      if (c == 0) {
        if (drop.on) tile_keep_bits(kb, sh, drop, b, h, i0, j0);
        load_row_stats(ms, ls, ts, stats, o, dout, sh, b, h, i0);
      }
      score_tile(Pt, qs, ks, valid, sh, i0, j0, wd, c == 0, c == last);
      dot_tile(G, dos, vs, valid, sh, i0, j0, wd, c == 0);
      __syncthreads();
    }
    prob_grad_tile(Pt, G, ms, ls, ts, kb, valid, sh, drop, i0, j0);
    if (co != last) {
      load_tile(qs, q, sh, b, h, i0, co * sh.C, wo);
      load_tile(dos, dout, sh, b, h, i0, co * sh.C, wo);
    }
    __syncthreads();
    // the key rows j: dk_j += sum_i dS_ij q_i, dv_j += sum_i Pd_ij dO_i
    for (int e = threadIdx.x; e < kT * wo; e += blockDim.x) {
      const int j = e / wo, d = e - j * wo;
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
  for (int e = threadIdx.x; e < kT * wo; e += blockDim.x) {
    const int j = e / wo, d = e - j * wo;
    if (j0 + j < L) {
      const size_t at = slice_at(sh, b, h, j0 + j, co * sh.C + d);
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

// ------------------------------------------------------------------- launch

enum Route { kRouteWhole = 0, kRouteTiled = 1 };

inline Route route_of(int L, int hd) {
  return L <= kWholeMaxL && whole_bytes(L, hd, true) <= kSmemOptin ? kRouteWhole : kRouteTiled;
}

// shared-memory floats of the tiled forward, dq and dk-dv kernels (chunk C)
inline int tile_chunk(int hd) { return hd < kHc ? hd : kHc; }
size_t fwd_floats(int hd) { return (size_t)4 * kT * (tile_chunk(hd) + 1) + kT * kTS + 4 * kT; }
size_t dq_floats(int hd) { return (size_t)5 * kT * (tile_chunk(hd) + 1) + 2 * kT * kTS + 4 * kT; }
size_t dkdv_floats(int hd) {
  return (size_t)6 * kT * (tile_chunk(hd) + 1) + 2 * kT * kTS + 4 * kT;
}

// the bytes a block of the route's kernel takes (the tiled backward: its
// larger kernel, dk-dv)
size_t smem_bytes(int L, int hd, bool backward) {
  if (route_of(L, hd) == kRouteWhole) return whole_bytes(L, hd, backward);
  return sizeof(float) * (backward ? dkdv_floats(hd) : fwd_floats(hd));
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int make_shape(int B, int L, int H, int hd, int causal, float scale, float rate, int layer,
               bool vec, Shape* sh) {
  if (B < 1 || L < 1 || L > kMaxL || H < 1 || hd < 1 || rate < 0.0f || rate >= 1.0f ||
      (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  sh->B = B; sh->L = L; sh->H = H; sh->hd = hd; sh->causal = causal; sh->layer = layer;
  sh->scale = scale; sh->rate = rate;
  sh->vec = vec && hd % 4 == 0;
  sh->C = tile_chunk(hd);
  sh->nch = (hd + kHc - 1) / kHc;
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

typedef void (*WholeFwdK)(const float*, const float*, const float*, const int*, const long long*,
                          Shape, Whole, float*);
typedef void (*WholeBwdK)(const float*, const float*, const float*, const int*, const long long*,
                          Shape, Whole, const float*, float*, float*, float*);

WholeFwdK whole_fwd_kernel(bool causal, int cw) {
  if (causal) return cw == 2 ? fused_attention_whole_fwd_kernel<true, 2>
                             : fused_attention_whole_fwd_kernel<true, 4>;
  return cw == 2 ? fused_attention_whole_fwd_kernel<false, 2>
                 : fused_attention_whole_fwd_kernel<false, 4>;
}

WholeBwdK whole_bwd_kernel(bool causal, int cw) {
  if (causal) return cw == 2 ? fused_attention_whole_bwd_kernel<true, 2>
                             : fused_attention_whole_bwd_kernel<true, 4>;
  return cw == 2 ? fused_attention_whole_bwd_kernel<false, 2>
                 : fused_attention_whole_bwd_kernel<false, 4>;
}

// the kernel a call of the route launches (the tiled backward: dk-dv, the
// larger of its two)
const void* route_kernel(int L, int hd, bool causal, bool backward) {
  if (route_of(L, hd) == kRouteWhole)
    return backward ? (const void*)whole_bwd_kernel(causal, whole_cw(hd))
                    : (const void*)whole_fwd_kernel(causal, whole_cw(hd));
  return backward ? (const void*)fused_attention_bwd_dkdv_kernel
                  : (const void*)fused_attention_fwd_kernel;
}

}  // namespace

// The route a call at length L and head width hd takes: 0 whole sequence, 1
// key-tiled.
extern "C" int fused_attention_route(int L, int hd) { return (int)route_of(L, hd); }

// Shared-memory bytes a block of the route's kernel needs at (L, hd),
// forward or backward (the tiled backward: the larger of its two kernels).
extern "C" long long fused_attention_smem_bytes(int L, int hd, int backward) {
  return (long long)smem_bytes(L, hd, backward != 0);
}

// Blocks of the route's kernel an SM of the current device holds at once at
// (L, hd), its shared-memory limit raised first; a negative value is a CUDA
// error.
extern "C" int fused_attention_blocks_per_sm(int L, int hd, int causal, int backward) {
  const void* kernel = route_kernel(L, hd, causal != 0, backward != 0);
  const size_t smem = smem_bytes(L, hd, backward != 0);
  const int threads = route_of(L, hd) == kRouteWhole ? kWT : kThreads;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  int blocks = 0;
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err ? -err : blocks;
}

// q, k, v, o (B, L, H, hd) f32 contiguous; key_valid (B, L) int32 (> 0: a
// real key); seed one int64 on the device (null when rate is 0); stats
// (B, H, L, 2) f32 out on the key-tiled route (each query row's max score
// and softmax sum, for its backward), unused (may be null) on the whole
// route. Returns the CUDA error code.
extern "C" int fused_attention_fwd(const float* q, const float* k, const float* v,
                                   const int* key_valid, const void* seed, int B, int L, int H,
                                   int hd, int causal, float scale, float rate, int layer,
                                   float* o, float* stats, void* stream) {
  Shape sh;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  int err = make_shape(B, L, H, hd, causal, scale, rate, layer, vec, &sh);
  if (err) return err;
  if (rate > 0.0f && !seed) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  if (route_of(L, hd) == kRouteWhole) {
    const Whole w = whole_layout(L, hd);
    const size_t smem = whole_bytes(L, hd, false);
    WholeFwdK kernel = whole_fwd_kernel(causal != 0, whole_cw(hd));
    err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<B * H, kWT, smem, s>>>(q, k, v, key_valid, sd, sh, w, o);
    return (int)cudaGetLastError();
  }
  if (!stats) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * fwd_floats(hd);
  err = allow_smem(fused_attention_fwd_kernel, smem);
  if (err) return err;
  const dim3 grid(B * H, (L + kT - 1) / kT, sh.nch);
  fused_attention_fwd_kernel<<<grid, kThreads, smem, s>>>(q, k, v, key_valid, sd, sh, o, stats);
  return (int)cudaGetLastError();
}

// As fused_attention_fwd, with dout in and dq, dk, dv (B, L, H, hd) out. The
// whole route is one kernel that reads neither o nor stats (they may be
// null); the key-tiled route reads the forward's o and stats: the dq kernel,
// then the dk-dv kernel.
extern "C" int fused_attention_bwd(const float* q, const float* k, const float* v,
                                   const int* key_valid, const void* seed, int B, int L, int H,
                                   int hd, int causal, float scale, float rate, int layer,
                                   const float* o, const float* stats, const float* dout,
                                   float* dq, float* dk, float* dv, void* stream) {
  Shape sh;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                   aligned16(dq) && aligned16(dk) && aligned16(dv);
  int err = make_shape(B, L, H, hd, causal, scale, rate, layer, vec, &sh);
  if (err) return err;
  if (rate > 0.0f && !seed) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  if (route_of(L, hd) == kRouteWhole) {
    const Whole w = whole_layout(L, hd);
    const size_t smem = whole_bytes(L, hd, true);
    WholeBwdK kernel = whole_bwd_kernel(causal != 0, whole_cw(hd));
    err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<B * H, kWT, smem, s>>>(q, k, v, key_valid, sd, sh, w, dout, dq, dk, dv);
    return (int)cudaGetLastError();
  }
  if (!o || !stats) return (int)cudaErrorInvalidValue;
  const size_t smem_dq = sizeof(float) * dq_floats(hd), smem_kv = sizeof(float) * dkdv_floats(hd);
  err = allow_smem(fused_attention_bwd_dq_kernel, smem_dq);
  if (!err) err = allow_smem(fused_attention_bwd_dkdv_kernel, smem_kv);
  if (err) return err;
  const dim3 grid(B * H, (L + kT - 1) / kT, sh.nch);
  fused_attention_bwd_dq_kernel<<<grid, kThreads, smem_dq, s>>>(q, k, v, key_valid, sd, sh, o,
                                                                stats, dout, dq);
  err = (int)cudaGetLastError();
  if (err) return err;
  fused_attention_bwd_dkdv_kernel<<<grid, kThreads, smem_kv, s>>>(q, k, v, key_valid, sd, sh, o,
                                                                  stats, dout, dk, dv);
  return (int)cudaGetLastError();
}

// The keep masks the kernels draw for (seed, layer): (B, H, L, L) f32,
// each element 0 or 1 / (1 - rate).
extern "C" int fused_attention_dropout_masks(const void* seed, int B, int H, int L, float rate,
                                             int layer, float* masks, void* stream) {
  Shape sh;
  int err = make_shape(B, L, H, 1, 0, 1.0f, rate, layer, false, &sh);
  if (err) return err;
  if (!seed) return (int)cudaErrorInvalidValue;
  dropout_masks_kernel<<<B * H, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), sh, masks);
  return (int)cudaGetLastError();
}
