"""One post-LN transformer layer as a single kernel, forward and backward.

Port of recbole_tpu/ops/trm_layer.py::fused_transformer_layer2 (:433, the
bf16 whole-layer Pallas kernel that every transformer model of the JAX
package runs by default) and, as the fp32 instance of the same code, of
recbole_tpu/ops/fused_transformer.py::fused_transformer_layer (:409). The
layer (reference TransformerLayer, layers.py:469-504): multi-head attention
with a causal or bidirectional mask built from key validity, output
projection, dropout, add & LayerNorm, FFN, dropout, add & LayerNorm. The
backward recomputes the forward from x, regenerates the dropout masks and
returns dx and the 16 parameter gradients.

Three things live here:

* the plain PyTorch version, ``trm_layer_torch``: the forward of
  ``_forward_core`` (:184-225) and a backward written out by hand as
  ``_bwd_kernel`` (:243-320) writes it, so that it rounds where the kernels
  round (with ``bf16`` both operands of every product go to bfloat16 and
  back; sums, softmax and LayerNorm stay fp32). It takes the dropout keep
  masks as arguments. It is differentiable (a ``torch.autograd.Function``
  around the two);
* the launchers of the hand-written Hopper kernels in ``csrc/trm_layer.cu``
  (``trm_layer_fwd_cuda``, ``trm_layer_bwd_cuda``, each with a launch
  count, and ``trm_dropout_masks_cuda``, which writes out the masks the
  kernels draw for a seed), wrapped for autograd in ``TrmLayer``;
* the dispatcher ``trm_layer``: the plain version for a CPU tensor, the
  kernels for a CUDA tensor, and no fallback between them.

The kernels keep a whole sequence in shared memory, so device memory sees
x, y, dy, dx and the weights only; parameter gradients are summed per block
into private partials and then across blocks in block order, so two runs
give the same bits. Dropout bits come from Philox keyed by (seed, layer,
sequence, site, element): the seed is one int64 drawn on the device from the
caller's generator, so nothing waits on the host. Both instances run one
body (the head of csrc/trm_layer.cu has the design) with every product on
the tensor cores and the weights packed once a call in the order of the
products' fragments: the bf16 one as ``mma.sync`` on bf16 operands with
fp32 sums, the fp32 one as three TF32 products (hi and lo parts) a k-step,
which keeps fp32's precision.

Limits (checked here, a clear error beyond them): D, D / n_heads and the
inner size multiples of 4, at most 256 positions, and a working set
(``trm_layer_smem_bytes`` and ``trm_layer_smem_bytes_bf16`` of the built
library) within the 227 KB of shared memory a block may use (L 50, D 64, I
256 takes 114,112 bytes in the fp32 backward, 105,312 in the bf16 one).
``smem_bytes_fp32`` and ``smem_bytes_bf16`` below are copies of those
formulas. The route is chosen before any launch by one rule for both
instances (``layer_route``, from ``route_floats``: the working set of the
fp32 instance's former FMA kernels, which both instances' blocks fit
wherever it admits a shape): at L >= 58 with D 64 and I 256, or at D 128
with L 50, the route takes ``models/layers.transformer_apply`` to build the
layer as ``fused_attention: True`` does (plain projections and FFN around
the attention kernel), as the JAX package takes XLA where its kernel's
support check fails.
"""

import ctypes
import math

import torch

from . import cuda_build

PARAM_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
              "ln1_g", "ln1_b", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
              "ln2_g", "ln2_b")
ACTS = ("gelu", "relu", "swish", "tanh", "sigmoid")
NEG = -1e9
MAX_SMEM_BYTES = 232448  # opt-in shared memory of a Hopper block


# csrc/trm_layer.cu's FFN chunks (kChunk forward, kChunkBwd backward) and
# the most positions (kMaxRow)
_CHUNK, _CHUNK_BWD = 128, 64
MAX_LEN = 256


def route_floats(L, D, I):
    """The route's rule: the floats of shared memory a backward block of the
    fp32 instance's former FMA kernels took (nine (L, D + 4) buffers, two
    FFN chunks of 128, two (L, L) score matrices, three (L,) vectors). Kept
    as the rule after those kernels went, so that every shape takes the
    path it took before; both instances' blocks fit wherever it admits a
    shape (a CPU test walks them)."""
    IC = min(I, 128)
    LS = (L + 3) // 4 * 4 + 4
    return 9 * L * (D + 4) + 2 * L * (IC + 4) + 2 * L * LS + 3 * L


def _al16(v):
    return (v + 15) // 16 * 16


def _score_stride(L):          # a score row: 4 mod 8 floats, at least 12
    LS = (L + 3) // 4 * 4
    return max(LS + 4 if LS % 8 == 0 else LS, 12)


def smem_bytes_fp32(L, D, I, backward):
    """Shared-memory bytes of one block of the fp32 instance: a copy of
    ``tc_layout_f32`` in csrc/trm_layer.cu (a ``cuda`` test holds it against
    the built library's ``trm_layer_smem_bytes``). Rows of n floats n + 4
    long; only the (L,) vectors stay put, every buffer takes the room of
    those dead in its phase. Forward: x then ctx, q | k | v and one head's
    scores and probabilities, or a1, the FFN sum and a chunk. Backward: its
    forward's attention (x then ctx, two score matrices, q | k | v) and then
    dctx; or ctx, xhat1, a1, the FFN sum, two chunks of 64 and the residual
    cotangent."""
    IC = min(I, _CHUNK_BWD if backward else _CHUNK)
    bD, bQ, bI = (L * (n + 4) * 4 for n in (D, 3 * D, IC))
    fS, vec = L * _score_stride(L) * 4, _al16(L * 4)
    if backward:
        return 6 * vec + max(2 * bQ + 2 * fS + bD, 5 * bD + 2 * bI) + 64
    return 3 * vec + max(bD + bQ + 2 * fS, 3 * bD + bI) + 64


def smem_bytes_bf16(L, D, I, backward):
    """Shared-memory bytes of one block of the bf16 instance: a copy of
    ``tc_layout_bf16`` in csrc/trm_layer.cu (a ``cuda`` test holds it against the
    built library's ``trm_layer_smem_bytes_bf16``). Persistent bf16 copies
    of x, q | k | v, ctx and a1, the backward's fp32 residual cotangent,
    five (L,) vectors and the key validity; then the larger of two areas
    that share their room: the FFN's (fp32 xhat1, a chunk of act(f1) and its
    fp32 sum, in the backward df2 and df1; chunks of 128 forward, 64
    backward) and the attention's (one
    head's fp32 scores and probabilities, in the backward after dO and
    dq | dk | dv)."""
    IC = min(I, _CHUNK_BWD if backward else _CHUNK)

    def sb(n):                 # a bf16 row: n rounded up to 16, plus 8
        return (n + 15) // 16 * 16 + 8

    bD, bQ, bI = (_al16(L * sb(n) * 2) for n in (D, 3 * D, IC))
    fD, fS, vec = L * (D + 4) * 4, L * _score_stride(L) * 4, _al16(L * 4)
    persistent = 3 * bD + bQ + 3 * vec + (fD + 3 * vec if backward else 0)
    if backward:
        ffn = fD + 2 * bI + fD + bD
        attn = bD + bQ + max(2 * fS, fD + bD)
    else:
        ffn, attn = fD + bI + fD, 2 * fS
    return persistent + max(attn, ffn) + 64


def widths_fit(D, I, n_heads):
    """Whether the hidden size D, the head width D / n_heads and the inner
    size I are multiples of 4, as the kernels' 16-byte rows need
    (``_check``)."""
    return not (D % 4 or I % 4 or D % n_heads or (D // n_heads) % 4)


def layer_route(L, D, I, n_heads=1):
    """The path a fused layer of this shape takes: ``"layer"``, the
    whole-layer kernel, when its widths fit (``widths_fit``) and the route's
    rule (``route_floats``) fits a block, else ``"attention"``, the layer
    built around the attention kernel, which takes any head width."""
    if not widths_fit(D, I, n_heads):
        return "attention"
    return "layer" if 4 * route_floats(L, D, I) <= MAX_SMEM_BYTES else "attention"


def param_shapes(D, I):
    return {"wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,),
            "wv": (D, D), "bv": (D,), "wo": (D, D), "bo": (D,),
            "ln1_g": (D,), "ln1_b": (D,), "ff1_w": (D, I), "ff1_b": (I,),
            "ff2_w": (I, D), "ff2_b": (D,), "ln2_g": (D,), "ln2_b": (D,)}


# ------------------------------------------------------------- plain version

def _act_fns(act):
    if act == "gelu":
        return (lambda x: x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))),
                lambda x: (0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
                           + x * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x)))
    if act == "relu":
        return (lambda x: torch.clamp(x, min=0.0), lambda x: (x > 0.0).to(x.dtype))
    if act == "swish":
        def df(x):
            s = torch.sigmoid(x)
            return s + x * s * (1.0 - s)
        return (lambda x: x * torch.sigmoid(x)), df
    if act == "tanh":
        return torch.tanh, (lambda x: 1.0 - torch.tanh(x) ** 2)
    if act == "sigmoid":
        def df(x):
            s = torch.sigmoid(x)
            return s * (1.0 - s)
        return torch.sigmoid, df
    raise ValueError(f"unsupported activation {act!r}")


def _rounder(bf16):
    if bf16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def build_mask(valid, causal):
    """(B, L, L) additive mask from (B, L) key validity: 0 where query i may
    see key j, -1e9 elsewhere (:105-113)."""
    L = valid.shape[1]
    ok = (valid[:, None, :] > 0)
    if causal:
        ok = ok & torch.tril(torch.ones((L, L), dtype=torch.bool, device=valid.device))[None]
    else:
        ok = ok & (valid[:, :, None] > 0)
    return torch.where(ok, 0.0, NEG).to(torch.float32)


def _ln_fwd(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(var + eps)
    xhat = xc * inv
    return xhat * g + b, xhat, inv


def _ln_bwd(dy, xhat, inv, g):
    D = dy.shape[-1]
    dg = (dy * xhat).reshape(-1, D).sum(dim=0)
    db = dy.reshape(-1, D).sum(dim=0)
    dxhat = dy * g
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * inv, dg, db


def _split_masks(masks):
    if masks is None:
        return None, None, None
    return masks.get("attn"), masks.get("attn_out"), masks.get("ffn")


def _forward_core(x, valid, p, masks, n_heads, causal, act, eps, bf16):
    """x (B, L, D) f32 -> every intermediate the backward needs."""
    r = _rounder(bf16)
    f, _ = _act_fns(act)
    B, L, D = x.shape
    hd = D // n_heads
    k_attn, k_attn_out, k_ffn = _split_masks(masks)
    mask = build_mask(valid, causal)
    scale = 1.0 / math.sqrt(hd)
    q = r(x) @ r(p["wq"]) + p["bq"]
    k = r(x) @ r(p["wk"]) + p["bk"]
    v = r(x) @ r(p["wv"]) + p["bv"]
    probs0, probs, ctx = [], [], []
    for h in range(n_heads):
        sl = slice(h * hd, (h + 1) * hd)
        scores = r(q[..., sl]) @ r(k[..., sl]).transpose(1, 2) * scale + mask
        m = scores.max(dim=-1, keepdim=True).values
        e = torch.exp(scores - m)
        p0 = e / e.sum(dim=-1, keepdim=True)
        ph = p0 * k_attn[:, h] if k_attn is not None else p0
        probs0.append(p0)
        probs.append(ph)
        ctx.append(r(ph) @ r(v[..., sl]))
    ctx = torch.cat(ctx, dim=-1)
    attn_out = r(ctx) @ r(p["wo"]) + p["bo"]
    if k_attn_out is not None:
        attn_out = attn_out * k_attn_out
    a1, xhat1, inv1 = _ln_fwd(x + attn_out, p["ln1_g"], p["ln1_b"], eps)
    f1 = r(a1) @ r(p["ff1_w"]) + p["ff1_b"]
    fa = f(f1)
    f2 = r(fa) @ r(p["ff2_w"]) + p["ff2_b"]
    if k_ffn is not None:
        f2 = f2 * k_ffn
    y, xhat2, inv2 = _ln_fwd(a1 + f2, p["ln2_g"], p["ln2_b"], eps)
    return dict(q=q, k=k, v=v, probs0=probs0, probs=probs, ctx=ctx, xhat1=xhat1,
                inv1=inv1, a1=a1, f1=f1, fa=fa, xhat2=xhat2, inv2=inv2, scale=scale, y=y)


def trm_layer_torch_fwd(x, p, valid, masks, n_heads, causal, act, eps, bf16):
    return _forward_core(x, valid, p, masks, n_heads, causal, act, eps, bf16)["y"]


def trm_layer_torch_bwd(x, p, valid, masks, dy, n_heads, causal, act, eps, bf16):
    """dx and {name: gradient}, recomputing the forward, with the rounding
    points of the kernels' backward (:263-308)."""
    r = _rounder(bf16)
    _, dfn = _act_fns(act)
    B, L, D = x.shape
    hd = D // n_heads
    k_attn, k_attn_out, k_ffn = _split_masks(masks)
    o = _forward_core(x, valid, p, masks, n_heads, causal, act, eps, bf16)

    def two(t):
        return t.reshape(B * L, -1)

    def atb(a, b):            # sum over all rows of a^T b
        return r(two(a)).T @ r(two(b))

    g = {}
    dr2, g["ln2_g"], g["ln2_b"] = _ln_bwd(dy, o["xhat2"], o["inv2"], p["ln2_g"])
    df2 = dr2 if k_ffn is None else dr2 * k_ffn
    g["ff2_w"] = atb(o["fa"], df2)
    g["ff2_b"] = two(df2).sum(dim=0)
    dfa = r(df2) @ r(p["ff2_w"]).T
    df1 = dfa * dfn(o["f1"])
    g["ff1_w"] = atb(o["a1"], df1)
    g["ff1_b"] = two(df1).sum(dim=0)
    da1 = dr2 + r(df1) @ r(p["ff1_w"]).T
    dr1, g["ln1_g"], g["ln1_b"] = _ln_bwd(da1, o["xhat1"], o["inv1"], p["ln1_g"])
    dattn = dr1 if k_attn_out is None else dr1 * k_attn_out
    g["wo"] = atb(o["ctx"], dattn)
    g["bo"] = two(dattn).sum(dim=0)
    dctx = r(dattn) @ r(p["wo"]).T
    dq, dk, dv = [], [], []
    for h in range(n_heads):
        sl = slice(h * hd, (h + 1) * hd)
        do_h = dctx[..., sl]
        dv.append(r(o["probs"][h]).transpose(1, 2) @ r(do_h))
        dp = r(do_h) @ r(o["v"][..., sl]).transpose(1, 2)
        if k_attn is not None:
            dp = dp * k_attn[:, h]
        p0 = o["probs0"][h]
        ds = p0 * (dp - (dp * p0).sum(dim=-1, keepdim=True))
        ds = ds * o["scale"]
        dq.append(r(ds) @ r(o["k"][..., sl]))
        dk.append(r(ds).transpose(1, 2) @ r(o["q"][..., sl]))
    dq, dk, dv = (torch.cat(t, dim=-1) for t in (dq, dk, dv))
    for name, d in (("q", dq), ("k", dk), ("v", dv)):
        g["w" + name] = atb(x, d)
        g["b" + name] = two(d).sum(dim=0)
    dx = (dr1 + r(dq) @ r(p["wq"]).T + r(dk) @ r(p["wk"]).T + r(dv) @ r(p["wv"]).T)
    return dx, g


class _PlainTrmLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, valid, masks, cfg, *params):
        ctx.cfg, ctx.masks = cfg, masks
        ctx.save_for_backward(x, valid, *params)
        return trm_layer_torch_fwd(x, dict(zip(PARAM_KEYS, params)), valid, masks, *cfg)

    @staticmethod
    def backward(ctx, dy):
        x, valid, *params = ctx.saved_tensors
        dx, g = trm_layer_torch_bwd(x, dict(zip(PARAM_KEYS, params)), valid, ctx.masks,
                                    dy, *ctx.cfg)
        return (dx, None, None, None, *(g[k] for k in PARAM_KEYS))


def trm_layer_torch(x, params, key_valid, masks=None, *, n_heads, causal, act="gelu",
                    eps=1e-12, bf16=True):
    """Plain version. x (B, L, D) f32; params a mapping of the 16 leaves;
    key_valid (B, L), > 0 for a real key; masks None or a dict of keep masks
    (each element 0 or 1 / (1 - rate)): "attn" (B, H, L, L), "attn_out" and
    "ffn" (B, L, D)."""
    cfg = (int(n_heads), bool(causal), act, float(eps), bool(bf16))
    return _PlainTrmLayer.apply(x.to(torch.float32), key_valid, masks, cfg,
                                *(params[k] for k in PARAM_KEYS))


def plain_dropout_masks(generator, B, H, L, D, attn_rate, rate, device):
    """Keep masks for the plain version drawn from ``generator``, in the
    sites' order: the H attention masks, the attention output, the FFN
    output. None when both rates are 0."""
    if attn_rate <= 0.0 and rate <= 0.0:
        return None

    def keep(shape, r):
        u = torch.rand(shape, generator=generator, device=device)
        return (u >= r).to(torch.float32) / (1.0 - r)

    masks = {}
    if attn_rate > 0.0:
        masks["attn"] = keep((B, H, L, L), attn_rate)
    if rate > 0.0:
        masks["attn_out"] = keep((B, L, D), rate)
        masks["ffn"] = keep((B, L, D), rate)
    return masks


# ----------------------------------------------------------------- launchers

_LIB = None
_BLOCKS = {}


def _lib():
    """The built library, loaded once: a train step calls it four times."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("trm_layer")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, i, i, i, f, f, f, i, i]   # B L D H I causal act eps rates layer bf16
        lib.trm_layer_fwd.argtypes = [p, p, p, p, *shape, p, p, p]
        lib.trm_layer_bwd.argtypes = [p, p, p, p, *shape, p, p, p, p, p, p]
        lib.trm_dropout_masks.argtypes = [p, i, i, i, i, f, f, i, p, p, p]
        lib.trm_layer_blocks.argtypes = [i] * 7
        for fn in (lib.trm_layer_smem_bytes, lib.trm_layer_smem_bytes_bf16,
                   lib.trm_layer_scratch_floats):
            fn.argtypes = [i] * 4
            fn.restype = ctypes.c_longlong
        for fn in (lib.trm_layer_fwd, lib.trm_layer_bwd, lib.trm_dropout_masks,
                   lib.trm_layer_blocks):
            fn.restype = i
        _LIB = lib
    return _LIB


def _check(name, x, valid, params, seed, n_heads, act, attn_rate, rate, backward, bf16):
    """Validate one call's tensors and widths; returns (B, L, D, I)."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous float32 (B, L, D) x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, L, D = x.shape
    if B < 1 or L < 1:
        raise ValueError(f"{name} needs B >= 1 and L >= 1")
    I = params["ff1_w"].shape[1]
    for k, shape in param_shapes(D, I).items():
        t = params[k]
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: parameter {k} must be a contiguous, 16-byte aligned "
                             f"float32 {shape} on {x.device}, got {t.dtype} {tuple(t.shape)}")
    if tuple(valid.shape) != (B, L) or valid.dtype != torch.int32 or not valid.is_contiguous() \
            or valid.device != x.device:
        raise ValueError(f"{name} takes a contiguous int32 (B, L) key_valid on x's device")
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}; the kernel has {ACTS}")
    if D % n_heads or D % 4 or (D // n_heads) % 4 or I % 4:
        raise ValueError(f"{name}: hidden size {D}, head width {D}/{n_heads} and inner size "
                         f"{I} must be multiples of 4")
    if not (0.0 <= attn_rate < 1.0 and 0.0 <= rate < 1.0):
        raise ValueError("dropout rates must lie in [0, 1)")
    if attn_rate > 0.0 or rate > 0.0:
        if seed is None or seed.dtype != torch.int64 or seed.numel() != 1 \
                or seed.device != x.device:
            raise ValueError(f"{name} with dropout takes its seed as one int64 on x's device")
    if L > MAX_LEN:
        raise ValueError(f"{name}: the kernels take at most {MAX_LEN} positions, got {L}")
    lib = _lib()
    need = (lib.trm_layer_smem_bytes_bf16 if bf16 else lib.trm_layer_smem_bytes)(
        L, D, I, int(backward))
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: L={L}, D={D}, inner={I} needs {need} bytes of shared memory a block "
            f"({'backward' if backward else 'forward'}), more than the {MAX_SMEM_BYTES} a "
            "Hopper block may use; shorten MAX_ITEM_LIST_LENGTH or the hidden size, or set "
            "fused_attention: False")
    return B, L, D, I


def _pointers(params):
    return (ctypes.c_void_p * len(PARAM_KEYS))(*(params[k].data_ptr() for k in PARAM_KEYS))


def _scratch(D, I, bf16, backward, device):
    """Room for the kernels' packed weight matrices (W, and W^T for the
    backward): bf16 fragments, or the fp32 instance's tf32 hi and lo ones."""
    n = _lib().trm_layer_scratch_floats(D, I, int(bf16), int(backward))
    return torch.empty(n, dtype=torch.float32, device=device)


def _shape_args(B, L, D, I, n_heads, causal, act, eps, attn_rate, rate, layer, bf16):
    return (B, L, D, n_heads, I, int(causal), ACTS.index(act), float(eps), float(attn_rate),
            float(rate), int(layer), int(bf16))


def _ptr(t):
    return None if t is None else t.data_ptr()


def trm_layer_fwd_cuda(x, params, key_valid, seed=None, *, n_heads, causal, act="gelu",
                       eps=1e-12, dropout=0.0, attn_dropout=0.0, layer=0, bf16=True):
    """Launch the forward kernel, ``trm_layer_bf16_fwd_kernel`` or (``bf16``
    False) ``trm_layer_tf32x3_fwd_kernel``, after the weights' packing: y
    (B, L, D). ``seed`` is one int64 on the device (needed only with
    dropout); ``layer`` strides the dropout streams of stacked layers.
    Counts its launches in ``trm_layer_fwd_cuda.launches``
    (``launches_fp32``: those of the fp32 instance among them)."""
    B, L, D, I = _check("trm_layer_fwd_cuda", x, key_valid, params, seed, n_heads, act,
                        attn_dropout, dropout, False, bf16)
    y = torch.empty_like(x)
    wr = _scratch(D, I, bf16, False, x.device)
    err = _lib().trm_layer_fwd(
        x.data_ptr(), key_valid.data_ptr(), _pointers(params), _ptr(seed),
        *_shape_args(B, L, D, I, n_heads, causal, act, eps, attn_dropout, dropout, layer, bf16),
        _ptr(wr), y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"trm_layer_fwd kernel launch failed: CUDA error {err}")
    trm_layer_fwd_cuda.launches += 1
    trm_layer_fwd_cuda.launches_fp32 += not bf16
    return y


# launches of both instances, and of the fp32 instance among them
trm_layer_fwd_cuda.launches = 0
trm_layer_fwd_cuda.launches_fp32 = 0


def _bwd_blocks(B, L, D, n_heads, I, bf16, device):
    key = (B, L, D, n_heads, I, bool(bf16), device)
    if key not in _BLOCKS:
        n = _lib().trm_layer_blocks(B, L, D, n_heads, I, int(bf16), 1)
        if n < 1:
            raise RuntimeError(f"trm_layer backward cannot be launched at L={L}, D={D}, "
                               f"inner={I}: CUDA error {-n}")
        _BLOCKS[key] = n
    return _BLOCKS[key]


def trm_layer_bwd_cuda(x, params, key_valid, dy, seed=None, *, n_heads, causal, act="gelu",
                       eps=1e-12, dropout=0.0, attn_dropout=0.0, layer=0, bf16=True):
    """Launch the backward kernel (``trm_layer_bf16_bwd_kernel`` or
    ``trm_layer_tf32x3_bwd_kernel``) and the reduction of its per-block
    partials: (dx (B, L, D), {name: gradient}). Counts its launches in
    ``trm_layer_bwd_cuda.launches``."""
    B, L, D, I = _check("trm_layer_bwd_cuda", x, key_valid, params, seed, n_heads, act,
                        attn_dropout, dropout, True, bf16)
    if tuple(dy.shape) != (B, L, D) or dy.dtype != torch.float32 or dy.device != x.device:
        raise ValueError("dy must be float32 (B, L, D) on x's device")
    dy = dy.contiguous()
    shapes = param_shapes(D, I)
    P = sum(math.prod(s) for s in shapes.values())
    blocks = _bwd_blocks(B, L, D, n_heads, I, bf16, x.device)
    partials = torch.empty((blocks, P), dtype=torch.float32, device=x.device)
    flat = torch.empty(P, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    wr = _scratch(D, I, bf16, True, x.device)
    err = _lib().trm_layer_bwd(
        x.data_ptr(), key_valid.data_ptr(), _pointers(params), _ptr(seed),
        *_shape_args(B, L, D, I, n_heads, causal, act, eps, attn_dropout, dropout, layer, bf16),
        _ptr(wr), dy.data_ptr(), dx.data_ptr(), partials.data_ptr(), flat.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"trm_layer_bwd kernel launch failed: CUDA error {err}")
    trm_layer_bwd_cuda.launches += 1
    trm_layer_bwd_cuda.launches_fp32 += not bf16
    grads, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        grads[k] = flat[at:at + n].view(shape)
        at += n
    return dx, grads


trm_layer_bwd_cuda.launches = 0
trm_layer_bwd_cuda.launches_fp32 = 0


def trm_dropout_masks_cuda(seed, B, H, L, D, attn_rate, rate, layer=0):
    """The keep masks the kernels draw for (seed, layer), in the plain
    version's format: {"attn" (B, H, L, L), "attn_out", "ffn" (B, L, D)}."""
    if not seed.is_cuda or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("seed must be one int64 on a CUDA device")
    attn = torch.empty((B, H, L, L), dtype=torch.float32, device=seed.device)
    hidden = torch.empty((B, 2, L, D), dtype=torch.float32, device=seed.device)
    err = _lib().trm_dropout_masks(seed.data_ptr(), B, H, L, D, float(attn_rate), float(rate),
                                   int(layer), attn.data_ptr(), hidden.data_ptr(),
                                   torch.cuda.current_stream(seed.device).cuda_stream)
    if err:
        raise RuntimeError(f"trm_dropout_masks launch failed: CUDA error {err}")
    masks = {}
    if attn_rate > 0.0:
        masks["attn"] = attn
    if rate > 0.0:
        masks["attn_out"], masks["ffn"] = hidden[:, 0], hidden[:, 1]
    return masks or None


class TrmLayer(torch.autograd.Function):
    """The layer on CUDA tensors: forward and backward are one kernel each."""

    @staticmethod
    def forward(ctx, x, valid, seed, kw, *params):
        ctx.kw = kw
        ctx.has_seed = seed is not None
        ctx.save_for_backward(x, valid, *params, *((seed,) if seed is not None else ()))
        return trm_layer_fwd_cuda(x, dict(zip(PARAM_KEYS, params)), valid, seed, **dict(kw))

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        x, valid, params = saved[0], saved[1], saved[2:2 + len(PARAM_KEYS)]
        seed = saved[-1] if ctx.has_seed else None
        dx, g = trm_layer_bwd_cuda(x, dict(zip(PARAM_KEYS, params)), valid, dy, seed,
                                   **dict(ctx.kw))
        return (dx, None, None, None, *(g[k] for k in PARAM_KEYS))


# ---------------------------------------------------------------- dispatcher

def draw_seed(generator, device):
    """One int64 on ``device`` from ``generator``: the kernels' dropout key.
    The draw stays on the device, so the host does not wait for it."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def trm_layer(x, params, key_valid, *, n_heads, causal, act="gelu", eps=1e-12, dropout=0.0,
              attn_dropout=0.0, seed=None, generator=None, layer=0, bf16=True):
    """One transformer layer on x (B, L, D) float32. ``params`` maps the 16
    leaf names to tensors; ``key_valid`` (B, L) is > 0 for a real key. The
    plain version for a CPU tensor (its dropout masks drawn from
    ``generator``), the kernels for a CUDA tensor (their dropout keyed by
    ``seed``, one int64 on the device, and ``layer``)."""
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}; the layer has {ACTS}")
    dropping = dropout > 0.0 or attn_dropout > 0.0
    if x.device.type == "cpu":
        masks = None
        if dropping:
            if generator is None:
                raise ValueError("dropout on a CPU tensor draws its masks from a generator")
            B, L, D = x.shape
            masks = plain_dropout_masks(generator, B, n_heads, L, D, attn_dropout, dropout,
                                        x.device)
        return trm_layer_torch(x, params, key_valid, masks, n_heads=n_heads, causal=causal,
                               act=act, eps=eps, bf16=bf16)
    kw = (("n_heads", int(n_heads)), ("causal", bool(causal)), ("act", act),
          ("eps", float(eps)), ("dropout", float(dropout)),
          ("attn_dropout", float(attn_dropout)), ("layer", int(layer)), ("bf16", bool(bf16)))
    return TrmLayer.apply(x.to(torch.float32).contiguous(),
                          key_valid.to(torch.int32).contiguous(),
                          seed if dropping else None, kw, *(params[k] for k in PARAM_KEYS))
