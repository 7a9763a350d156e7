"""Multi-head attention alone, forward and backward: the kernel behind
``fused_attention: True``.

Port of recbole_tpu/ops/fused_attention.py::fused_attention (:204; Pallas
kernels ``_fwd_kernel`` :78 and ``_bwd_kernel`` :95). On q, k, v
(B, L, H, hd) float32, the natural reshape of a (B, L, D) projection, and
key validity (B, L): scores ``q k^T / sqrt(hd)`` (the JAX default scale,
the only one its callers use), -1e9 where key j is invalid or, causal,
later than query i (a key-only mask in the bidirectional case, as the JAX kernel's ``_build_mask``
:39-47 builds it), softmax, dropout, ``@ v``. A query row with no valid key
comes out uniform. Everything is fp32, as in the JAX kernel, whatever the
compute dtype.

Three things live here:

* the plain version ``fused_attention_torch``, differentiable by autograd;
  with rate 0 it is the counterpart of ``attention_xla`` (:224). Its
  dropout comes from explicit keep masks or from a generator (drawn as
  ``trm_layer.plain_dropout_masks`` draws the attention masks);
* the launchers of the hand-written Hopper kernels in
  ``csrc/fused_attention.cu`` (``fused_attention_fwd_cuda``,
  ``fused_attention_bwd_cuda``, each with a launch count, and
  ``fused_attention_dropout_masks_cuda``, which writes out the masks the
  kernels draw), wrapped for autograd in ``FusedAttention``. Their dropout
  is keyed by one int64 seed on the device (``trm_layer.draw_seed``) and
  counted by (element, sequence, head, layer), the scheme of
  ``csrc/trm_layer.cu``;
* the dispatcher ``fused_attention``: the plain version for CPU tensors,
  the kernels for CUDA tensors, nothing falling back.

A masked score has no gradient (the mask is a select, as in
``attention_xla``); the JAX kernel adds -1e9 instead, and its backward
differs from this one in a row with no valid key only. The kernels tile
queries and keys (32 each) and stream the key tiles with an online softmax,
so any L runs; the forward also returns each query row's max score and
softmax sum, which the backward reads. Limit: head width at most
``fused_attention_max_head_width`` of the built library (128), else it
raises.
"""

import ctypes
import math

import torch

from . import cuda_build
from .trm_layer import plain_dropout_masks

NEG = -1e9
MAX_SMEM_BYTES = 232448  # opt-in shared memory of a Hopper block


def _visible(key_valid, L, causal):
    ok = (key_valid > 0)[:, None, None, :]
    if causal:
        ok = ok & torch.tril(torch.ones((L, L), dtype=torch.bool, device=key_valid.device))
    return ok


def fused_attention_torch(q, k, v, key_valid, causal=True, rate=0.0, masks=None,
                          generator=None):
    """Plain version: (B, L, H, hd) out. ``masks`` (B, H, L, L) keep masks
    (0 or 1 / (1 - rate)), or None to draw them from ``generator`` when
    ``rate`` > 0."""
    B, L, H, hd = q.shape
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * (1.0 / math.sqrt(hd))
    s = torch.where(_visible(key_valid, L, causal), s, torch.full((), NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        if masks is None:
            if generator is None:
                raise ValueError("dropout on the plain attention needs masks or a generator")
            masks = plain_dropout_masks(generator, B, H, L, hd, rate, 0.0, q.device)["attn"]
        p = p * masks
    return torch.einsum("bhlm,bmhd->blhd", p, v)


# ----------------------------------------------------------------- launchers

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("fused_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, i, f, f, i]                 # B L H hd causal scale rate layer
        lib.fused_attention_fwd.argtypes = [p, p, p, p, p, *shape, p, p, p]
        lib.fused_attention_bwd.argtypes = [p, p, p, p, p, *shape, p, p, p, p, p, p, p]
        lib.fused_attention_dropout_masks.argtypes = [p, i, i, i, f, i, p, p]
        lib.fused_attention_smem_bytes.argtypes = [i, i]
        lib.fused_attention_smem_bytes.restype = ctypes.c_longlong
        lib.fused_attention_max_head_width.argtypes = []
        for fn in (lib.fused_attention_fwd, lib.fused_attention_bwd,
                   lib.fused_attention_dropout_masks, lib.fused_attention_max_head_width):
            fn.restype = i
        _LIB = lib
    return _LIB


def _check(name, q, k, v, key_valid, seed, rate, backward):
    """Validate one call's tensors; returns (B, L, H, hd)."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dim() != 4:
        raise ValueError(f"{name} takes (B, L, H, hd) q, k and v")
    B, L, H, hd = q.shape
    for what, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != (B, L, H, hd) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 {(B, L, H, hd)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if tuple(key_valid.shape) != (B, L) or key_valid.dtype != torch.int32 \
            or not key_valid.is_contiguous() or key_valid.device != q.device:
        raise ValueError(f"{name} takes a contiguous int32 (B, L) key_valid on q's device")
    if not 0.0 <= rate < 1.0:
        raise ValueError("the dropout rate must lie in [0, 1)")
    if rate > 0.0 and (seed is None or seed.dtype != torch.int64 or seed.numel() != 1
                       or seed.device != q.device):
        raise ValueError(f"{name} with dropout takes its seed as one int64 on q's device")
    most = _lib().fused_attention_max_head_width()
    if hd > most:
        raise ValueError(f"{name}: head width {hd} is wider than the {most} the kernels take "
                         "(a tile of its rows in shared memory); raise n_heads, or set "
                         "fused_attention to another path")
    need = _lib().fused_attention_smem_bytes(hd, int(backward))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: head width {hd} needs {need} bytes of shared memory a "
                         f"block, more than the {MAX_SMEM_BYTES} a Hopper block may use")
    return B, L, H, hd


def _args(B, L, H, hd, causal, rate, layer):
    return (B, L, H, hd, int(causal), 1.0 / math.sqrt(hd), float(rate), int(layer))


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_attention_fwd_cuda(q, k, v, key_valid, seed=None, *, causal=True, rate=0.0, layer=0,
                             with_stats=False):
    """Launch ``fused_attention_fwd_kernel``: o (B, L, H, hd), and with
    ``with_stats`` also (o, stats), stats (B, H, L, 2) the query rows' max
    score and softmax sum that the backward reads. Counts its launches in
    ``fused_attention_fwd_cuda.launches``."""
    B, L, H, hd = _check("fused_attention_fwd_cuda", q, k, v, key_valid, seed, rate, False)
    o = torch.empty_like(q)
    stats = torch.empty((B, H, L, 2), dtype=torch.float32, device=q.device)
    err = _lib().fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        _ptr(seed) if rate > 0.0 else None, *_args(B, L, H, hd, causal, rate, layer),
        o.data_ptr(), stats.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention_fwd kernel launch failed: CUDA error {err}")
    fused_attention_fwd_cuda.launches += 1
    return (o, stats) if with_stats else o


fused_attention_fwd_cuda.launches = 0


def fused_attention_bwd_cuda(q, k, v, key_valid, dout, seed=None, *, o=None, stats=None,
                             causal=True, rate=0.0, layer=0):
    """Launch the backward's ``fused_attention_bwd_dq_kernel`` and
    ``fused_attention_bwd_dkdv_kernel`` on the forward's ``o`` and ``stats``
    (``fused_attention_fwd_cuda(..., with_stats=True)``): (dq, dk, dv).
    Counts its launches in ``fused_attention_bwd_cuda.launches``."""
    B, L, H, hd = _check("fused_attention_bwd_cuda", q, k, v, key_valid, seed, rate, True)
    if o is None or stats is None:
        raise ValueError("fused_attention_bwd_cuda reads the forward's o and stats "
                         "(fused_attention_fwd_cuda(..., with_stats=True))")
    for what, t, shape in (("dout", dout, (B, L, H, hd)), ("o", o, (B, L, H, hd)),
                           ("stats", stats, (B, H, L, 2))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{what} must be float32 {shape} on q's device")
    dout, o, stats = dout.contiguous(), o.contiguous(), stats.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = _lib().fused_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        _ptr(seed) if rate > 0.0 else None, *_args(B, L, H, hd, causal, rate, layer),
        o.data_ptr(), stats.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention_bwd kernel launch failed: CUDA error {err}")
    fused_attention_bwd_cuda.launches += 1
    return dq, dk, dv


fused_attention_bwd_cuda.launches = 0


def fused_attention_dropout_masks_cuda(seed, B, H, L, rate, layer=0):
    """The (B, H, L, L) keep masks the kernels draw for (seed, layer), in the
    plain version's format (0 or 1 / (1 - rate))."""
    if not seed.is_cuda or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("seed must be one int64 on a CUDA device")
    masks = torch.empty((B, H, L, L), dtype=torch.float32, device=seed.device)
    err = _lib().fused_attention_dropout_masks(
        seed.data_ptr(), B, H, L, float(rate), int(layer), masks.data_ptr(),
        torch.cuda.current_stream(seed.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention_dropout_masks launch failed: CUDA error {err}")
    return masks


class FusedAttention(torch.autograd.Function):
    """Attention on CUDA tensors: the forward kernel, and the backward's two
    kernels on its saved output and row statistics."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, seed, kw):
        ctx.kw = kw
        ctx.has_seed = seed is not None
        o, stats = fused_attention_fwd_cuda(q, k, v, key_valid, seed, with_stats=True,
                                            **dict(kw))
        ctx.save_for_backward(q, k, v, key_valid, o, stats,
                              *((seed,) if seed is not None else ()))
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, o, stats, *rest = ctx.saved_tensors
        seed = rest[0] if ctx.has_seed else None
        dq, dk, dv = fused_attention_bwd_cuda(q, k, v, key_valid, dout, seed, o=o, stats=stats,
                                              **dict(ctx.kw))
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------- dispatcher

def fused_attention(q, k, v, key_valid, *, causal=True, rate=0.0, seed=None, generator=None,
                    layer=0):
    """Attention on (B, L, H, hd) float32 q, k, v with (B, L) key validity:
    the plain version for a CPU tensor (its dropout masks drawn from
    ``generator``), the kernels for a CUDA tensor (their dropout keyed by
    ``seed``, one int64 on the device, and ``layer``)."""
    if q.device.type == "cpu":
        return fused_attention_torch(q, k, v, key_valid, causal, rate, generator=generator)
    kw = (("causal", bool(causal)), ("rate", float(rate)), ("layer", int(layer)))
    return FusedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                key_valid.to(torch.int32).contiguous(),
                                seed if rate > 0.0 else None, kw)
