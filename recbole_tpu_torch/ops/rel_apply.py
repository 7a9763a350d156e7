"""Per-row relation-matrix apply: y[n] = R[rel[n]] v[n], forward and backward.

Port of recbole_tpu/ops/rel_apply.py::rel_apply (:113; Pallas kernels
``_fwd_kernel`` :80 and ``_bwd_kernel`` :89), RippleNet's transform of its
ripple-set heads by their relations' (D, D) matrices. On v (N, D) float32,
rel (N,) integer ids and R (NR, D, D) float32, in the JAX kernel's
orientation (its ``einsum("bmj,ij->bmi")``):

    y[n, i] = sum_j R[rel[n], i, j] v[n, j]
    dv[n] = R[rel[n]]^T dy[n];  dR[r] = sum over n with rel[n] = r of dy[n] v[n]^T

rel gets no gradient. A row whose relation lies outside [0, NR) gets
y = 0 and adds nothing, as the JAX kernel's pad rows do.

Two instances, as for the port's other kernels:

* fp32 (``bf16=False``): the function of RippleNet's XLA relation loop
  (JAX ripplenet.py:173-178) and of its one-hot branch for NR > 128
  (:165-172), RippleNet's default (``compute_dtype: auto`` is float32 for
  the knowledge family);
* bf16 (``bf16=True``): the TPU kernel's rounding points (:82-86, :95-109):
  v, dy and R rounded to bfloat16, products summed in fp32, y and dv
  rounded to bfloat16 (returned as float32), dR summed in fp32 with no final
  rounding; RippleNet under ``compute_dtype: bfloat16``.

Three things live here: the plain PyTorch version ``rel_apply_torch``
(one product per relation over its rows) with its backward
``rel_apply_torch_bwd`` written out at the same rounding points (the tests
and the CPU path use them); the launchers of the hand-written Hopper kernels in
``csrc/rel_apply.cu`` (``rel_apply_fwd_cuda``, ``rel_apply_bwd_cuda``, each
with a launch count), wrapped for autograd in ``RelApply``; and the
dispatcher ``rel_apply``: the plain version for a CPU tensor, the kernels
for a CUDA tensor, nothing falling back. The forward buckets the rows by
relation on the device (two kernels; the stable sort) and multiplies them
on the tensor cores in one more; ``RelApply`` keeps its bucket tables for
the backward, one pass and a reduce that sums dR's partials (one a block
and run of one relation) in block order, so two runs give the same bits.
The kernels' limits (from the built library): D a multiple of 4 and at
most 128, NR at most 16,383; the launchers raise past them. The dispatcher
routes every D before launch (``width_blocks``): it zero-pads D to a
multiple of 4 (v's columns and both axes of R; exact) and, past 128, to
the fewest equal blocks of at most 128 columns, and composes the kernels
on the square blocks,
``y[:, c] = sum over k of v[:, k] @ R[rel][c, k]^T`` added in k's order,
autograd giving the backward from the blocks' own.
"""

import ctypes

import torch
from torch.nn import functional as F

from . import cuda_build

# the widest D the kernels take (rel_apply_max_width of the built library)
BLOCK_D = 128


def _rounder(bf16):
    if bf16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def _rows_of(rel, NR):
    """[(r, the indices of the rows with relation r)] for the relations
    that have rows."""
    rel = rel.long()
    out = []
    for r in torch.unique(rel).tolist():
        if 0 <= r < NR:
            out.append((r, torch.nonzero(rel == r)[:, 0]))
    return out


def rel_apply_torch(v, rel, R, bf16=False):
    """Plain forward: (N, D) float32, one product per relation over its rows
    (the counterpart of RippleNet's relation loop, without its masked passes
    over all rows)."""
    r = _rounder(bf16)
    y = torch.zeros_like(v)
    for rid, idx in _rows_of(rel, R.shape[0]):
        y[idx] = r(r(v[idx]) @ r(R[rid]).T)
    return y


def rel_apply_torch_bwd(v, rel, R, dy, bf16=False):
    """(dv, dR) of ``sum(rel_apply(v, rel, R) * dy)`` with the kernels'
    rounding points, written out."""
    r = _rounder(bf16)
    dv = torch.zeros_like(v)
    dR = torch.zeros_like(R)
    for rid, idx in _rows_of(rel, R.shape[0]):
        d = r(dy[idx])
        dv[idx] = r(d @ r(R[rid]))
        dR[rid] = d.T @ r(v[idx])
    return dv, dR


class _PlainRelApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, rel, R, bf16):
        ctx.bf16 = bf16
        ctx.save_for_backward(v, rel, R)
        return rel_apply_torch(v, rel, R, bf16)

    @staticmethod
    def backward(ctx, dy):
        v, rel, R = ctx.saved_tensors
        dv, dR = rel_apply_torch_bwd(v, rel, R, dy, ctx.bf16)
        return dv, None, dR, None


# ----------------------------------------------------------------- launchers

_LIB = None
# the count kernel's ticket, one int32 per (device, stream): zero when made,
# and zero again after each bucketing (its last block resets it); never
# freed (a captured CUDA graph may still use it)
_TICKETS = {}
# the backward's dR partial floats per (device, N, D, NR, instance)
_PARTIALS = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("rel_apply")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rel_apply_bucket.argtypes = [p, i, i, i, i, p, p, p]
        lib.rel_apply_fwd.argtypes = [p, p, i, i, i, i, p, p, p]
        lib.rel_apply_bwd.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
        lib.rel_apply_scratch_ints.argtypes = [i, i, i, i]
        lib.rel_apply_partial_floats.argtypes = [i, i, i, i]
        lib.rel_apply_max_width.argtypes = []
        lib.rel_apply_max_relations.argtypes = []
        lib.rel_apply_scratch_ints.restype = ctypes.c_longlong
        lib.rel_apply_partial_floats.restype = ctypes.c_longlong
        for fn in (lib.rel_apply_bucket, lib.rel_apply_fwd, lib.rel_apply_bwd,
                   lib.rel_apply_max_width, lib.rel_apply_max_relations):
            fn.restype = i
        _LIB = lib
    return _LIB


def _check(name, v, rel, R):
    """Validate one call's tensors; returns (N, D, NR)."""
    if not v.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if v.dim() != 2 or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError(f"{name} takes a contiguous float32 (N, D) v, got {v.dtype} "
                         f"{tuple(v.shape)}")
    N, D = v.shape
    if R.dim() != 3 or tuple(R.shape[1:]) != (D, D) or R.dtype != torch.float32 \
            or not R.is_contiguous() or R.device != v.device:
        raise ValueError(f"{name} takes a contiguous float32 (NR, {D}, {D}) R on v's device, "
                         f"got {R.dtype} {tuple(R.shape)}")
    if tuple(rel.shape) != (N,) or rel.dtype != torch.int32 or not rel.is_contiguous() \
            or rel.device != v.device:
        raise ValueError(f"{name} takes a contiguous int32 (N,) rel on v's device")
    lib = _lib()
    NR = R.shape[0]
    if D % 4 or D > lib.rel_apply_max_width() or NR > lib.rel_apply_max_relations() \
            or N < 1 or NR < 1:
        raise ValueError(f"{name}: D={D} must be a multiple of 4 and at most "
                         f"{lib.rel_apply_max_width()} (a relation's matrix and a tile of rows "
                         f"in one block's shared memory), NR={NR} between 1 and "
                         f"{lib.rel_apply_max_relations()}, N={N} at least 1")
    return N, D, NR


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


class RelBuckets:
    """One call's bucket tables on the card (the rows' stable sort by
    relation, and each tile kernel's blocks: a relation's sorted rows a
    block), as ``rel_apply_fwd_cuda(..., keep_buckets=True)`` made them for
    ``rel``: ``rel_apply_bwd_cuda`` takes them instead of bucketing again."""

    __slots__ = ("scratch", "N", "D", "NR", "bf16")

    def __init__(self, scratch, N, D, NR, bf16):
        self.scratch, self.N, self.D, self.NR, self.bf16 = scratch, N, D, NR, bf16


def _bucket(rel, N, D, NR, bf16):
    """Launch rel_count_kernel and rel_scatter_kernel: the bucket tables of
    ``rel`` on its device, for the instance at D (the tile kernels' blocks
    follow their occupancy)."""
    stream = _stream(rel)
    key = (rel.device.index, stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=rel.device)
    n = _lib().rel_apply_scratch_ints(N, D, NR, int(bf16))
    if n < 0:
        raise RuntimeError("rel_apply: the tile kernels' occupancy query failed")
    scratch = torch.empty(n, dtype=torch.int32, device=rel.device)
    err = _lib().rel_apply_bucket(rel.data_ptr(), N, D, NR, int(bf16), scratch.data_ptr(),
                                  ticket.data_ptr(), stream)
    if err:
        raise RuntimeError(f"rel_apply bucketing kernel launch failed: CUDA error {err}")
    return RelBuckets(scratch, N, D, NR, bool(bf16))


def rel_apply_fwd_cuda(v, rel, R, *, bf16=False, keep_buckets=False):
    """Launch the bucketing kernels and ``rel_fwd_kernel``: y (N, D) float32,
    and with ``keep_buckets`` (y, the ``RelBuckets`` its backward can reuse).
    Counts its calls in ``rel_apply_fwd_cuda.launches`` (``launches_bf16``:
    the bf16 instance's among them) and the kernels they launch in
    ``kernel_launches`` (3 a call)."""
    N, D, NR = _check("rel_apply_fwd_cuda", v, rel, R)
    buckets = _bucket(rel, N, D, NR, bf16)
    y = torch.empty_like(v)
    err = _lib().rel_apply_fwd(v.data_ptr(), R.data_ptr(), N, D, NR, int(bf16),
                               buckets.scratch.data_ptr(), y.data_ptr(), _stream(v))
    if err:
        raise RuntimeError(f"rel_apply_fwd kernel launch failed: CUDA error {err}")
    rel_apply_fwd_cuda.launches += 1
    rel_apply_fwd_cuda.launches_bf16 += bool(bf16)
    rel_apply_fwd_cuda.kernel_launches += 3
    return (y, buckets) if keep_buckets else y


rel_apply_fwd_cuda.launches = 0
rel_apply_fwd_cuda.launches_bf16 = 0
rel_apply_fwd_cuda.kernel_launches = 0


def _partials(device, N, D, NR, bf16):
    key = (device.index, N, D, NR, bool(bf16))
    if key not in _PARTIALS:
        with torch.cuda.device(device):
            n = _lib().rel_apply_partial_floats(N, D, NR, int(bf16))
        if n < 0:
            raise RuntimeError("rel_apply_bwd: the backward kernel's grid query failed")
        _PARTIALS[key] = n
    return torch.empty(_PARTIALS[key], dtype=torch.float32, device=device)


def rel_apply_bwd_cuda(v, rel, R, dy, *, bf16=False, buckets=None):
    """Launch ``rel_bwd_kernel`` (dv, and a dR partial a block) and
    ``rel_dr_reduce_kernel`` (dR): (dv, dR). ``buckets``: the
    forward's tables for the same rel (``keep_buckets``); without them the
    bucketing kernels run first. Counts its calls in
    ``rel_apply_bwd_cuda.launches`` and the kernels in ``kernel_launches``
    (2 a call with buckets, else 4)."""
    N, D, NR = _check("rel_apply_bwd_cuda", v, rel, R)
    if tuple(dy.shape) != (N, D) or dy.dtype != torch.float32 or dy.device != v.device:
        raise ValueError("dy must be float32 (N, D) on v's device")
    dy = dy.contiguous()
    if buckets is None:
        buckets = _bucket(rel, N, D, NR, bf16)
        rel_apply_bwd_cuda.kernel_launches += 2
    elif (buckets.N, buckets.D, buckets.NR, buckets.bf16) != (N, D, NR, bool(bf16)) \
            or buckets.scratch.device != v.device:
        raise ValueError(f"rel_apply_bwd_cuda: buckets of N={buckets.N}, D={buckets.D}, "
                         f"NR={buckets.NR}, bf16={buckets.bf16} for a call of N={N}, D={D}, "
                         f"NR={NR}, bf16={bool(bf16)}")
    partials = _partials(v.device, N, D, NR, bf16)
    dv = torch.empty_like(v)
    dR = torch.empty_like(R)
    err = _lib().rel_apply_bwd(v.data_ptr(), R.data_ptr(), dy.data_ptr(), N, D, NR, int(bf16),
                               buckets.scratch.data_ptr(), partials.data_ptr(), dv.data_ptr(),
                               dR.data_ptr(), _stream(v))
    if err:
        raise RuntimeError(f"rel_apply_bwd kernel launch failed: CUDA error {err}")
    rel_apply_bwd_cuda.launches += 1
    rel_apply_bwd_cuda.launches_bf16 += bool(bf16)
    rel_apply_bwd_cuda.kernel_launches += 2
    return dv, dR


rel_apply_bwd_cuda.launches = 0
rel_apply_bwd_cuda.launches_bf16 = 0
rel_apply_bwd_cuda.kernel_launches = 0


class RelApply(torch.autograd.Function):
    """rel_apply on CUDA tensors: forward and backward are the kernels; the
    backward reuses the forward's bucket tables."""

    @staticmethod
    def forward(ctx, v, rel, R, bf16):
        ctx.bf16 = bf16
        ctx.save_for_backward(v, rel, R)
        y, ctx.buckets = rel_apply_fwd_cuda(v, rel, R, bf16=bf16, keep_buckets=True)
        return y

    @staticmethod
    def backward(ctx, dy):
        v, rel, R = ctx.saved_tensors
        dv, dR = rel_apply_bwd_cuda(v, rel, R, dy, bf16=ctx.bf16, buckets=ctx.buckets)
        return dv, None, dR, None


# ---------------------------------------------------------------- dispatcher

def width_blocks(D, block=BLOCK_D):
    """(Dp, [(lo, hi)]): the width the kernels run D at and its column
    blocks, all of one width (the kernels take square matrices), a multiple
    of 4 and at most ``block``: D zero-padded to a multiple of 4, and past
    ``block`` to the fewest such blocks."""
    Dp = -(-D // 4) * 4
    n = -(-Dp // block)
    w = -(-Dp // n // 4) * 4 if n > 1 else Dp
    return n * w, [(i * w, (i + 1) * w) for i in range(n)]


def rel_apply_blocks(v, rel, R, bf16, apply, block=BLOCK_D):
    """``apply(v, rel, R, bf16)`` (one call of the kernels, or the plain
    version in the tests) at any D: D zero-padded to ``width_blocks``'s
    width, and past ``block`` its square blocks composed, each output block
    the sum of its input blocks' products in a fixed order. Differentiable
    through ``apply``'s own backward."""
    D = v.shape[1]
    Dp, blocks = width_blocks(D, block)
    if Dp != D:
        v = F.pad(v, (0, Dp - D))
        R = F.pad(R, (0, Dp - D, 0, Dp - D))
    if len(blocks) == 1:
        y = apply(v.contiguous(), rel, R.contiguous(), bf16)
    else:
        cols = []
        for lo, hi in blocks:
            y_c = None
            for klo, khi in blocks:
                part = apply(v[:, klo:khi].contiguous(), rel,
                             R[:, lo:hi, klo:khi].contiguous(), bf16)
                y_c = part if y_c is None else y_c + part
            cols.append(y_c)
        y = torch.cat(cols, dim=1)
    return y if Dp == D else y[:, :D]


def rel_apply(v, rel, R, *, bf16):
    """v (N, D) float32, rel (N,) integer relation ids, R (NR, D, D)
    float32 -> (N, D) float32: the plain version for a CPU tensor (its
    backward written out with the kernels' rounding points), the kernels for
    a CUDA tensor, at any D through ``rel_apply_blocks``."""
    if v.device.type == "cpu":
        return _PlainRelApply.apply(v, rel, R, bool(bf16))
    return rel_apply_blocks(v, rel.to(torch.int32).contiguous(), R, bool(bf16), RelApply.apply)
