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
for a CUDA tensor, nothing falling back. The kernels bucket the rows by
relation on the device and sum dR from per-tile partials in order, so two
runs give the same bits. Limits (from the built library): D a multiple of 4
and at most 128, NR at most 16,383; else it raises.
"""

import ctypes

import torch

from . import cuda_build


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


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("rel_apply")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rel_apply_fwd.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.rel_apply_bwd.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p]
        lib.rel_apply_scratch_ints.argtypes = [i, i, i]
        lib.rel_apply_partial_floats.argtypes = [i, i, i]
        lib.rel_apply_max_width.argtypes = []
        lib.rel_apply_max_relations.argtypes = []
        lib.rel_apply_scratch_ints.restype = ctypes.c_longlong
        lib.rel_apply_partial_floats.restype = ctypes.c_longlong
        for fn in (lib.rel_apply_fwd, lib.rel_apply_bwd, lib.rel_apply_max_width,
                   lib.rel_apply_max_relations):
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


def _scratch(N, D, NR, device):
    n = _lib().rel_apply_scratch_ints(N, D, NR)
    return torch.empty(n, dtype=torch.int32, device=device)


def rel_apply_fwd_cuda(v, rel, R, *, bf16=False):
    """Launch the bucketing kernels and ``rel_rows_kernel``: y (N, D)
    float32. Counts its launches in ``rel_apply_fwd_cuda.launches``
    (``launches_bf16``: the bf16 instance's among them)."""
    N, D, NR = _check("rel_apply_fwd_cuda", v, rel, R)
    y = torch.empty_like(v)
    scratch = _scratch(N, D, NR, v.device)
    err = _lib().rel_apply_fwd(v.data_ptr(), rel.data_ptr(), R.data_ptr(), N, D, NR, int(bf16),
                               scratch.data_ptr(), y.data_ptr(), _stream(v))
    if err:
        raise RuntimeError(f"rel_apply_fwd kernel launch failed: CUDA error {err}")
    rel_apply_fwd_cuda.launches += 1
    rel_apply_fwd_cuda.launches_bf16 += bool(bf16)
    return y


rel_apply_fwd_cuda.launches = 0
rel_apply_fwd_cuda.launches_bf16 = 0


def rel_apply_bwd_cuda(v, rel, R, dy, *, bf16=False):
    """Launch the bucketing kernels, ``rel_rows_kernel`` on R^T (dv),
    ``rel_dr_tile_kernel`` and ``rel_dr_reduce_kernel`` (dR): (dv, dR).
    Counts its launches in ``rel_apply_bwd_cuda.launches``."""
    N, D, NR = _check("rel_apply_bwd_cuda", v, rel, R)
    if tuple(dy.shape) != (N, D) or dy.dtype != torch.float32 or dy.device != v.device:
        raise ValueError("dy must be float32 (N, D) on v's device")
    dy = dy.contiguous()
    lib = _lib()
    scratch = _scratch(N, D, NR, v.device)
    partials = torch.empty(lib.rel_apply_partial_floats(N, D, NR), dtype=torch.float32,
                           device=v.device)
    dv = torch.empty_like(v)
    dR = torch.empty_like(R)
    err = lib.rel_apply_bwd(v.data_ptr(), rel.data_ptr(), R.data_ptr(), dy.data_ptr(), N, D, NR,
                            int(bf16), scratch.data_ptr(), partials.data_ptr(), dv.data_ptr(),
                            dR.data_ptr(), _stream(v))
    if err:
        raise RuntimeError(f"rel_apply_bwd kernel launch failed: CUDA error {err}")
    rel_apply_bwd_cuda.launches += 1
    rel_apply_bwd_cuda.launches_bf16 += bool(bf16)
    return dv, dR


rel_apply_bwd_cuda.launches = 0
rel_apply_bwd_cuda.launches_bf16 = 0


class RelApply(torch.autograd.Function):
    """rel_apply on CUDA tensors: forward and backward are the kernels."""

    @staticmethod
    def forward(ctx, v, rel, R, bf16):
        ctx.bf16 = bf16
        ctx.save_for_backward(v, rel, R)
        return rel_apply_fwd_cuda(v, rel, R, bf16=bf16)

    @staticmethod
    def backward(ctx, dy):
        v, rel, R = ctx.saved_tensors
        dv, dR = rel_apply_bwd_cuda(v, rel, R, dy, bf16=ctx.bf16)
        return dv, None, dR, None


# ---------------------------------------------------------------- dispatcher

def rel_apply(v, rel, R, *, bf16):
    """v (N, D) float32, rel (N,) integer relation ids, R (NR, D, D)
    float32 -> (N, D) float32: the plain version for a CPU tensor (its
    backward written out with the kernels' rounding points), the kernels for
    a CUDA tensor."""
    if v.device.type == "cpu":
        return _PlainRelApply.apply(v, rel, R, bool(bf16))
    return RelApply.apply(v.contiguous(), rel.to(torch.int32).contiguous(), R.contiguous(),
                          bool(bf16))
