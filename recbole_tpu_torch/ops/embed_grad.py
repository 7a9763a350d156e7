"""Dense embedding gradients: ``out[v] = sum of g[r] over r with ids[r] == v``.

Port of recbole_tpu/ops/embed_grad.py. For each of its two Pallas kernels
this module holds a plain PyTorch version, the launcher of a hand-written
Hopper kernel from ``csrc/embed_grad.cu``, and a dispatcher (the plain
version for CPU tensors, the kernel for CUDA tensors, no fallback between
them):

* ``onehot_matmul_grad`` replaces ``onehot_matmul_grad`` (:78): unsorted
  ids, a vocabulary tile per block in shared memory;
* ``windowed_grad`` replaces ``windowed_grad`` (:170): the ids are sorted
  with ``torch.sort`` outside the kernel, as the JAX function sorts them in
  XLA (:181-187), and the table is swept in row windows, each row written
  once.

Both kernels are deterministic (no float atomics; a row's cotangents are
added in the order of r, exact fp32 terms where the TPU kernel adds a bf16
hi + lo pair). Ids are int64, the type the trainer uploads; int32 raises.

On top of them sit the two gathers with custom gradients:
``GroupedTakeRows`` (``grouped_take_rows``, :219-253) for the CTR family's
unified table, and ``TakeRowsDenseGrad`` (``take_rows_dense_grad``,
:256-292) for the sequential family. Their backward assembles the dense
(V, D) gradient from the two kernels: vocabularies up to
``SMALL_VOCAB_MAX`` rows go through ``onehot_matmul_grad``, larger ones
through ``windowed_grad``. The JAX package parks its windowed kernel for a
TPU-only reason (VMEM lane padding) and scatters instead, and sizes
``take_rows_dense_grad``'s small branch by a VMEM budget; the port has the
one row-count rule for both gathers.

Cotangent layout of the launchers: ``ids`` is (R,) or a (B, fs) column
block of a wider id matrix (inner stride 1), and ``g`` is (R, D) or the
matching (B, fs, D) block of a contiguous (B, F, D) cotangent; the kernels
read both in place, so ``GroupedTakeRows`` copies no cotangent. ``out``
may be a row range of the (V, D) gradient and ``id_base`` the first global
id of that range. With a column block, ``col_off`` (fs + 1 ascending global
ids on the device) promises that column f holds only ids in
[col_off[f], col_off[f + 1]); a block of the one-hot kernel then scans only
the columns that meet its rows.
"""

import ctypes
import functools

import torch

from . import cuda_build

SMALL_VOCAB_MAX = 16384
_MAX_R = 1 << 30


# ------------------------------------------------------------ plain versions

def _flat(ids, g):
    D = g.shape[-1]
    return ids.reshape(-1), g.reshape(-1, D).to(torch.float32)


def _out(out, n_rows, D, device):
    if out is None:
        return torch.empty((n_rows, D), dtype=torch.float32, device=device)
    if tuple(out.shape) != (n_rows, D) or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 ({n_rows}, {D}), got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def onehot_matmul_grad_torch(ids, g, n_rows, out=None, id_base=0, col_off=None):
    """Plain version: ``index_add_`` into zeros, the exact fp32 sum
    (``col_off`` is a hint it has no use for)."""
    ids, g = _flat(ids, g)
    out = _out(out, n_rows, g.shape[1], g.device)
    out.zero_()
    out.index_add_(0, ids - id_base, g)
    return out


def windowed_grad_torch(ids, g, n_rows, out=None, id_base=0):
    """Plain version: stable sort, then a segment sum over each run of
    equal ids (a cumulative sum differenced at the run ends)."""
    ids, g = _flat(ids, g)
    out = _out(out, n_rows, g.shape[1], g.device)
    out.zero_()
    if ids.numel() == 0:
        return out
    sids, order = torch.sort(ids, stable=True)
    csum = torch.cumsum(g[order].to(torch.float64), dim=0)
    last = torch.ones_like(sids, dtype=torch.bool)
    last[:-1] = sids[1:] != sids[:-1]
    ends = csum[last]
    seg = ends.clone()
    seg[1:] -= ends[:-1]
    out[sids[last] - id_base] = seg.to(torch.float32)
    return out


# ----------------------------------------------------------------- launchers

_LIB = None


def _lib():
    """The built library, loaded once: the step calls this twice."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("embed_grad")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.embed_grad_onehot.argtypes = [p, ll, i, p, p, ll, i, i, i, ll, i, i, p, p, p]
        lib.embed_grad_onehot.restype = i
        lib.embed_grad_onehot_splits.argtypes = [i] * 5
        lib.embed_grad_onehot_splits.restype = i
        lib.embed_grad_windowed.argtypes = [p, p, p, i, ll, i, i, i, ll, ll, p, p]
        lib.embed_grad_windowed.restype = i
        _LIB = lib
    return _LIB


def _layout(name, ids, g):
    """Validate ids and g and return (R, D, fs, ids_stride, g_stride)."""
    if not (ids.is_cuda and g.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
    if ids.device != g.device:
        raise ValueError("ids and g must share a device")
    if ids.dtype != torch.int64:
        raise TypeError(f"{name} takes int64 ids, got {ids.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes a float32 or bfloat16 g, got {g.dtype}")
    if ids.dim() not in (1, 2) or g.dim() != ids.dim() + 1 \
            or tuple(g.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"shape mismatch: ids {tuple(ids.shape)}, g {tuple(g.shape)}")
    D = g.shape[-1]
    R = ids.numel()
    if D < 1 or R >= _MAX_R:
        raise ValueError(f"{name} takes D >= 1 and fewer than 2^30 ids")
    if ids.dim() == 1:
        if R and (ids.stride(0) != 1 or g.stride() != (D, 1)):
            raise ValueError("ids (R,) and g (R, D) must be contiguous")
        return R, D, 1, 1, D
    fs = ids.shape[1]
    if R and (ids.stride(1) != 1 or g.stride(2) != 1 or g.stride(1) != D):
        raise ValueError("a (B, fs) id block needs inner stride 1 and g's "
                         "(fs, D) slab contiguous")
    return R, D, max(fs, 1), ids.stride(0), g.stride(0)


def _check_out(name, out, n_rows, D, g):
    if n_rows < 1:
        raise ValueError(f"{name} needs n_rows >= 1")
    out = _out(out, n_rows, D, g.device)
    if not out.is_cuda or out.device != g.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous CUDA tensor on g's device")
    return out


def onehot_matmul_grad_cuda(ids, g, n_rows, out=None, id_base=0, col_off=None):
    """Launch ``onehot_grad_kernel``; same contract as
    ``onehot_matmul_grad_torch``. Counts its launches in
    ``onehot_matmul_grad_cuda.launches``."""
    name = "onehot_matmul_grad_cuda"
    R, D, fs, ids_stride, g_stride = _layout(name, ids, g)
    if D > 4096 or n_rows >= 1 << 31:
        raise ValueError(f"{name} takes D <= 4096 and n_rows < 2^31")
    out = _check_out(name, out, n_rows, D, g)
    if col_off is not None and not (
            col_off.is_cuda and col_off.device == g.device and col_off.dtype == torch.int64
            and col_off.is_contiguous() and tuple(col_off.shape) == (fs + 1,)
            and ids.dim() == 2):
        raise ValueError(f"col_off must be {fs + 1} contiguous int64 ids on g's "
                         "device, beside a (B, fs) id block")
    # the source decides into how many slices the ids are cut: it knows its tiles
    splits = _lib().embed_grad_onehot_splits(R, fs, n_rows, D, int(col_off is not None))
    partials = None
    if splits > 1:
        partials = torch.empty((splits, n_rows, D), dtype=torch.float32, device=g.device)
    err = _lib().embed_grad_onehot(
        ids.data_ptr(), ids_stride, fs,
        None if col_off is None else col_off.data_ptr(), g.data_ptr(), g_stride,
        int(g.dtype == torch.bfloat16), R, D, id_base, n_rows, splits,
        None if partials is None else partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"onehot_grad kernel launch failed: CUDA error {err}")
    onehot_matmul_grad_cuda.launches += 1
    return out


onehot_matmul_grad_cuda.launches = 0


def windowed_grad_cuda(ids, g, n_rows, out=None, id_base=0):
    """Sort the ids on the device, then launch ``windowed_grad_kernel``;
    same contract as ``windowed_grad_torch``. Counts its launches in
    ``windowed_grad_cuda.launches``."""
    name = "windowed_grad_cuda"
    R, D, fs, _, g_stride = _layout(name, ids, g)
    if D > 4096:
        raise ValueError(f"{name} takes D <= 4096")
    out = _check_out(name, out, n_rows, D, g)
    # the permutation indexes the flattened (B * fs) block, which is how the
    # kernel addresses g
    sids, order = torch.sort(ids.reshape(-1), stable=True)
    err = _lib().embed_grad_windowed(
        sids.data_ptr(), order.data_ptr(), g.data_ptr(), fs, g_stride,
        int(g.dtype == torch.bfloat16), R, D, id_base, n_rows, out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"windowed_grad kernel launch failed: CUDA error {err}")
    windowed_grad_cuda.launches += 1
    return out


windowed_grad_cuda.launches = 0


# --------------------------------------------------------------- dispatchers

def onehot_matmul_grad(ids, g, n_rows, out=None, id_base=0, col_off=None):
    """ids int64, g float32 or bfloat16 -> (n_rows, D) float32 with
    duplicate ids summed. The plain version for CPU tensors, the kernel
    otherwise."""
    if g.device.type == "cpu":
        return onehot_matmul_grad_torch(ids, g, n_rows, out, id_base)
    return onehot_matmul_grad_cuda(ids, g, n_rows, out, id_base, col_off)


def windowed_grad(ids, g, n_rows, out=None, id_base=0):
    """The same function for a large vocabulary. The plain version for CPU
    tensors, the kernel otherwise."""
    if g.device.type == "cpu":
        return windowed_grad_torch(ids, g, n_rows, out, id_base)
    return windowed_grad_cuda(ids, g, n_rows, out, id_base)


# -------------------------------------------------- gathers with dense grads

@functools.lru_cache(maxsize=None)
def field_runs(field_spec):
    """Group adjacent fields of one class (small or large vocabulary) whose
    row ranges touch into runs: [(first field, end field, offset, rows,
    small)]. One kernel launch serves a run."""
    runs = []
    for f, (off, vocab) in enumerate(field_spec):
        small = vocab <= SMALL_VOCAB_MAX
        if runs:
            f0, f1, off0, rows, was_small = runs[-1]
            if was_small == small and f1 == f and off0 + rows == off:
                runs[-1] = (f0, f + 1, off0, rows + vocab, small)
                continue
        runs.append((f, f + 1, off, vocab, small))
    return runs


@functools.lru_cache(maxsize=None)
def _covers(field_spec, V):
    """Whether the fields' row ranges tile [0, V) with no gap: then the
    kernels write every row of the gradient and it needs no zero fill."""
    covered = sorted((off, off + vocab) for off, vocab in field_spec)
    return covered[0][0] == 0 and covered[-1][1] == V and all(
        a[1] == b[0] for a, b in zip(covered, covered[1:]))


_COL_OFF = {}


def _col_off(field_spec, f0, f1, device):
    """The column ranges of fields f0..f1 as a device tensor, made once per
    (spec, run, device): the backward runs every step."""
    key = (field_spec, f0, f1, device)
    if key not in _COL_OFF:
        offs = [off for off, _ in field_spec[f0:f1]]
        offs.append(field_spec[f1 - 1][0] + field_spec[f1 - 1][1])
        _COL_OFF[key] = torch.tensor(offs, dtype=torch.int64, device=device)
    return _COL_OFF[key]


class GroupedTakeRows(torch.autograd.Function):
    """``table[ids]`` for table (V, D) and ids (B, F) of global (offset) ids,
    ``field_spec`` a tuple of (offset, vocab) per column of ids. The
    backward builds the dense (V, D) gradient run by run: small-vocabulary
    runs through ``onehot_matmul_grad``, large ones through
    ``windowed_grad``, each writing its own row range."""

    @staticmethod
    def forward(ctx, field_spec, table, ids):
        ctx.field_spec = field_spec
        ctx.table_shape = tuple(table.shape)
        ctx.save_for_backward(ids)
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        V, D = ctx.table_shape
        g = g.contiguous()
        acc = (torch.empty if _covers(ctx.field_spec, V) else torch.zeros)(
            (V, D), dtype=torch.float32, device=g.device)
        for f0, f1, off, rows, small in field_runs(ctx.field_spec):
            dest = acc[off:off + rows]
            if small:
                onehot_matmul_grad(ids[:, f0:f1], g[:, f0:f1], rows, out=dest, id_base=off,
                                   col_off=_col_off(ctx.field_spec, f0, f1, g.device))
            else:
                windowed_grad(ids[:, f0:f1], g[:, f0:f1], rows, out=dest, id_base=off)
        return None, acc, None


def grouped_take_rows(field_spec, table, ids):
    return GroupedTakeRows.apply(tuple(field_spec), table, ids)


class TakeRowsDenseGrad(torch.autograd.Function):
    """``x[rows]`` for x (n, ...) and integer ``rows`` of any shape, whose
    backward materialises the dense gradient of x through the kernels."""

    @staticmethod
    def forward(ctx, n, x, rows):
        ctx.x_shape = tuple(x.shape)
        ctx.save_for_backward(rows)
        return x[rows]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        n = ctx.x_shape[0]
        d = 1
        for s in ctx.x_shape[1:]:
            d *= s
        fn = onehot_matmul_grad if n <= SMALL_VOCAB_MAX else windowed_grad
        out = fn(rows.reshape(-1), g.reshape(-1, d).contiguous(), n)
        return None, out.reshape(ctx.x_shape), None


def take_rows_dense_grad(n, x, rows):
    return TakeRowsDenseGrad.apply(n, x, rows)
