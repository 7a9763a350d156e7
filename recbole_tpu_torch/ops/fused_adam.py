"""Single-pass in-place Adam over every float32 leaf of a training step.

Port of recbole_tpu/ops/fused_adam.py. What lives here:

* ``adam_leaf_torch``, the plain PyTorch version of the math of
  ``trainer.py:335-337`` (and of the Pallas kernel ``adam_leaf_kernel``),
  with JAX's bias-correction arrangement
  ``p' = p - lr * (m' c1) / (sqrt(v' c2) + eps)``, c1 = 1/(1-b1^t),
  c2 = 1/(1-b2^t) — not torch.optim.Adam's; a nonzero ``wd`` first adds
  ``wd * p`` to the gradient, the coupled L2 decay of the JAX package's
  ``optax.add_decayed_weights`` before ``optax.adam`` (trainer.py:64-75),
  after the zero head and a missing gradient have been read as zeros, as
  the JAX chain decays after zeroing the [PAD] row's gradient; before
  that, ``clip=(norm, max_norm)`` scales the gradient as
  ``optax.clip_by_global_norm`` does (``(g / norm) * max_norm``, unless
  ``norm < max_norm``; ``norm`` a 0-dim tensor on the leaves' device, the
  step's global gradient norm, see ``global_grad_norm``; over a step's
  leaves, ``norm`` None has it computed there from the gradients), and after the
  Adam scaling ``dwd``, adamw's decoupled decay, adds ``(lr * dwd) * p`` to
  the update (optax.adamw's order: scale_by_adam, add_decayed_weights,
  then the learning rate);
* ``AdamLeaves``, a step's leaves without their gradients: p, m and v of
  each, and its ``zero_head``, the number of leading elements whose
  gradient counts as zero (the [PAD] row of a ``pad_zero_params`` table).
  Built once per optimizer state; on the card it also holds the kernel's
  leaf table, of which only the gradients' column changes from step to step;
* ``adam_multi_torch``, the plain version over all leaves: ``adam_leaf_torch``
  per leaf, a gradient of None read as zeros and the head as zero;
* ``adam_multi_cuda``, the launcher of the hand-written kernel in
  ``csrc/fused_adam.cu``, which replaces ``adam_leaf_kernel`` (:75): one
  launch sweeps every leaf of the step;
* ``grad_norm_cuda``, the clip's global norm by that file's two norm
  kernels over the same leaf table (the plain version is
  ``global_grad_norm``), which ``adam_multi_cuda`` launches itself for
  ``clip=(None, max_norm)``;
* ``adam_multi``, the dispatcher: the plain version for CPU tensors, the
  kernel for CUDA tensors, and no fallback between them; ``adam_leaf``, its
  one-leaf form.

All update ``p``, ``m`` and ``v`` in place. This is where the port departs
from JAX's functional update, which returns new arrays. The JAX package's
gates (the RECBOLE_TPU_PALLAS_ADAM variable and MIN_ELEMS = 1 << 20) are TPU
measurements and are dropped: the kernel runs for every float32 leaf. c1 and
c2 are computed on the host from the integer step count, so nothing waits
on the device.
"""

import contextlib
import ctypes

import numpy as np
import torch

from . import cuda_build

# csrc/fused_adam.cu's Leaf record, and its chunk and parameter-block sizes
LEAF_DTYPE = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("g", "<u8"),
                       ("n", "<i8"), ("zero_head", "<i8"), ("chunk_start", "<i4"),
                       ("vec", "<i4")])
CHUNK = 2048
MAX_LEAVES = 512

_LIB = None


def adam_leaf_torch(p, m, v, g, c1, c2, *, b1, b2, lr, eps, wd=0.0, clip=None, dwd=0.0):
    with torch.no_grad():
        if clip is not None:
            g = clip_grad(g, *clip)
        if wd:
            g = g + wd * p
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * g * g
        upd = lr * (m2 * c1) / (torch.sqrt(v2 * c2) + eps)
        if dwd:
            upd = upd + (lr * dwd) * p
        p2 = p - upd
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    return p, m, v


def clip_grad(g, norm, max_norm):
    """``g`` scaled as optax.clip_by_global_norm scales a leaf: ``(g /
    norm) * max_norm`` (two roundings), or ``g`` itself when ``norm <
    max_norm``. ``norm`` is a 0-dim tensor: nothing waits on the device."""
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def global_grad_norm(grads, zero_heads):
    """The global L2 norm of a step's gradients (None: a zero gradient),
    each leaf's first ``zero_heads`` elements left out, as a 0-dim float32
    tensor on their device (parity: optax.global_norm over the trainable
    leaves after the [PAD] rows' gradients are zeroed, trainer.py:383-385,
    :60-63); None when every gradient is None (a norm of 0: nothing to
    clip). The plain version of ``grad_norm_cuda``; the plain learners'
    norm on any device."""
    parts = [g.reshape(-1)[head:] if head else g for g, head in zip(grads, zero_heads)
             if g is not None]
    if not parts:
        return None
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(parts)))


def leaf_table(addresses, numels, zero_heads):
    """The kernel's leaf records for leaves of ``numels`` elements whose p,
    m and v lie at ``addresses`` ((p, m, v) each): leaves of no element are
    left out. Returns (table, rows, groups): ``rows`` the leaf index of each
    record, ``groups`` (first record, records, chunks) of each launch, at most
    MAX_LEAVES records each, chunk_start counted from the group's first."""
    rows = [i for i, n in enumerate(numels) if n > 0]
    table = np.zeros(len(rows), LEAF_DTYPE)
    groups = []
    for first in range(0, len(rows), MAX_LEAVES):
        chunks = 0
        for j in range(first, min(first + MAX_LEAVES, len(rows))):
            i = rows[j]
            p, m, v = addresses[i]
            table[j] = (p, m, v, 0, numels[i], zero_heads[i], chunks,
                        int(p % 16 == 0 and m % 16 == 0 and v % 16 == 0))
            chunks += -(-numels[i] // CHUNK)
        groups.append((first, min(MAX_LEAVES, len(rows) - first), chunks))
    return table, rows, groups


class AdamLeaves:
    """p, m and v of each leaf (updated in place) and its ``zero_head``;
    ``zero_heads`` defaults to 0 for every leaf. The kernel's table is built
    at the first CUDA call and reads these tensors' addresses then: build a
    new AdamLeaves when any of them is replaced."""

    def __init__(self, params, mu, nu, zero_heads=None):
        self.p, self.m, self.v = list(params), list(mu), list(nu)
        self.zero_head = ([0] * len(self.p) if zero_heads is None
                          else [int(h) for h in zero_heads])
        if not len(self.p) == len(self.m) == len(self.v) == len(self.zero_head):
            raise ValueError("params, mu, nu and zero_heads must have one length")
        self._table = None

    def __len__(self):
        return len(self.p)

    @property
    def device(self):
        return self.p[0].device if self.p else torch.device("cpu")

    def cuda_table(self):
        """The kernel's table of these leaves, after checking every p, m and
        v: CUDA, one device, float32, contiguous, one shape a leaf, and the
        head inside the leaf. Built once."""
        if self._table is None:
            dev = self.device
            for i, (p, m, v, head) in enumerate(zip(self.p, self.m, self.v, self.zero_head)):
                _check_leaf(f"leaf {i}", (p, m, v), dev, p.shape)
                if not 0 <= head <= p.numel():
                    raise ValueError(f"leaf {i}: zero_head {head} outside its "
                                     f"{p.numel()} elements")
            self._table = _CudaTable(dev.index, [p.shape for p in self.p], *leaf_table(
                [(p.data_ptr(), m.data_ptr(), v.data_ptr())
                 for p, m, v in zip(self.p, self.m, self.v)],
                [p.numel() for p in self.p], self.zero_head))
        return self._table


class _CudaTable:
    """A leaf table on the host, with the array of gradient addresses that
    each call writes and the kernel's launcher copies in."""

    def __init__(self, dev, shapes, table, rows, groups):
        self.dev, self.table, self.rows, self.groups = dev, table, rows, groups
        self.shapes = [shapes[i] for i in rows]
        self.grads = np.zeros(len(rows), np.uint64)
        self.address, self.grads_address = table.ctypes.data, self.grads.ctypes.data
        self.chunks = sum(chunks for _, _, chunks in groups)

    def set_grads(self, leaves, grads):
        """Write the step's gradient addresses (0 for None) after checking
        each gradient; returns whether any is present."""
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} leaves")
        dev, gptr = self.dev, []
        for i, shape in zip(self.rows, self.shapes):
            g = grads[i]
            if g is None:
                gptr.append(0)
                continue
            if (g.get_device() != dev or g.dtype != torch.float32 or g.shape != shape
                    or not g.is_contiguous()):
                _check_leaf(f"gradient {i}", (g,), leaves.p[i].device, shape)
            gptr.append(g.data_ptr())
        self.grads[:] = gptr
        return any(gptr)


def _check_leaf(what, tensors, dev, shape):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"adam_multi_cuda needs CUDA tensors ({what})")
        if t.device != dev:
            raise ValueError(f"adam_multi_cuda: {what} is not on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"adam_multi_cuda takes float32 leaves ({what}: {t.dtype})")
        if t.shape != shape:
            raise ValueError(f"adam_multi_cuda: {what} has shapes {tuple(t.shape)} "
                             f"and {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adam_multi_cuda: {what} must be contiguous")


def adam_multi_torch(leaves, grads, c1, c2, *, b1, b2, lr, eps, wd=0.0, clip=None, dwd=0.0):
    """One Adam step over every leaf of ``leaves`` (an AdamLeaves), with
    ``grads`` one gradient a leaf, None for a zero gradient; ``clip=(None,
    max_norm)`` clips by ``global_grad_norm`` of these gradients (no clip
    when every gradient is None)."""
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradients for {len(leaves)} leaves")
    if clip is not None and clip[0] is None:
        norm = global_grad_norm(grads, leaves.zero_head)
        clip = None if norm is None else (norm, clip[1])
    for p, m, v, head, g in zip(leaves.p, leaves.m, leaves.v, leaves.zero_head, grads):
        if g is None:
            g = torch.zeros_like(p)
        elif head:
            flat = g.reshape(-1).clone()
            flat[:head] = 0.0
            g = flat.view(p.shape)
        adam_leaf_torch(p, m, v, g, c1, c2, b1=b1, b2=b2, lr=lr, eps=eps, wd=wd, clip=clip,
                        dwd=dwd)
    return leaves


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("fused_adam")
        if lib.adam_multi_chunk() != CHUNK or lib.adam_multi_max_leaves() != MAX_LEAVES:
            raise RuntimeError("csrc/fused_adam.cu's chunk or leaf limit differs from "
                               "ops/fused_adam.py's")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adam_multi_f32.argtypes = [p, p, i, i] + [f] * 9 + [p, f, f, p]
        lib.adam_grad_sq_f32.argtypes = [p, p, i, i, p, p]
        lib.adam_grad_norm_finish_f32.argtypes = [p, i, p, p]
        for fn in (lib.adam_multi_f32, lib.adam_grad_sq_f32, lib.adam_grad_norm_finish_f32):
            fn.restype = i
        _LIB = lib
    return _LIB


def _on_device(dev):
    """The launch goes to the current device: switch only when it is another."""
    return (torch.cuda.device(dev) if torch.cuda.current_device() != dev
            else contextlib.nullcontext())


def adam_multi_cuda(leaves, grads, c1, c2, *, b1, b2, lr, eps, wd=0.0, clip=None, dwd=0.0):
    """Launch the CUDA kernel over every leaf of ``leaves``, on CUDA tensors;
    same contract as ``adam_multi_torch``. One launch, or one for each
    MAX_LEAVES leaves; with ``clip=(None, max_norm)`` the norm kernels
    first (as ``grad_norm_cuda``, on the same gradient addresses). Counts
    its launches in ``adam_multi_cuda.launches``."""
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradients for {len(leaves)} leaves")
    tab = leaves.cuda_table()
    if not tab.rows:
        return leaves
    present = tab.set_grads(leaves, grads)
    norm_ptr, max_norm = None, 0.0
    if clip is not None:
        norm, max_norm = clip
        if norm is None:
            norm = _launch_norm(tab, leaves.device) if present else None
        elif (not norm.is_cuda or norm.get_device() != tab.dev
              or norm.dtype != torch.float32 or norm.numel() != 1):
            raise ValueError("adam_multi_cuda: the clip's norm must be one float32 on the "
                             "leaves' device")
        norm_ptr = None if norm is None else norm.data_ptr()
    fn = _lib().adam_multi_f32
    scalars = (c1, c2, b1, 1.0 - b1, b2, 1.0 - b2, lr, eps, wd, norm_ptr, max_norm, lr * dwd)
    with _on_device(tab.dev):
        stream = torch.cuda.current_stream(tab.dev).cuda_stream
        for first, count, chunks in tab.groups:
            err = fn(tab.address + first * LEAF_DTYPE.itemsize, tab.grads_address + first * 8,
                     count, chunks, *scalars, stream)
            if err:
                raise RuntimeError(f"adam_multi kernel launch failed: CUDA error {err}")
            adam_multi_cuda.launches += 1
    return leaves


adam_multi_cuda.launches = 0


def grad_norm_cuda(leaves, grads):
    """``global_grad_norm(grads, leaves.zero_head)`` by the kernels in
    ``csrc/fused_adam.cu``, on CUDA tensors: over the leaves' table (built
    once), one launch that writes each chunk's sum of squares (one for each
    MAX_LEAVES leaves), then one that sums them in a fixed order and takes
    the root, so the host does no per-leaf tensor work. A new 0-dim float32
    tensor, or None when every gradient is None. It differs from the plain
    version by rounding only (another order of the fp32 sums). Counts its
    launches in ``grad_norm_cuda.launches``."""
    tab = leaves.cuda_table()
    if not tab.rows or not tab.set_grads(leaves, grads):
        return None
    return _launch_norm(tab, leaves.device)


def _launch_norm(tab, device):
    """The norm kernels over ``tab`` and the gradient addresses it holds."""
    lib = _lib()
    partial = torch.empty(tab.chunks, dtype=torch.float32, device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    with _on_device(tab.dev):
        stream = torch.cuda.current_stream(tab.dev).cuda_stream
        at = 0
        for first, count, chunks in tab.groups:
            err = lib.adam_grad_sq_f32(tab.address + first * LEAF_DTYPE.itemsize,
                                       tab.grads_address + first * 8, count, chunks,
                                       partial.data_ptr() + 4 * at, stream)
            if err:
                raise RuntimeError(f"adam_grad_sq kernel launch failed: CUDA error {err}")
            at += chunks
            grad_norm_cuda.launches += 1
        err = lib.adam_grad_norm_finish_f32(partial.data_ptr(), at, norm.data_ptr(), stream)
        if err:
            raise RuntimeError(f"adam_grad_norm_finish kernel launch failed: CUDA error {err}")
        grad_norm_cuda.launches += 1
    return norm


grad_norm_cuda.launches = 0


def adam_multi(leaves, grads, c1, c2, *, b1, b2, lr, eps, wd=0.0, clip=None, dwd=0.0):
    """Dispatcher: the plain version for CPU tensors, the kernel otherwise."""
    fn = adam_multi_torch if leaves.device.type == "cpu" else adam_multi_cuda
    return fn(leaves, grads, c1, c2, b1=b1, b2=b2, lr=lr, eps=eps, wd=wd, clip=clip, dwd=dwd)


def adam_leaf(p, m, v, g, c1, c2, *, b1, b2, lr, eps, wd=0.0, clip=None, dwd=0.0):
    """One leaf through the dispatcher."""
    adam_multi(AdamLeaves([p], [m], [v]), [g], c1, c2, b1=b1, b2=b2, lr=lr, eps=eps, wd=wd,
               clip=clip, dwd=dwd)
    return p, m, v
