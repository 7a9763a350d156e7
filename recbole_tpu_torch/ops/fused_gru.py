"""The GRU recurrence over a whole sequence, forward and backward.

Port of recbole_tpu/ops/fused_gru.py::fused_gru (:192; Pallas kernels
``_fwd_kernel`` :53 and ``_bwd_kernel`` :64). Given the input projections
``xi = x @ wi + bi`` (computed outside, one large product), it runs the time
loop of a GRU layer, gates r, z, n in the torch convention (``_gates``
:42-50):

    hh = h @ wh + bh;  r = sigmoid(xi_r + hh_r);  z = sigmoid(xi_z + hh_z)
    n = tanh(xi_n + r * hh_n);  h = (1 - z) * n + z * h

and returns every h_t. The backward walks the time steps in reverse,
recomputes the gates from h_{t-1} (the forward's own output, h0 at t = 0)
and returns dxi, dh0, dwh and dbh.

It comes in two instances, as ``layers.gru_apply`` (JAX :228-283) computes:

* fp32 (``bf16=False``): fp32 throughout, which is ``fused_gru``'s math,
  NARM's path and GRU4Rec's under ``compute_dtype: float32``;
* bf16 (``bf16=True``): ``gru_apply``'s rounding points under a bfloat16
  compute dtype, GRU4Rec's default: ``xi`` arrives in bfloat16, both
  operands of the recurrent product (h and wh) are rounded to bfloat16 and
  summed in fp32 plus the fp32 ``bh``, the gates and the hidden carry stay
  fp32, and each output h_t is stored in bfloat16. Its backward rounds the
  cotangent that comes back through the product (``dhh @ wh^T``) to
  bfloat16 and returns ``dxi`` in bfloat16, as JAX's autodiff of the scan
  does; it keeps ``dwh`` in fp32 (JAX rounds each step's contribution, which
  a kernel that owns a slice of the batch cannot see), and it recomputes
  the gates from the bfloat16 outputs, where JAX keeps the fp32 carry. The
  tests hold it against ``gru_apply`` at a stated bfloat16 bound.

Three things live here: the plain PyTorch version ``fused_gru_torch``
(forward and a backward written out by hand with the kernels' rounding
points, wrapped for autograd); the launchers of the hand-written Hopper
kernels in ``csrc/fused_gru.cu`` (``fused_gru_fwd_cuda``,
``fused_gru_bwd_cuda``, each with a launch count) and their autograd
Function ``FusedGru``; and the dispatcher ``fused_gru``: the plain version
for CPU tensors, the kernels for CUDA tensors, nothing falling back. It
takes any B and any hidden size that device memory holds. The kernels take
H a multiple of 4; the dispatcher zero-pads any other H up to one (``pad_hidden``),
which is exact: a padded unit sees zero xi, bh, wh and h0, so r = z = 1/2,
n = tanh(0) = 0 and its h stays exactly 0 at every step, and the zero rows
of wh that it would feed the real units add exact zeros. The library
chooses one of four routes from H and the instance before launch
(``fused_gru_route``):

* up to H = 128, bf16 (GRU4Rec's default; route 4, counted in
  ``launches_tc``): tensor cores in one block. A block owns 16 sequences
  and all of wh in bf16; the recurrent products (forward, the backward's
  recompute and ``dhh @ wh^T``, dhh as two bf16 terms) run on ``mma.sync``,
  a warp owns 8 (forward) or 16 (backward) units in all three gates, so
  the gates and the carry stay in registers; one barrier a forward step and
  two a backward step, the next steps' rows prefetched by ``cp.async``;
  units past H up to the next multiple of 16 are dead units inside the
  kernel (exact, as above);
* up to H = 128, fp32 (NARM's path; route 5, counted in
  ``launches_tf32``): route 4's structure with every product fp32-exact on
  the tensor cores as 3xTF32 (each operand split into a tf32 hi and its
  exact remainder, three ``mma.sync`` a k-step), wh in fp32 once in the
  block's shared memory, xi and dout coming into registers a step ahead;
* above 128 the bf16 instance splits wh over a thread-block cluster's
  shared memory up to ``fused_gru_max_cluster_hidden`` (384; route 1,
  ``launches_cluster``), with the recurrent products on the tensor cores;
* the fp32 instance above 128, and the bf16 one above the cluster limit,
  read wh from device memory (L2; route 2), each block owning 16, 8, 4, 2
  or 1 sequences (the most whose rows fit its shared memory: 16 up to H
  700, 1 above 4,468); above ``fused_gru_max_hidden`` (7,264), where not
  even one sequence's backward rows of h, dh and dhh fit a block, a block
  owns one sequence and keeps its rows in a device-memory scratch that the
  launcher allocates (``fused_gru_rows_floats``; the forward's rows go
  there too above 19,368; route 3).

dwh is a tensor-core product at every H: dhh as two bf16 terms in the bf16
instance, 3xTF32 in the fp32 one.
"""

import ctypes

import torch
from torch.nn import functional as F

from . import cuda_build

MAX_SMEM_BYTES = 232448  # opt-in shared memory of a Hopper block


def _rounder(bf16):
    if bf16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def _gates(h_prev, xi_t, wh_r, bh, r):
    """r, z, n, hn of one step; ``wh_r`` is wh as the product reads it."""
    H = h_prev.shape[-1]
    hh = r(h_prev) @ wh_r + bh
    rr = torch.sigmoid(xi_t[:, :H] + hh[:, :H])
    z = torch.sigmoid(xi_t[:, H:2 * H] + hh[:, H:2 * H])
    n = torch.tanh(xi_t[:, 2 * H:] + rr * hh[:, 2 * H:])
    return rr, z, n, hh[:, 2 * H:]


def fused_gru_torch_fwd(xi, h0, wh, bh, bf16):
    """All hidden states (B, L, H), in bfloat16 in the bf16 instance."""
    r = _rounder(bf16)
    xi = xi.to(torch.float32)
    wh_r = r(wh)
    h = h0.to(torch.float32)
    outs = []
    for t in range(xi.shape[1]):
        rr, z, n, _ = _gates(h, xi[:, t], wh_r, bh, r)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    out = torch.stack(outs, dim=1)
    return out.to(torch.bfloat16) if bf16 else out


def fused_gru_torch_bwd(xi, h0, wh, bh, out, dout, bf16):
    """(dxi, dh0, dwh, dbh) of ``sum(out * dout)``, reading h_{t-1} from
    ``out`` (h0 at t = 0) as ``_bwd_kernel`` (:64-106) does, with the
    kernels' rounding points."""
    r = _rounder(bf16)
    xi32, out32, dout = xi.to(torch.float32), out.to(torch.float32), dout.to(torch.float32)
    h0 = h0.to(torch.float32)
    B, L, H = out.shape
    wh_r = r(wh)
    dh = torch.zeros((B, H), dtype=torch.float32, device=xi.device)
    dwh = torch.zeros((H, 3 * H), dtype=torch.float32, device=xi.device)
    dbh = torch.zeros((3 * H,), dtype=torch.float32, device=xi.device)
    dxi = torch.empty((B, L, 3 * H), dtype=torch.float32, device=xi.device)
    for t in range(L - 1, -1, -1):
        h_prev = h0 if t == 0 else out32[:, t - 1]
        rr, z, n, hn = _gates(h_prev, xi32[:, t], wh_r, bh, r)
        dh = dh + dout[:, t]
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_r = dpre_n * hn * rr * (1.0 - rr)
        dpre_z = dh * (h_prev - n) * z * (1.0 - z)
        dhh = torch.cat([dpre_r, dpre_z, dpre_n * rr], dim=1)
        dxi[:, t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
        dwh += r(h_prev).T @ dhh
        dbh += dhh.sum(dim=0)
        dh = dh * z + r(dhh @ wh_r.T)
    return dxi.to(xi.dtype), dh, dwh, dbh


class _PlainGru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, h0, wh, bh, bf16):
        out = fused_gru_torch_fwd(xi, h0, wh, bh, bf16)
        ctx.bf16 = bf16
        ctx.save_for_backward(xi, h0, wh, bh, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        xi, h0, wh, bh, out = ctx.saved_tensors
        return (*fused_gru_torch_bwd(xi, h0, wh, bh, out, dout, ctx.bf16), None)


def fused_gru_torch(xi, h0, wh, bh, bf16=False):
    """Plain version. xi (B, L, 3H) (bfloat16 in the bf16 instance, fp32
    otherwise), h0 (B, H), wh (H, 3H), bh (3H,) fp32 -> (B, L, H) in xi's
    instance's dtype. Differentiable; its backward is the hand-written one
    above."""
    return _PlainGru.apply(xi, h0, wh, bh, bool(bf16))


# ----------------------------------------------------------------- launchers

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("fused_gru")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_gru_fwd.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
        lib.fused_gru_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p, p,
                                      p]
        lib.fused_gru_rows_floats.argtypes = [i, i, i, i]
        lib.fused_gru_rows_floats.restype = ctypes.c_longlong
        lib.fused_gru_bwd_blocks.argtypes = [i, i, i, i]
        lib.fused_gru_dwh_chunks.argtypes = [i, i, i, i]
        lib.fused_gru_smem_bytes.argtypes = [i, i, i]
        lib.fused_gru_scratch_floats.argtypes = [i, i]
        lib.fused_gru_route.argtypes = [i, i]
        lib.fused_gru_cluster_plan.argtypes = [i, i, i, p]
        lib.fused_gru_cluster_floor.argtypes = [i, i, i, i, p, p]
        lib.fused_gru_dwh.argtypes = [p, p, p, i, i, i, i, p, p, p]
        for fn in (lib.fused_gru_max_hidden, lib.fused_gru_max_shared_hidden,
                   lib.fused_gru_max_cluster_hidden):
            fn.argtypes = []
        lib.fused_gru_smem_bytes.restype = ctypes.c_longlong
        lib.fused_gru_scratch_floats.restype = ctypes.c_longlong
        for fn in (lib.fused_gru_fwd, lib.fused_gru_bwd, lib.fused_gru_bwd_blocks,
                   lib.fused_gru_dwh_chunks, lib.fused_gru_max_hidden,
                   lib.fused_gru_max_shared_hidden, lib.fused_gru_max_cluster_hidden,
                   lib.fused_gru_route, lib.fused_gru_cluster_plan,
                   lib.fused_gru_cluster_floor, lib.fused_gru_dwh):
            fn.restype = i
        _LIB = lib
    return _LIB


def _check(name, xi, h0, wh, bh, bf16, backward):
    """Validate one call's tensors; returns (B, L, H)."""
    if not xi.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    want = torch.bfloat16 if bf16 else torch.float32
    if xi.dim() != 3 or xi.dtype != want or not xi.is_contiguous():
        raise ValueError(f"{name} takes a contiguous {want} (B, L, 3H) xi in the "
                         f"{'bf16' if bf16 else 'fp32'} instance, got {xi.dtype} "
                         f"{tuple(xi.shape)}")
    B, L, H3 = xi.shape
    H = H3 // 3
    if B < 1 or L < 1 or H3 != 3 * H:
        raise ValueError(f"{name} needs B >= 1, L >= 1 and a last dimension of 3H")
    for what, t, shape in (("h0", h0, (B, H)), ("wh", wh, (H, 3 * H)), ("bh", bh, (3 * H,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != xi.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 {shape} on "
                             f"{xi.device}, got {t.dtype} {tuple(t.shape)}")
    lib = _lib()
    if H % 4:
        raise ValueError(f"{name}: hidden size {H} must be a multiple of 4 (the dispatcher "
                         "fused_gru pads any other)")
    need = lib.fused_gru_smem_bytes(H, int(backward), int(bf16))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: hidden size {H} needs {need} bytes of shared memory a "
                         f"block, more than the {MAX_SMEM_BYTES} a Hopper block may use")
    return B, L, H


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(H, bf16, device):
    """Room for the global-memory route's rounded wh and its transpose;
    None on the other routes."""
    n = _lib().fused_gru_scratch_floats(H, int(bf16))
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _rows(B, H, bf16, backward, device):
    """Room for the blocks' rows when they do not fit shared memory (route
    3, above ``fused_gru_max_hidden``); None otherwise."""
    n = _lib().fused_gru_rows_floats(B, H, int(backward), int(bf16))
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def cluster_route(H, bf16):
    """Whether hidden size H (a multiple of 4) takes the cluster kernels."""
    return _lib().fused_gru_route(H, int(bf16)) == 1


def tc_route(H, bf16):
    """Whether hidden size H (a multiple of 4) takes the one-block
    tensor-core kernels (the bf16 instance up to 128)."""
    return _lib().fused_gru_route(H, int(bf16)) == 4


def tf32_route(H, bf16):
    """Whether hidden size H (a multiple of 4) takes the one-block 3xTF32
    kernels (the fp32 instance up to 128)."""
    return _lib().fused_gru_route(H, int(bf16)) == 5


def _aligned(t):
    """t, or a copy of it when its address is not 16-byte aligned (the
    kernels copy rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_gru_cluster_plan(B, H, backward):
    """The cluster route's geometry on the current card for B sequences at
    hidden size H: cluster size, rows a block, clusters in the grid,
    clusters the card holds at once, threads and shared-memory bytes a
    block."""
    plan = (ctypes.c_longlong * 6)()
    err = _lib().fused_gru_cluster_plan(B, H, int(backward), ctypes.addressof(plan))
    if err:
        raise RuntimeError(f"fused_gru_cluster_plan(B={B}, H={H}): CUDA error {err}")
    return dict(zip(("cluster_size", "rows", "clusters", "resident", "threads", "smem_bytes"),
                    plan))


def fused_gru_cluster_floor_cuda(B, L, H, device, product=False):
    """Launch ``gru_cluster_floor_kernel``: the cluster forward's L - 1 steps
    of the h exchange and the cluster barrier alone (``product``: with the
    recurrent product), on its geometry for (B, H): the per-step floor of
    the recurrence. A measurement, on no path."""
    plan = fused_gru_cluster_plan(B, H, False)
    sink = torch.empty(plan["clusters"] * plan["cluster_size"] * plan["threads"],
                       dtype=torch.float32, device=device)
    err = _lib().fused_gru_cluster_floor(B, L, H, int(product), sink.data_ptr(), _stream(sink))
    if err:
        raise RuntimeError(f"gru_cluster_floor_kernel launch failed: CUDA error {err}")
    return sink


def fused_gru_fwd_cuda(xi, h0, wh, bh):
    """Launch the forward kernel of the route (``fused_gru_fwd_tc_kernel``,
    ``fused_gru_fwd_tf32_kernel``, ``fused_gru_fwd_cluster_kernel`` or
    ``fused_gru_fwd_global_kernel``): out (B, L, H) in xi's dtype, which
    chooses the instance (bfloat16: bf16). Counts its launches in
    ``fused_gru_fwd_cuda.launches`` (``launches_fp32``: the fp32 instance's
    among them; ``launches_cluster``: the cluster route's; ``launches_tc``:
    the one-block tensor-core route's; ``launches_tf32``: the one-block
    3xTF32 route's)."""
    bf16 = xi.dtype == torch.bfloat16
    B, L, H = _check("fused_gru_fwd_cuda", xi, h0, wh, bh, bf16, False)
    xi, h0, wh, bh = (_aligned(t) for t in (xi, h0, wh, bh))
    out = torch.empty((B, L, H), dtype=xi.dtype, device=xi.device)
    scratch = _scratch(H, bf16, xi.device)
    rows = _rows(B, H, bf16, False, xi.device)
    err = _lib().fused_gru_fwd(xi.data_ptr(), h0.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                               B, L, H, int(bf16), _ptr(scratch), _ptr(rows), out.data_ptr(),
                               _stream(xi))
    if err:
        raise RuntimeError(f"fused_gru_fwd kernel launch failed: CUDA error {err}")
    fused_gru_fwd_cuda.launches += 1
    fused_gru_fwd_cuda.launches_fp32 += not bf16
    fused_gru_fwd_cuda.launches_cluster += cluster_route(H, bf16)
    fused_gru_fwd_cuda.launches_tc += tc_route(H, bf16)
    fused_gru_fwd_cuda.launches_tf32 += tf32_route(H, bf16)
    return out


fused_gru_fwd_cuda.launches = 0
fused_gru_fwd_cuda.launches_fp32 = 0
fused_gru_fwd_cuda.launches_cluster = 0
fused_gru_fwd_cuda.launches_tc = 0
fused_gru_fwd_cuda.launches_tf32 = 0


def fused_gru_bwd_cuda(xi, h0, wh, bh, out, dout):
    """Launch the backward kernel of the route, the ``dwh`` kernel
    (``gru_dwh_tc_kernel`` in the bf16 instance, ``gru_dwh_tf32_kernel`` in
    the fp32 one) and the reductions of their partials: (dxi, dh0, dwh, dbh).
    Counts its launches in ``fused_gru_bwd_cuda.launches`` (and
    ``launches_fp32``, ``launches_cluster``, ``launches_tc``,
    ``launches_tf32`` as the forward)."""
    bf16 = xi.dtype == torch.bfloat16
    B, L, H = _check("fused_gru_bwd_cuda", xi, h0, wh, bh, bf16, True)
    for what, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (B, L, H) or t.dtype != xi.dtype or t.device != xi.device:
            raise ValueError(f"fused_gru_bwd_cuda: {what} must be {xi.dtype} (B, L, H) on "
                             f"xi's device")
    xi, h0, wh, bh, out, dout = (_aligned(t.contiguous()) for t in (xi, h0, wh, bh, out, dout))
    lib = _lib()
    rec_blocks = lib.fused_gru_bwd_blocks(B, L, H, int(bf16))
    dw_chunks = lib.fused_gru_dwh_chunks(B, L, H, int(bf16))
    if rec_blocks < 1 or dw_chunks < 1:
        raise RuntimeError(f"fused_gru_bwd_cuda: no launch geometry for B={B}, L={L}, H={H}: "
                           f"CUDA error {-min(rec_blocks, dw_chunks)}")
    dev = xi.device
    dxi = torch.empty_like(xi)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dhh = torch.empty((B, L, 3 * H), dtype=torch.float32, device=dev)
    dbh_part = torch.empty((rec_blocks, 3 * H), dtype=torch.float32, device=dev)
    dwh_part = torch.empty((dw_chunks, H * 3 * H), dtype=torch.float32, device=dev)
    dwh = torch.empty((H, 3 * H), dtype=torch.float32, device=dev)
    dbh = torch.empty((3 * H,), dtype=torch.float32, device=dev)
    scratch = _scratch(H, bf16, dev)
    rows = _rows(B, H, bf16, True, dev)
    err = lib.fused_gru_bwd(xi.data_ptr(), h0.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                            out.data_ptr(), dout.data_ptr(), B, L, H, int(bf16),
                            _ptr(scratch), _ptr(rows), dxi.data_ptr(), dh0.data_ptr(),
                            dhh.data_ptr(), dbh_part.data_ptr(), dwh_part.data_ptr(),
                            dwh.data_ptr(), dbh.data_ptr(), _stream(xi))
    if err:
        raise RuntimeError(f"fused_gru_bwd kernel launch failed: CUDA error {err}")
    fused_gru_bwd_cuda.launches += 1
    fused_gru_bwd_cuda.launches_fp32 += not bf16
    fused_gru_bwd_cuda.launches_cluster += cluster_route(H, bf16)
    fused_gru_bwd_cuda.launches_tc += tc_route(H, bf16)
    fused_gru_bwd_cuda.launches_tf32 += tf32_route(H, bf16)
    return dxi, dh0, dwh, dbh


fused_gru_bwd_cuda.launches = 0
fused_gru_bwd_cuda.launches_fp32 = 0
fused_gru_bwd_cuda.launches_cluster = 0
fused_gru_bwd_cuda.launches_tc = 0
fused_gru_bwd_cuda.launches_tf32 = 0


def fused_gru_dwh_cuda(out, h0, dhh):
    """The backward's dwh product alone, as ``fused_gru_bwd_cuda`` runs it:
    sum over the rows (b, t) of h_{t-1}^T dhh (h_{t-1} read from ``out``,
    h0 at t = 0), by ``gru_dwh_tc_kernel`` for a bfloat16 ``out`` (dhh
    enters the tensor cores as two bf16 terms) or ``gru_dwh_tf32_kernel``
    for a float32 one (3xTF32), chunk partials summed in order. For the
    tests: it counts no launch of its own."""
    bf16 = out.dtype == torch.bfloat16
    B, L, H = out.shape
    if not out.is_cuda or tuple(dhh.shape) != (B, L, 3 * H) or dhh.dtype != torch.float32 \
            or tuple(h0.shape) != (B, H) or h0.dtype != torch.float32:
        raise ValueError("fused_gru_dwh_cuda takes CUDA out (B, L, H), h0 (B, H) and dhh "
                         "(B, L, 3H), the last two float32")
    lib = _lib()
    out, h0, dhh = out.contiguous(), h0.contiguous(), dhh.contiguous()
    chunks = lib.fused_gru_dwh_chunks(B, L, H, int(bf16))
    if chunks < 1:
        raise ValueError(f"fused_gru_dwh_cuda: no launch geometry for B={B}, L={L}, H={H}")
    part = torch.empty((chunks, H * 3 * H), dtype=torch.float32, device=out.device)
    dwh = torch.empty((H, 3 * H), dtype=torch.float32, device=out.device)
    err = lib.fused_gru_dwh(out.data_ptr(), h0.data_ptr(), dhh.data_ptr(), B, L, H, int(bf16),
                            part.data_ptr(), dwh.data_ptr(), _stream(out))
    if err:
        raise RuntimeError(f"fused_gru_dwh kernel launch failed: CUDA error {err}")
    return dwh


class FusedGru(torch.autograd.Function):
    """The recurrence on CUDA tensors: forward and backward are the kernels."""

    @staticmethod
    def forward(ctx, xi, h0, wh, bh):
        out = fused_gru_fwd_cuda(xi, h0, wh, bh)
        ctx.save_for_backward(xi, h0, wh, bh, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        xi, h0, wh, bh, out = ctx.saved_tensors
        return fused_gru_bwd_cuda(xi, h0, wh, bh, out, dout.to(out.dtype))


# ---------------------------------------------------------------- dispatcher

def padded_hidden(H):
    """The hidden size the kernels run for H: the next multiple of 4."""
    return -(-H // 4) * 4


def pad_hidden(xi, h0, wh, bh, Hp):
    """Zero-pad a layer of hidden size H to Hp >= H units: each gate block
    of xi and bh, h0, and both axes of wh (per gate block on the columns).
    Differentiable: the gradients of the padded tensors slice back."""
    H = wh.shape[0]
    p = Hp - H
    if not p:
        return xi, h0, wh, bh
    B, L = xi.shape[:2]
    xi = F.pad(xi.reshape(B, L, 3, H), (0, p)).reshape(B, L, 3 * Hp)
    wh = F.pad(wh.reshape(H, 3, H), (0, p, 0, 0, 0, p)).reshape(Hp, 3 * Hp)
    bh = F.pad(bh.reshape(3, H), (0, p)).reshape(3 * Hp)
    return xi, F.pad(h0, (0, p)), wh, bh


def fused_gru(xi, h0, wh, bh):
    """xi (B, L, 3H) input projections, bfloat16 for the bf16 instance or
    float32 for the fp32 one; h0 (B, H), wh (H, 3H), bh (3H,) float32.
    Returns every hidden state (B, L, H) in xi's dtype: the plain version
    for a CPU tensor, the kernels for a CUDA tensor (H zero-padded to a
    multiple of 4 around them, the outputs sliced back)."""
    if xi.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_gru takes bfloat16 or float32 xi, got {xi.dtype}")
    h0 = h0.to(torch.float32)
    if xi.device.type == "cpu":
        return fused_gru_torch(xi, h0, wh, bh, bf16=xi.dtype == torch.bfloat16)
    H = wh.shape[0]
    Hp = padded_hidden(H)
    xi, h0, wh, bh = pad_hidden(xi, h0, wh, bh, Hp)
    out = FusedGru.apply(xi.contiguous(), h0.contiguous(), wh.contiguous(), bh.contiguous())
    return out if Hp == H else out[..., :H]
