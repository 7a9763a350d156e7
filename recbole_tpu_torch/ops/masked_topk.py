"""Fused masked score + top-k for full-sort evaluation.

Port of recbole_tpu/ops/masked_topk.py. Here live:

* ``masked_topk_torch``, the plain PyTorch version of ``masked_topk_xla``
  (:35-40): materialise the (B, N) scores, mask, and take the top k with
  ties going to the lower item id as ``lax.top_k`` breaks them (a stable
  descending sort, not ``torch.topk``, whose tie order is unspecified);
* ``masked_topk_plan``, the kernel's launch plan: row tiles of 16, 32 or
  64 queries by slices of the item axis;
* ``masked_topk_cuda``, the launcher of the hand-written Hopper kernel in
  ``csrc/masked_topk.cu``, which replaces ``masked_topk_pallas`` (:94): its
  fp32 instance (3xTF32 products) for float32 operands, its bf16-operand
  instance (bf16 ``mma.sync``, fp32 sums) for bfloat16 ones, which
  ``eval_score_dtype: bfloat16`` gives it;
* ``masked_topk``, the dispatcher: the plain version for CPU tensors, the
  kernel for CUDA tensors (D zero-padded to a multiple of 4 around it: the
  scores are unchanged), and no fallback between them;
* ``masked_topk_fits``, the route the trainer takes before launch: a width
  past 512 or a k past 128 goes to its non-fused step (scores, mask,
  ``torch.topk``), as the JAX package's ``masked_topk`` has no such limit.
"""

import ctypes
from typing import NamedTuple

import torch
from torch.nn import functional as F

from . import cuda_build

NEG_INF = -1e15
K_CAP = 128  # the kernel keeps at most 128 entries per row
MAX_D = 512  # the widest query the kernel takes (a multiple of 4)
TN = 64  # items a tile
STAGES = 3  # the kernel's staging ring
MAX_MERGE = 512  # S k at most: a row's slice lists are merged in shared memory
MAX_SLICES = 16
BLOCK_SMEM = 232448  # the most shared memory a block takes on the H100
H100_SMS = 132


def masked_topk_torch(query, items, invalid_mask, k):
    """query (B, D), items (N, D), both float32 or both bfloat16,
    invalid_mask (B, N) int8 -> top-k.

    Returns (values (B, k) f32, ids (B, k) int32); masked entries score
    NEG_INF. bfloat16 operands are widened to float32 first: their products
    are exact there and summed in fp32, as ``jnp.dot(...,
    preferred_element_type=float32)`` sums them."""
    scores = query.to(torch.float32) @ items.to(torch.float32).T
    scores = torch.where(invalid_mask > 0,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device), scores)
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


# ------------------------------------------------------------------ the plan

def masked_topk_smem(mt, D, k, esize=4):
    """A block's shared memory with 16 ``mt`` query rows at width D and lists
    of k (csrc/masked_topk.cu::smem_bytes), for operands of ``esize`` bytes
    (4 fp32, 2 bf16; v = 16 / esize elements a 16-byte copy): the query tile
    (D padded to a multiple of 2 v, plus v elements a row), the ring of 3
    stages (64 item rows of 64 + v elements and a mask row of 80 bytes a
    query row, a stage), two score tiles (72 floats a query row each), each
    row's k-th entry and two flags, the lists (k entries of 8 bytes a row)
    and the block's flag."""
    v = 16 // esize
    bm, dp = 16 * mt, -(-D // (2 * v)) * 2 * v
    return (esize * bm * (dp + v) + STAGES * (TN * (64 + v) * esize + bm * 80)
            + 8 * bm * (TN + 8) + 16 * bm + 8 * bm * k + 16)


class MaskedTopkPlan(NamedTuple):
    mt: int  # a block's query rows in m16 tiles: 16 mt rows
    row_tiles: int  # ceil(B / (16 mt)): the grid's x
    slices: int  # S, the grid's y: the item axis in S slices of whole tiles
    smem: int  # bytes of shared memory a block (one block an SM)

    def slice_items(self, N):
        """[(first item, end)] of each slice, as the kernel cuts them: tiles
        of 64 items, slice s taking tiles [s T / S, (s + 1) T / S)."""
        T = (N + TN - 1) // TN
        S = self.slices
        return [(s * T // S * TN, min(N, (s + 1) * T // S * TN)) for s in range(S)]


def masked_topk_plan(B, N, D, k, sms=H100_SMS, esize=4):
    """The launch plan at (B, N, D, k) on a card of ``sms`` SMs, one block
    an SM (768 or 1,024 threads, the kernel's launch bounds): the tallest
    block (64, 32 or 16 query rows) whose shared memory fits and whose row
    tiles need at most 4 slices to fill the card, and S the most slices
    that keep the grid within one wave, at most one a tile of 64 items, 16
    in all, and with S k <= 512 for the merge. 16 rows always fit (115 KB
    at D 512, k 128)."""
    tiles = (N + TN - 1) // TN
    for mt in (4, 2, 1):
        smem = masked_topk_smem(mt, D, k, esize)
        rows = (B + 16 * mt - 1) // (16 * mt)
        if smem <= BLOCK_SMEM and sms // rows <= 4:
            break
    S = max(1, min(sms // rows, tiles, MAX_SLICES, MAX_MERGE // k))
    return MaskedTopkPlan(mt, rows, S, smem)


# ----------------------------------------------------------------- launcher

_LIB = None
# per device index: its SM count
_SMS = {}
# one int32 ticket per row tile, per (device, stream): zero when made, and
# zero again after each call (a row tile's last block resets its own);
# never freed, also when a longer one replaces it (a captured CUDA graph may
# still use it)
_TICKETS = {}
_RETIRED = []
# per (device index, B, N, D, k): its plan
_PLANS = {}


def _lib():
    """The built library, loaded once: a call reads and hashes no file."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("masked_topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.masked_topk_f32, lib.masked_topk_bf16):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p]
            fn.restype = i
        _LIB = lib
    return _LIB


def _plan(device, B, N, D, k, esize):
    key = (device.index, B, N, D, k, esize)
    plan = _PLANS.get(key)
    if plan is None:
        sms = _SMS.get(device.index)
        if sms is None:
            sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
        plan = _PLANS[key] = masked_topk_plan(B, N, D, k, sms, esize)
    return plan


def _tickets(device, stream, rows):
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < rows:
        if t is not None:
            _RETIRED.append(t)
        t = _TICKETS[key] = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
    return t


def masked_topk_cuda(query, items, invalid_mask, k):
    """Launch the CUDA kernel on CUDA tensors; same contract as
    ``masked_topk_torch``. Counts its calls in ``masked_topk_cuda.launches``
    (one kernel a call)."""
    if not (query.is_cuda and items.is_cuda and invalid_mask.is_cuda):
        raise ValueError("masked_topk_cuda needs CUDA tensors")
    device = query.device
    if not (device == items.device == invalid_mask.device):
        raise ValueError("query, items and invalid_mask must share a device")
    if query.dtype != items.dtype or query.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("masked_topk_cuda takes float32 or bfloat16 query and items, "
                        f"one type (got {query.dtype}, {items.dtype})")
    esize = query.element_size()
    if invalid_mask.dtype != torch.int8:
        raise TypeError("masked_topk_cuda takes an int8 invalid_mask")
    if query.dim() != 2 or items.dim() != 2 or invalid_mask.dim() != 2:
        raise ValueError("query, items and invalid_mask must be 2-D")
    B, D = query.shape
    N = items.shape[0]
    if items.shape[1] != D or tuple(invalid_mask.shape) != (B, N):
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, items "
                         f"{tuple(items.shape)}, mask {tuple(invalid_mask.shape)}")
    if not 1 <= k <= min(K_CAP, N):
        raise ValueError(f"k={k} must lie in [1, min({K_CAP}, n_items={N})]")
    if D % (16 // esize) or D > MAX_D:
        raise ValueError(f"embedding width {D} must be a multiple of {16 // esize} "
                         f"({query.dtype}), at most {MAX_D}")
    for name, t in (("query", query), ("items", items), ("invalid_mask", invalid_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if query.data_ptr() % 16 or items.data_ptr() % 16:
        raise ValueError("query and items must be 16-byte aligned")
    plan = _plan(device, B, N, D, k, esize)
    stream = torch.cuda.current_stream(device).cuda_stream
    vals = torch.empty((B, k), dtype=torch.float32, device=device)
    ids = torch.empty((B, k), dtype=torch.int32, device=device)
    part = tickets = None
    if plan.slices > 1:
        part = torch.empty(2 * plan.slices * B * k, dtype=torch.float32, device=device)
        tickets = _tickets(device, stream, plan.row_tiles)
    fn = _lib().masked_topk_f32 if esize == 4 else _lib().masked_topk_bf16
    err = fn(
        query.data_ptr(), items.data_ptr(), invalid_mask.data_ptr(), B, N, D, k,
        plan.mt, plan.slices, vals.data_ptr(), ids.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), stream)
    if err:
        raise RuntimeError(f"masked_topk kernel launch failed: CUDA error {err}")
    masked_topk_cuda.launches += 1
    return vals, ids


masked_topk_cuda.launches = 0


def padded_width(D, esize=4):
    """The width the kernel runs for D: the next multiple of 4 (fp32) or
    8 (bf16), a 16-byte copy."""
    v = 16 // esize
    return -(-D // v) * v


def masked_topk_fits(D, k):
    """Whether the kernel takes a query of width D (once padded) and k."""
    return 1 <= k <= K_CAP and padded_width(D, 2) <= MAX_D


def pad_width(query, items):
    """Zero-pad the query's and the items' columns to ``padded_width``:
    every score keeps its value (the extra terms are 0 x 0)."""
    p = padded_width(query.shape[1], query.element_size()) - query.shape[1]
    if not p:
        return query, items
    return F.pad(query, (0, p)).contiguous(), F.pad(items, (0, p)).contiguous()


def masked_topk(query, items, invalid_mask, k):
    """Dispatcher: the plain version for CPU tensors, the kernel otherwise
    (D zero-padded to a multiple of 4 first)."""
    if query.device.type == "cpu":
        return masked_topk_torch(query, items, invalid_mask, k)
    return masked_topk_cuda(*pad_width(query, items), invalid_mask, k)
