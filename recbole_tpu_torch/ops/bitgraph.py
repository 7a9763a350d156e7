"""Batch-restricted adjacency applications over a packed-bit interaction
matrix, and the LightGCN training step with two full applications.

Port of recbole_tpu/ops/bitgraph.py. A_hat = D_u^-1/2 B D_i^-1/2 with B
binary, and A_hat is linear, so an L-layer step needs only the batch rows S
of the layer mean (forward) and a cotangent that is non-zero at S only
(backward). The outermost application in each direction touches S alone:

  fwd:  t1 = A x (full);  e[S] = (x[S] + t1[S] + A[S, :] t1) / 3
  bwd:  q = A[:, S] g_S;   d_x = (g~ + q + A q (full)) / 3

A[S, :] and A[:, S] come from packed-bit images of B, one per side:
``restricted_rows_apply`` runs the row product and ``restricted_cols_apply``
its transpose through the kernels of ops/bit_kernels.py, on every shape
(the JAX package takes its kernel only on a TPU and at multiples of 256).
The rounding points are the JAX package's: ``v * col_norm`` and
``g * row_norm`` are rounded to bf16, the bits are exact, the sums fp32.

The dense gradients of the step's gathers go through ops/embed_grad.py's
``dense_row_grad``: deterministic, no scatter.
The images are non-persistent buffers of ``BitRestrictedGraph``.
"""

import time

import numpy as np
import torch
from torch import nn

from .bit_kernels import bit_cols_matmul, bit_rows_matmul
from .embed_grad import dense_row_grad

# The packed images are dense in the node grid, ~2 * n_users * n_items / 8
# bytes: Yelp (102K x 98K) takes 2 x 1.26 GB. The step is chosen only under
# this budget.
BITGRAPH_BUDGET_BYTES = 4 << 30


def bitgraph_bytes(n_users, n_items):
    """Footprint of BitRestrictedGraph's two packed images."""
    ubytes = -(-(-(-n_items // 8)) // 256) * 256
    ibytes = -(-(-(-n_users // 8)) // 256) * 256
    return n_users * ubytes + n_items * ibytes


def side_counts(major, minor, n_major, n_minor):
    """The set bits of each row of ``_pack_side``'s image, (n_major,) int32:
    the distinct minor ids of each major id."""
    pairs = np.unique(major.astype(np.int64) * n_minor + minor)
    return np.bincount(pairs // n_minor, minlength=n_major).astype(np.int32)


def _pack_side(major, minor, n_major, n_minor):
    """Packed-bit matrix (n_major, nbytes) uint8 with bit (minor % 8) of byte
    (major, minor // 8) set for each edge; nbytes is ceil(n_minor / 8)
    rounded up to a multiple of 256, as in the JAX package."""
    nbytes = -(-n_minor // 8)
    nbytes = -(-nbytes // 256) * 256
    packed = np.zeros((n_major, nbytes), np.uint8)
    np.bitwise_or.at(packed, (major, minor // 8), (1 << (minor % 8)).astype(np.uint8))
    return packed


class BitRestrictedGraph(nn.Module):
    """Packed-bit images of B, one per major axis (``bg_user_bits``
    (n_users, ~n_items / 8), ``bg_item_bits`` (n_items, ~n_users / 8)), the
    D^-1/2 vectors ``bg_unorm``/``bg_inorm``, and each image's set bits a row
    (``bg_user_counts``, ``bg_item_counts``, int32: the row kernel's split),
    as non-persistent buffers."""

    def __init__(self, inter_matrix, n_users, n_items, device=None):
        super().__init__()
        t0 = time.time()
        coo = inter_matrix.tocoo()
        u = coo.row.astype(np.int64)
        i = coo.col.astype(np.int64)
        self.n_users, self.n_items = n_users, n_items
        du = np.bincount(u, minlength=n_users).astype(np.float32)
        di = np.bincount(i, minlength=n_items).astype(np.float32)
        consts = {
            "bg_user_bits": _pack_side(u, i, n_users, n_items),
            "bg_item_bits": _pack_side(i, u, n_items, n_users),
            "bg_unorm": 1.0 / np.sqrt(np.maximum(du, 1.0)),
            "bg_inorm": 1.0 / np.sqrt(np.maximum(di, 1.0)),
            "bg_user_counts": side_counts(u, i, n_users, n_items),
            "bg_item_counts": side_counts(i, u, n_items, n_users),
        }
        t1 = time.time()
        for name, value in consts.items():
            self.register_buffer(name, torch.as_tensor(value, device=device), persistent=False)
        # host seconds of the build, read by chip_smoke.py
        self.build_seconds = {"packed": t1 - t0, "upload": time.time() - t1}


def restricted_rows_apply(bits, rows, row_norm, col_norm, v, counts=None):
    """(A_hat v)[rows] for one bipartite direction: diag(row_norm)[rows] @
    B[rows, :] @ diag(col_norm) @ v, (R, D) float32. ``counts``, the image's
    set bits a row, balances the row kernel's work."""
    vv = (v * col_norm[:, None]).to(torch.bfloat16)
    return bit_rows_matmul(bits, rows, vv, counts) * row_norm[rows][:, None]


def restricted_cols_apply(bits, rows, row_norm, col_norm, g, n_cols):
    """A_hat[:, rows] @ g for one direction: diag(col_norm) @ B[rows, :]^T @
    diag(row_norm)[rows] @ g, (n_cols, D) float32; duplicate entries of
    ``rows`` sum."""
    gg = (g * row_norm[rows][:, None]).to(torch.bfloat16)
    return bit_cols_matmul(bits, rows, gg)[:n_cols] * col_norm[:, None]


class LinearPropBatch:
    """Layer-mean linear propagation read out at batch rows, with the
    restricted backward (module docstring): for L = 2 two full applications
    a step instead of four. ``prop`` is the full operator
    (ops/graph.py's ``BipartiteProp``), ``bitgraph`` the packed images."""

    def __init__(self, prop, bitgraph, n_users, n_items, n_layers):
        self.prop = prop
        self.bitgraph = bitgraph
        self.n_users, self.n_items = n_users, n_items
        self.n_nodes = n_users + n_items
        self.n_layers = n_layers

    def __call__(self, xu, xi, rows_u, rows_i):
        """(layer-mean embeddings at rows_u, at rows_i)."""
        return _LinearPropBatchFn.apply(self, xu, xi, rows_u, rows_i)

    def restricted_last_layer(self, t, rows_u, rows_i):
        """(A_hat t)[rows_u] on the user side, [rows_i] on the item side."""
        bg = self.bitgraph
        tu, ti = t[:self.n_users], t[self.n_users:]
        out_u = restricted_rows_apply(bg.bg_user_bits, rows_u, bg.bg_unorm, bg.bg_inorm, ti,
                                      bg.bg_user_counts)
        out_i = restricted_rows_apply(bg.bg_item_bits, rows_i, bg.bg_inorm, bg.bg_unorm, tu,
                                      bg.bg_item_counts)
        return out_u, out_i

    def restricted_first_bwd(self, g_u, g_i, rows_u, rows_i):
        """q = A_hat g~ for g~ non-zero at (rows_u | rows_i) only: the user
        side comes from the item-side cotangent and the other way round."""
        bg = self.bitgraph
        q_u = restricted_cols_apply(bg.bg_item_bits, rows_i, bg.bg_inorm, bg.bg_unorm, g_i,
                                    self.n_users)
        q_i = restricted_cols_apply(bg.bg_user_bits, rows_u, bg.bg_unorm, bg.bg_inorm, g_u,
                                    self.n_items)
        return torch.cat([q_u, q_i], dim=0)

    def forward_values(self, xu, xi, rows_u, rows_i):
        inv = 1.0 / (self.n_layers + 1)
        e_u = xu[rows_u] * inv
        e_i = xi[rows_i] * inv
        t = torch.cat([xu, xi], dim=0)
        for _ in range(max(self.n_layers - 1, 0)):
            t = self.prop.op(t)
            e_u = e_u + t[rows_u] * inv
            e_i = e_i + t[rows_i + self.n_users] * inv
        if self.n_layers > 0:
            lu, li = self.restricted_last_layer(t, rows_u, rows_i)
            e_u = e_u + lu * inv
            e_i = e_i + li * inv
        return e_u, e_i

    def backward_values(self, g_u, g_i, rows_u, rows_i):
        """d_x = sum over k = 0..L of A^k g~, the innermost application
        restricted to the batch columns (parity: bitgraph.py:253-268)."""
        inv = 1.0 / (self.n_layers + 1)
        g_u = g_u * inv
        g_i = g_i * inv
        d = torch.cat([dense_row_grad(rows_u, g_u, self.n_users),
                       dense_row_grad(rows_i, g_i, self.n_items)], dim=0)
        if self.n_layers > 0:
            s = self.restricted_first_bwd(g_u, g_i, rows_u, rows_i)
            d = d + s
            for _ in range(self.n_layers - 1):
                s = self.prop.op(s)
                d = d + s
        return d[:self.n_users], d[self.n_users:]


class _LinearPropBatchFn(torch.autograd.Function):
    """The restricted step keeps no (N, D) residuals: the backward needs the
    operator and the batch rows only."""

    @staticmethod
    def forward(ctx, lpb, xu, xi, rows_u, rows_i):
        ctx.lpb = lpb
        ctx.save_for_backward(rows_u, rows_i)
        return lpb.forward_values(xu, xi, rows_u, rows_i)

    @staticmethod
    def backward(ctx, g_u, g_i):
        rows_u, rows_i = ctx.saved_tensors
        d_u, d_i = ctx.lpb.backward_values(g_u.contiguous(), g_i.contiguous(), rows_u, rows_i)
        return None, d_u, d_i, None, None
