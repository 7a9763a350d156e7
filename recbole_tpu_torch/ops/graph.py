"""Bipartite user-item propagation: a dense product, or a hub-dense +
ELL-tail hybrid.

Port of recbole_tpu/ops/graph.py's ``BipartiteProp``. Nodes 0..n_users-1
are users, the next n_items are items; ``prop(x)`` is A_hat @ x for x
(n_users + n_items, D). The operator is built once on the host (numpy) and
its arrays become non-persistent buffers of the module: no optimizer sees
them, no checkpoint writes them, and they move with ``.to(device)``.

* Dense path, when n_users * n_items <= ``dense_budget``: the normalized
  (n_users, n_items) matrix R in float32 (and its item-side twin for the
  random-walk norm), two products.
* Hybrid path, the one that the Yelp shape takes (``norm="sym"``): items of
  degree above n_users / 1050 form a dense (n_users, H) bf16 block, two
  products with bf16 operands and fp32 sums and results (as the JAX
  package's ``preferred_element_type=float32``); the other edges run the
  scatter-free ELL pass of ops/edge_prop.py. Hub rows are placed with
  static gathers, and since A_hat is symmetric the backward applies the
  same operator to the cotangent (``HybridSymProp``).
* The sorted-SpMM edge path (graphs beyond the dense budget without the
  hybrid, i.e. the random-walk norm) raises: ROADMAP Queue 1, item 8.

The budget constants are the JAX package's, which set them from TPU
measurements; they decide which path a shape takes, so the two packages
take the same one.
"""

import time

import numpy as np
import torch
from torch import nn

from .edge_prop import ell_rows, ell_side

# dense R budget: 256M float32 entries = 1 GiB
DENSE_ENTRY_BUDGET = 256_000_000
# hybrid: items above degree n_users / HUB_BREAK_EVEN_DIV (and at least
# HUB_MIN_DEG) join the dense hub, which may take HUB_BUDGET_BYTES of bf16
HUB_BREAK_EVEN_DIV = 1050.0
HUB_BUDGET_BYTES = 4 << 30
HUB_MIN_DEG = 16.0


def mm_f32(a, b):
    """a @ b for bf16 a and b with fp32 sums and an fp32 result."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class BipartiteProp(nn.Module):
    """Symmetric- (or random-walk-) normalized user-item propagation."""

    def __init__(self, inter_matrix, n_users, n_items, dense_budget=DENSE_ENTRY_BUDGET,
                 norm="sym", device=None):
        super().__init__()
        coo = inter_matrix.tocoo()
        u = coo.row.astype(np.int64)
        i = coo.col.astype(np.int64)
        du = np.bincount(u, minlength=n_users).astype(np.float32)
        di = np.bincount(i, minlength=n_items).astype(np.float32)
        if norm == "sym":
            # D^-1/2 A D^-1/2: both directions share one weight
            wu = wi = 1.0 / np.sqrt(np.maximum(du[u], 1.0) * np.maximum(di[i], 1.0))
        elif norm == "rw":
            # D^-1 A: the user side divides by the user degree, the item side
            # by the item degree
            wu = 1.0 / np.maximum(du[u], 1.0)
            wi = 1.0 / np.maximum(di[i], 1.0)
        else:
            raise ValueError(f"unknown norm {norm!r}")
        self.n_users, self.n_items = n_users, n_items
        self.n_nodes = n_users + n_items
        self.dense = n_users * n_items <= dense_budget
        self.hybrid = (not self.dense) and norm == "sym"
        self.hub_size = 0
        # host seconds of each part of the build, read by chip_smoke.py
        self.build_seconds = {}
        if self.hybrid:
            consts = self._build_hybrid(u, i, wu)
        elif self.dense:
            Ru = np.zeros((n_users, n_items), np.float32)
            np.add.at(Ru, (u, i), wu)
            consts = {"R": Ru}
            if norm == "rw":
                Ri = np.zeros((n_users, n_items), np.float32)
                np.add.at(Ri, (u, i), wi)
                consts["Rt"] = Ri
        else:
            raise NotImplementedError(
                "the sorted-SpMM edge path of BipartiteProp (a graph beyond the dense "
                "budget without the hub + ELL hybrid) is not ported yet (ROADMAP Queue 1, "
                "item 8)")
        t0 = time.time()
        for name, value in consts.items():
            self.register_buffer(name, torch.as_tensor(value, device=device), persistent=False)
        self.build_seconds["upload"] = time.time() - t0

    def _build_hybrid(self, u, i, w):
        """Hub-dense + ELL-tail decomposition (parity: graph.py:142-186).
        ``hub_ids`` compacts item rows into hub order, ``hub_pos`` expands
        hub outputs back (sentinel Hp -> a zero row)."""
        t0 = time.time()
        n_users, n_items = self.n_users, self.n_items
        di = np.bincount(i, minlength=n_items)
        thr = max(n_users / HUB_BREAK_EVEN_DIV, HUB_MIN_DEG)
        hub_ids = np.nonzero(di > thr)[0]
        h_max = max(int(HUB_BUDGET_BYTES // max(2 * n_users, 1)), 0)
        if len(hub_ids) > h_max:
            order = np.argsort(-di[hub_ids], kind="stable")
            hub_ids = np.sort(hub_ids[order[:h_max]])
        H = len(hub_ids)
        Hp = max(-(-H // 128) * 128, 128)
        hub_pos = np.full(n_items, Hp, np.int64)  # sentinel -> zero row
        hub_pos[hub_ids] = np.arange(H)
        is_hub_edge = hub_pos[i] < H
        hu, hi, hw = u[is_hub_edge], i[is_hub_edge], w[is_hub_edge]
        R = np.zeros((n_users, Hp), np.float32)
        np.add.at(R, (hu, hub_pos[hi]), hw)
        hub_R = torch.from_numpy(R).to(torch.bfloat16)
        t1 = time.time()
        tu, ti, tw = u[~is_hub_edge], i[~is_hub_edge] + n_users, w[~is_hub_edge]
        heads = np.concatenate([tu, ti])
        tails = np.concatenate([ti, tu])
        att = np.concatenate([tw, tw]).astype(np.float32)
        # the head-grouped ELL tables only (build_ell_consts's forward half):
        # the backward is the same operator
        ell, self._ell_shapes = ell_side(heads, tails, len(heads), self.n_nodes, "ghf")
        hub_ids_pad = np.zeros(Hp, np.int64)  # padded columns read item 0; R is zero there
        hub_ids_pad[:H] = hub_ids
        self.hub_size = H
        self.build_seconds.update(hub=t1 - t0, ell=time.time() - t1)
        # the edge weights end with the sentinel edge's 0
        return {"hub_R": hub_R, "hub_ids": hub_ids_pad,
                "hub_pos": hub_pos, "gh_att_ext": np.append(att, np.float32(0.0)), **ell}

    def op(self, x):
        """A_hat @ x without autograd bookkeeping of its own (the restricted
        step's Function and ``HybridSymProp`` call it)."""
        if self.hybrid:
            return self._hybrid_apply(x)
        nu = self.R @ x[self.n_users:]
        # the random-walk norm keeps a second item-side matrix; sym reuses R
        ni = getattr(self, "Rt", self.R).T @ x[:self.n_users]
        return torch.cat([nu, ni], dim=0)

    def _hybrid_apply(self, x):
        n_users = self.n_users
        xu, xi = x[:n_users], x[n_users:]
        R = self.hub_R
        nu = mm_f32(R, xi[self.hub_ids].to(R.dtype))
        ni_hub = mm_f32(R.T, xu.to(R.dtype))
        tail = ell_rows(self.gh_att_ext, x, self.ghf_eidx, self.ghf_nbr, self._ell_shapes,
                        self.ghf_inv)
        ni_ext = torch.cat([ni_hub, ni_hub.new_zeros((1, ni_hub.shape[1]))], dim=0)
        return torch.cat([tail[:n_users] + nu, tail[n_users:] + ni_ext[self.hub_pos]], dim=0)

    def forward(self, x):
        """A_hat @ x, differentiable in x."""
        if self.hybrid:
            return HybridSymProp.apply(self, x)
        return self.op(x)


class HybridSymProp(torch.autograd.Function):
    """A_hat @ x through the hybrid; A_hat is symmetric, so the backward
    applies the same operator to the cotangent (parity: graph.py:297-324)."""

    @staticmethod
    def forward(ctx, prop, x):
        ctx.prop = prop
        return prop.op(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.prop.op(g.contiguous())
