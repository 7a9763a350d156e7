"""Scatter-free sparse propagation over edge lists.

Port of recbole_tpu/ops/edge_prop.py:

    out[n] = sum over edges e with head[e] == n of att[e] * x[tail[e]]

Two formulations, as in the JAX package:

* Sorted edges (``build_sorted_edge_consts``, ``sorted_edge_propagate``,
  :35-104): the edges sorted by head; the forward is a gather and a sorted
  segment sum over each head's run of edges (``torch.segment_reduce`` over
  the run lengths: no atomics). Its backward, ``SortedEdgePropagate``, has
  no scatter: ``d_x`` is each tail's segment sum of the edge cotangents
  taken in tail order (a fixed permutation) as differences of one
  inclusive cumsum at the runs' ends, and ``d_att`` a gather and a row
  reduce. The cumsum difference carries the rounding of the running sum:
  the JAX docstring expects about 1e-5 relative error in ``d_x``; the
  forward is exact. No model of either package calls it; its tests do.
* ELL (``build_ell_consts``, ``ell_propagate``, :107-240): nodes are
  bucketed by degree on a ~1.25x geometric ladder, so each bucket is a
  (n_b, K_b) table of edge ids and neighbour ids with little padding even
  on power-law graphs; padded slots point at a sentinel edge whose weight
  is 0. The forward gathers each bucket's neighbour rows and reduces them
  with their weights (``einsum``), then puts the bucket rows back in node
  order with an inverse-permutation gather; the backward is the same pass
  over the tail-grouped tables. No scatter anywhere, so both directions are
  deterministic. ``att`` is a constant: it gets no gradient.

``BipartiteProp``'s hybrid (ops/graph.py) calls ``ell_side``/``ell_rows``
alone: its operator is symmetric, so its backward is its forward. The
two-direction tables and ``ell_propagate`` serve operators that are not,
such as KGAT's attention-weighted one (models/knowledge/kgat.py).
"""

import numpy as np
import torch


def build_sorted_edge_consts(heads, tails, n_nodes):
    """numpy preprocessing for ``sorted_edge_propagate``: the edges sorted
    by head (stable), the tail-order permutation and each node's run of
    edges in head and in tail order. Returns (order, consts of int64
    arrays), ``order`` the edges' sorting permutation."""
    heads = np.asarray(heads)
    tails = np.asarray(tails)
    order = np.argsort(heads, kind="stable")
    heads, tails = heads[order], tails[order]
    tail_perm = np.argsort(tails, kind="stable")
    sorted_tails = tails[tail_perm]
    nodes = np.arange(n_nodes)
    return order, {
        "ep_heads": heads.astype(np.int64),
        "ep_tails": tails.astype(np.int64),
        "ep_tail_perm": tail_perm.astype(np.int64),
        "ep_tstarts": np.searchsorted(sorted_tails, nodes).astype(np.int64),
        "ep_tends": np.searchsorted(sorted_tails, nodes, side="right").astype(np.int64),
        "ep_hstarts": np.searchsorted(heads, nodes).astype(np.int64),
        "ep_hends": np.searchsorted(heads, nodes, side="right").astype(np.int64),
    }


def boundary_segment_sum(vals, starts, ends):
    """Sums of the consecutive runs [starts[n], ends[n]) of ``vals`` rows, as
    differences of one inclusive cumsum with a zero row in front."""
    cume = torch.cat([vals.new_zeros((1,) + vals.shape[1:]), torch.cumsum(vals, dim=0)])
    return cume[ends] - cume[starts]


class SortedEdgePropagate(torch.autograd.Function):
    """Forward: gather and a sorted segment sum by head (exact). Backward:
    ``d_x`` by tail-ordered boundary sums, ``d_att`` by gather and reduce;
    no scatter in either."""

    @staticmethod
    def forward(ctx, x, att, heads, tails, tail_perm, tstarts, tends, hstarts, hends):
        ctx.save_for_backward(x, att, heads, tails, tail_perm, tstarts, tends)
        msgs = x[tails] * att[:, None]
        return torch.segment_reduce(msgs, "sum", lengths=hends - hstarts, axis=0)

    @staticmethod
    def backward(ctx, d_out):
        x, att, heads, tails, tail_perm, tstarts, tends = ctx.saved_tensors
        d_head = d_out[heads]                                   # (E, D)
        d_x = d_att = None
        if ctx.needs_input_grad[0]:
            d_x = boundary_segment_sum((d_head * att[:, None])[tail_perm], tstarts, tends)
        if ctx.needs_input_grad[1]:
            d_att = torch.sum(d_head * x[tails], dim=-1)
        return d_x, d_att, None, None, None, None, None, None, None


def sorted_edge_propagate(x, att, heads, tails, tail_perm, tstarts, tends, hstarts, hends):
    """x: (N, D); att: (E,) edge weights in head-sorted order; the index
    tensors from ``build_sorted_edge_consts``. Returns (N, D)."""
    return SortedEdgePropagate.apply(x, att, heads, tails, tail_perm, tstarts, tends,
                                     hstarts, hends)


def ell_side(group, other, E, n_nodes, prefix):
    """One grouping direction: bucket nodes by degree and build padded
    (n_b, K_b) tables of edge ids (for the weight lookup) and neighbour node
    ids (the ``other`` endpoints). Returns (consts, static shapes)."""
    deg = np.bincount(group, minlength=n_nodes)
    order = np.argsort(group, kind="stable")
    starts = np.searchsorted(group[order], np.arange(n_nodes))
    nz = np.nonzero(deg)[0]
    # bucket widths on a ~1.25x geometric ladder (the JAX package measured
    # ~92% slot fill against ~75% for pure log2 classes)
    ladder = [1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64, 80,
              96, 128]
    while ladder[-1] < int(deg.max(initial=1)):
        ladder.append(-(-ladder[-1] * 5 // 4))
    ladder_arr = np.asarray(ladder)
    cls = np.zeros(n_nodes, np.int64)
    cls[nz] = np.searchsorted(ladder_arr, deg[nz])
    eidx_parts, nbr_parts, shapes = [], [], []
    pos = np.empty(n_nodes, np.int64)
    row = 0
    for k in sorted(set(cls[nz].tolist()), reverse=True):
        nodes = nz[cls[nz] == k]
        Kb = int(deg[nodes].max())
        nb = len(nodes)
        nbp = -(-nb // 8) * 8  # rows padded to a multiple of 8, as in the JAX package
        col = np.arange(Kb)
        mask = col[None, :] < deg[nodes, None]
        mat = np.full((nbp, Kb), E, np.int64)
        src = np.minimum(starts[nodes, None] + col[None, :], E - 1)
        mat[:nb][mask] = order[src][mask]
        pos[nodes] = row + np.arange(nb)
        row += nbp
        eidx_parts.append(mat.ravel())
        nbr = np.zeros((nbp, Kb), np.int64)
        nbr[:nb][mask] = other[order[src]][mask]
        nbr_parts.append(nbr.ravel())
        shapes.append((nbp, Kb))
    pos[deg == 0] = row  # sentinel zero row appended after all buckets
    consts = {
        prefix + "_eidx": np.concatenate(eidx_parts) if eidx_parts else np.zeros(0, np.int64),
        prefix + "_nbr": np.concatenate(nbr_parts) if nbr_parts else np.zeros(0, np.int64),
        prefix + "_inv": pos,
    }
    return consts, tuple(shapes)


def build_ell_consts(heads, tails, n_head_nodes, n_tail_nodes=None, prefix="ell"):
    """numpy preprocessing for ``ell_propagate``. ``heads``/``tails`` are in
    the edge order of the weight vector. Returns (consts of int64 arrays,
    (f_shapes, b_shapes)); the forward tables are keyed ``<prefix>f_*``, the
    backward ones ``<prefix>b_*``."""
    heads = np.asarray(heads)
    tails = np.asarray(tails)
    if n_tail_nodes is None:
        n_tail_nodes = n_head_nodes
    E = len(heads)
    fc, f_shapes = ell_side(heads, tails, E, n_head_nodes, prefix + "f")
    bc, b_shapes = ell_side(tails, heads, E, n_tail_nodes, prefix + "b")
    fc.update(bc)
    return fc, (f_shapes, b_shapes)


def ell_rows(att_ext, x, eidx_flat, nbr_flat, shapes, inv):
    """One grouped pass: per bucket, gather the neighbour rows and reduce
    them with their weights; then the bucket rows in node order."""
    rows, off = [], 0
    for nb, kb in shapes:
        idx = eidx_flat[off:off + nb * kb].view(nb, kb)
        nbr = nbr_flat[off:off + nb * kb].view(nb, kb)
        off += nb * kb
        rows.append(torch.einsum("nk,nkd->nd", att_ext[idx], x[nbr]))
    rows.append(x.new_zeros((1, x.shape[1])))
    return torch.cat(rows, dim=0)[inv]


def _extend(att):
    """The weights with the sentinel edge's 0 appended."""
    return torch.cat([att.detach(), att.new_zeros(1)])


class EllPropagate(torch.autograd.Function):
    """Head-grouped pass forward, tail-grouped pass backward; ``att`` is a
    constant."""

    @staticmethod
    def forward(ctx, shapes, x, att, f_eidx, f_nbr, f_inv, b_eidx, b_nbr, b_inv):
        ctx.shapes = shapes
        ctx.save_for_backward(att, b_eidx, b_nbr, b_inv)
        return ell_rows(_extend(att), x, f_eidx, f_nbr, shapes[0], f_inv)

    @staticmethod
    def backward(ctx, d_out):
        att, b_eidx, b_nbr, b_inv = ctx.saved_tensors
        d_x = ell_rows(_extend(att), d_out.contiguous(), b_eidx, b_nbr, ctx.shapes[1], b_inv)
        return None, d_x, None, None, None, None, None, None, None


def ell_propagate(shapes, x, att, f_eidx, f_nbr, f_inv, b_eidx, b_nbr, b_inv):
    """out[n] = sum over edges e with head[e] == n of att[e] * x[tail[e]].
    ``shapes`` is the (f_shapes, b_shapes) pair from ``build_ell_consts``,
    the index tensors its consts."""
    return EllPropagate.apply(shapes, x, att, f_eidx, f_nbr, f_inv, b_eidx, b_nbr, b_inv)
