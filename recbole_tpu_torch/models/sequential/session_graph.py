"""Session-graph machinery of GCSAN (and SRGNN).

Port of recbole_tpu/models/sequential/session_graph.py (parity target: the
reference's SRGNN/GCSAN ``_get_slice`` and gated GNN, recbole/model/
sequential_recommender/srgnn.py:28-120, 148-186, which build each
session's adjacency in a host loop with np.unique). Here, as in the JAX
package, the graph is built on the device for the whole batch:

  * node slots are sequence positions; a repeated item aliases to its
    FIRST occurrence, the first maximum of an (L, L) equality matrix
    (``session_graph.py:37-38``);
  * each edge t -> t + 1 (t + 1 < seq_len) sets an entry of a dense (L, L)
    adjacency to 1, by a maximum, not a sum (``:45-46``);
  * the in- and out-degree normalised propagation is two batched products.

The gated update is plain torch, as in the JAX package: it is not a
recurrence over time, and no kernel of the repo computes it.
"""

import torch
from torch import nn

from ..layers import xavier_uniform


def session_graph(seq, seq_len):
    """seq (B, L) 0-padded item ids, seq_len (B,) ->
    alias (B, L) int64, the first position holding each step's item;
    a_in (B, L, L), A_in[i, j] = A[j, i] / in_deg(i);
    a_out (B, L, L), A_out[i, j] = A[i, j] / out_deg(i)."""
    B, L = seq.shape
    eq = seq[:, :, None] == seq[:, None, :]
    # the first maximum: the first j with seq[j] == seq[i]
    alias = torch.argmax(eq.to(torch.int8), dim=2)
    src, dst = alias[:, :-1], alias[:, 1:]
    valid = (torch.arange(1, L, device=seq.device)[None, :] < seq_len[:, None]).to(torch.float32)
    adj = torch.zeros((B, L * L), dtype=torch.float32, device=seq.device)
    adj.scatter_reduce_(1, src * L + dst, valid, reduce="amax")
    adj = adj.reshape(B, L, L)
    in_deg = torch.clamp(torch.sum(adj, dim=1), min=1.0)
    out_deg = torch.clamp(torch.sum(adj, dim=2), min=1.0)
    a_in = adj.transpose(1, 2) / in_deg[:, :, None]
    a_out = adj / out_deg[:, :, None]
    return alias, a_in, a_out


class SessionGNN(nn.Module):
    """The gated session GNN's parameters under the JAX dict's names
    (parity: gnn_init, :49-67; SRGNN's GNN module, srgnn.py:28-54):
    xavier-uniform weights in the JAX init's draw order and zero biases;
    ``bias_edges`` False (GCSAN's variant) leaves out b_iah and b_ioh."""

    def __init__(self, generator, hidden, device, bias_edges=True):
        super().__init__()

        def xu(*shape):
            return nn.Parameter(xavier_uniform(generator, shape, device))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=device))

        self.w_ih = xu(2 * hidden, 3 * hidden)
        self.w_hh = xu(hidden, 3 * hidden)
        self.b_ih, self.b_hh = zeros(3 * hidden), zeros(3 * hidden)
        self.w_in = xu(hidden, hidden)
        self.b_in = zeros(hidden)
        self.w_out = xu(hidden, hidden)
        self.b_out = zeros(hidden)
        if bias_edges:
            self.b_iah, self.b_ioh = zeros(hidden), zeros(hidden)


def gnn_apply(p, a_in, a_out, hidden, steps):
    """``steps`` rounds of gated propagation (parity: gnn_apply, :70-99;
    GNNCell, srgnn.py:44-72). ``p`` a SessionGNN."""
    for _ in range(steps):
        msg_in = torch.einsum("blm,bmd->bld", a_in, hidden @ p.w_in + p.b_in)
        msg_out = torch.einsum("blm,bmd->bld", a_out, hidden @ p.w_out + p.b_out)
        if hasattr(p, "b_iah"):
            msg_in = msg_in + p.b_iah
            msg_out = msg_out + p.b_ioh
        inputs = torch.cat([msg_in, msg_out], dim=-1)
        gi = inputs @ p.w_ih + p.b_ih
        gh = hidden @ p.w_hh + p.b_hh
        i_r, i_i, i_n = torch.chunk(gi, 3, dim=-1)
        h_r, h_i, h_n = torch.chunk(gh, 3, dim=-1)
        reset = torch.sigmoid(i_r + h_r)
        update = torch.sigmoid(i_i + h_i)
        new = torch.tanh(i_n + reset * h_n)
        hidden = (1 - update) * hidden + update * new
    return hidden
