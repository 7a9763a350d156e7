"""KGAT: knowledge graph attention network.

Port of recbole_tpu/models/knowledge/kgat.py (parity target: reference KGAT,
recbole/model/knowledge_aware_recommender/kgat.py): a GNN over the
collaborative KG (entities, then users as nodes n_entities + u) whose edge
weights are an attention recomputed once an epoch from TransR scores
(``update_attentive_A``, run by KGATTrainer), a ``bi``/``gcn``/``graphsage``
aggregator, BPR over the propagated embeddings, and a TransR KG loss.

The attention lives on UNIQUE (head, tail) pairs, sorted by head then tail:
the reference's ``torch.sparse.softmax`` coalesces its matrix, so parallel
edges have their scores summed before the softmax over each head's pairs.
Only user and item rows of the propagation are read, so a single layer
(the default) runs dense: two (users x items) attention blocks, ``a_ui`` and
``a_iu``, times the item and user tables, plus the item -> entity KG fringe
on the ELL pass; more layers run the ELL pass over the whole CKG
(ops/edge_prop.py). The products stay plain ``torch`` matmuls, as the JAX
package computes them outside any Pallas kernel.

The attention is state that is not trained: a persistent buffer
(``edge_attention``), outside Adam's leaves, which the trainer's checkpoint
and ``convert.py`` carry. The two dense blocks are derived from it: they are
non-persistent buffers, rebuilt by ``attention_loaded`` after every
``load_state_dict`` and every attention update. The sums the attention
needs (edge scores into their pair, the softmax over a head's pairs) are
segment reductions over runs of sorted indices,
with no atomics, so that a run on the card is deterministic. The graph's
index arrays are non-persistent buffers.
"""

import numpy as np
import torch
from torch import nn

from ..base import KnowledgeRecommender
from ..layers import xavier_normal, dropout_apply
from ..losses import bpr_loss, emb_loss, mask_rows
from ...ops.edge_prop import build_ell_consts, ell_propagate
from ...utils.enums import InputType
from .. import register_model


def _leaky_relu(x):
    """jax.nn.leaky_relu's form, whose derivative at 0 is 1 (F.leaky_relu's
    is the slope): a node without edges has a zero side and, with zero
    biases, a zero input there."""
    return torch.where(x >= 0, x, 0.01 * x)


def _row_norm(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class _Aggregator(nn.Module):
    """One layer's weights, named as the JAX package's ``agg`` list entry:
    ``w1``/``b1`` (xavier on (in, out); ``in`` doubled for graphsage) and
    ``w2``/``b2`` (the bi-interaction's product branch; kept, untrained, by
    the other aggregators, as the JAX tree keeps it)."""

    def __init__(self, generator, in_dim, out_dim, kind, device):
        super().__init__()
        in1 = 2 * in_dim if kind == "graphsage" else in_dim
        self.w1 = nn.Parameter(xavier_normal(generator, (in1, out_dim), device))
        self.b1 = nn.Parameter(torch.zeros(out_dim, device=device))
        self.w2 = nn.Parameter(xavier_normal(generator, (in_dim, out_dim), device))
        self.b2 = nn.Parameter(torch.zeros(out_dim, device=device))


@register_model("KGAT")
class KGAT(KnowledgeRecommender):
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64, "kg_embedding_size": 64,
                      "layers": [64], "mess_dropout": 0.1, "reg_weight": 1e-5,
                      "aggregator_type": "bi"}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.kg_embedding_size = Dk = config["kg_embedding_size"]
        self.layers = list(config["layers"])
        self.mess_dropout = config["mess_dropout"]
        self.reg_weight = config["reg_weight"]
        self.aggregator = config["aggregator_type"]
        if self.aggregator not in ("bi", "gcn", "graphsage"):
            raise ValueError(f"aggregator_type {self.aggregator!r}: bi, gcn or graphsage")
        dev = self.device
        h, r, t = dataset.ckg_arrays()
        # edges sorted by relation, so that update_attentive_A runs one
        # (E_r, D) @ (D, Dk) product a relation (JAX :41-50)
        order = np.argsort(r, kind="stable")
        h, r, t = (a[order].astype(np.int64) for a in (h, r, t))
        counts = np.bincount(r, minlength=self.n_relations)
        ends = np.cumsum(counts)
        # (relation, first edge, end) of each relation that has edges
        self._rel_slices = [(i, int(ends[i] - counts[i]), int(ends[i]))
                            for i in range(self.n_relations) if counts[i]]
        self.n_nodes = self.n_entities + self.n_users
        self.n_edges = len(h)
        # unique head-sorted (head, tail) pairs, and each edge's pair
        # (JAX :51-70)
        pair_key = h * self.n_nodes + t
        uniq_keys, edge_to_pair = np.unique(pair_key, return_inverse=True)
        edge_to_pair = edge_to_pair.reshape(-1)
        self.n_pairs = len(uniq_keys)
        h_hs = uniq_keys // self.n_nodes
        t_hs = uniq_keys % self.n_nodes
        buffers = {
            "edge_h": h, "edge_t": t,
            # the edges in pair order, and each pair's edge count: the
            # pair sums are segment sums over runs of that order
            "edge_pair_order": np.argsort(edge_to_pair, kind="stable"),
            "pair_edges": np.bincount(edge_to_pair, minlength=self.n_pairs),
            # each pair's head, and each node's pair count (the softmax runs)
            "pair_head": h_hs,
            "head_pairs": np.bincount(h_hs, minlength=self.n_nodes),
        }
        # dense single-layer path (JAX :71-126): the user -> item pairs, the
        # item -> user pairs and the item -> entity KG fringe
        is_user_h = h_hs >= self.n_entities
        is_item_h = h_hs < self.n_items
        ui_sel = np.nonzero(is_user_h)[0]
        iu_sel = np.nonzero(is_item_h & (t_hs >= self.n_entities))[0]
        fringe = np.nonzero(is_item_h & (t_hs < self.n_entities))[0]
        self.dense_path = len(self.layers) == 1 and bool((t_hs[ui_sel] < self.n_items).all())
        if self.dense_path:
            buffers.update(ui_sel=ui_sel, ui_rows=h_hs[ui_sel] - self.n_entities,
                           ui_cols=t_hs[ui_sel], iu_sel=iu_sel, iu_rows=h_hs[iu_sel],
                           iu_cols=t_hs[iu_sel] - self.n_entities, fringe_sel=fringe)
            self._ell_prefix = "fri"
            ell, self._ell_shapes = build_ell_consts(h_hs[fringe], t_hs[fringe], self.n_items,
                                                     self.n_entities, prefix="fri")
        else:
            self._ell_prefix = "ell"
            ell, self._ell_shapes = build_ell_consts(h_hs, t_hs, self.n_nodes)
        buffers.update(ell)
        for name, arr in buffers.items():
            self.register_buffer(name, torch.as_tensor(np.asarray(arr), dtype=torch.int64,
                                                       device=dev), persistent=False)

        gen = self.init_generator()
        self.user_embedding = nn.Parameter(xavier_normal(gen, (self.n_users, D), dev))
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        self.relation_embedding = nn.Parameter(xavier_normal(gen, (self.n_relations, Dk), dev))
        # the reference stores trans_w as a 2-D (n_rel, D Dk) Embedding
        # (kgat.py:107): the xavier fans are that shape's
        self.trans_w = nn.Parameter(xavier_normal(gen, (self.n_relations, D * Dk), dev)
                                    .reshape(self.n_relations, D, Dk).clone())
        dims = [D] + self.layers
        self.agg = nn.ModuleList(_Aggregator(gen, dims[i], dims[i + 1], self.aggregator, dev)
                                 for i in range(len(self.layers)))
        # the attention starts as the row-normalised adjacency, summed over
        # parallel edges (JAX :164-178); the trainer replaces it each epoch
        self.register_buffer("edge_attention", self._init_attention(h, edge_to_pair))
        if self.dense_path:
            self.register_buffer("att_ui_dense", torch.zeros((self.n_users, self.n_items),
                                                             device=dev), persistent=False)
            self.register_buffer("att_iu_dense", torch.zeros((self.n_items, self.n_users),
                                                             device=dev), persistent=False)
            self.attention_loaded()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.attention_loaded())

    def _init_attention(self, edge_h, edge_to_pair):
        deg = np.bincount(edge_h, minlength=self.n_nodes)
        per_edge = 1.0 / np.maximum(deg, 1)[edge_h]
        per_pair = np.bincount(edge_to_pair, weights=per_edge, minlength=self.n_pairs)
        return torch.as_tensor(per_pair.astype(np.float32), device=self.device)

    @torch.no_grad()
    def attention_loaded(self):
        """Rebuild the dense blocks from ``edge_attention`` (every (row, col)
        is one unique pair, so plain index assignment builds them)."""
        if not self.dense_path:
            return
        att = self.edge_attention
        self.att_ui_dense.zero_()
        self.att_ui_dense[self.ui_rows, self.ui_cols] = att[self.ui_sel]
        self.att_iu_dense.zero_()
        self.att_iu_dense[self.iu_rows, self.iu_cols] = att[self.iu_sel]

    def _all_embeddings(self):
        return torch.cat([self.entity_embedding, self.user_embedding], 0)

    @torch.no_grad()
    def update_attentive_A(self):
        """Recompute the attention from TransR scores (parity: JAX :196-234):
        per relation, score = <t W_r, tanh(h W_r + e_r)> over its edges;
        parallel edges' scores summed into their pair; a softmax over each
        head's pairs; then the dense blocks rebuilt."""
        x = self._all_embeddings()
        parts = []
        for r, s, e in self._rel_slices:
            w = self.trans_w[r]                                        # (D, Dk)
            h_e = x[self.edge_h[s:e]] @ w
            t_e = x[self.edge_t[s:e]] @ w
            parts.append(torch.sum(t_e * torch.tanh(h_e + self.relation_embedding[r]), -1))
        scores = torch.segment_reduce(torch.cat(parts)[self.edge_pair_order], "sum",
                                      lengths=self.pair_edges)
        self.edge_attention.copy_(self._pair_softmax(scores))
        self.attention_loaded()

    def _pair_softmax(self, scores):
        """Softmax of head-sorted pair scores over each head's pairs, by
        segment max and sum over the heads' runs (JAX :180-194)."""
        seg_max = torch.segment_reduce(scores, "max", lengths=self.head_pairs)
        e = torch.exp(scores - seg_max[self.pair_head])
        seg_sum = torch.segment_reduce(e, "sum", lengths=self.head_pairs)
        return e / torch.clamp(seg_sum[self.pair_head], min=1e-12)

    def _agg(self, x, side, layer):
        if self.aggregator == "gcn":
            return _leaky_relu((x + side) @ layer.w1 + layer.b1)
        if self.aggregator == "graphsage":
            return _leaky_relu(torch.cat([x, side], -1) @ layer.w1 + layer.b1)
        return (_leaky_relu((x + side) @ layer.w1 + layer.b1)
                + _leaky_relu((x * side) @ layer.w2 + layer.b2))

    def _ell(self, x, att):
        t = {k: getattr(self, f"{self._ell_prefix}{k}")
             for k in ("f_eidx", "f_nbr", "f_inv", "b_eidx", "b_nbr", "b_inv")}
        return ell_propagate(self._ell_shapes, x, att, t["f_eidx"], t["f_nbr"], t["f_inv"],
                             t["b_eidx"], t["b_nbr"], t["b_inv"])

    def _dropout(self, x, generator):
        if generator is not None and self.training and self.mess_dropout > 0:
            return dropout_apply(generator, x, self.mess_dropout)
        return x

    def _propagate_dense(self, generator):
        """One layer over the consumed rows only (JAX :258-285): the two
        dense blocks and the item -> entity fringe."""
        xe = self.entity_embedding
        xu = self.user_embedding
        xi = xe[:self.n_items]
        su = self.att_ui_dense @ xi
        si = self.att_iu_dense @ xu + self._ell(xe, self.edge_attention[self.fringe_sel])
        layer = self.agg[0]
        x1_u = self._dropout(self._agg(xu, su, layer), generator)
        x1_i = self._dropout(self._agg(xi, si, layer), generator)
        return (torch.cat([xu, _row_norm(x1_u)], -1),
                torch.cat([xi, _row_norm(x1_i)], -1))

    def propagate(self, generator=None):
        """(user rows, item rows) of the layers' outputs concatenated
        (JAX :287-310); mess dropout in training, masks from ``generator``."""
        if self.dense_path:
            return self._propagate_dense(generator)
        x = self._all_embeddings()
        outs = [x]
        for layer in self.agg:
            x = self._dropout(self._agg(x, self._ell(x, self.edge_attention), layer), generator)
            x = _row_norm(x)
            outs.append(x)
        final = torch.cat(outs, -1)
        return final[self.n_entities:], final[:self.n_items]

    def calculate_loss(self, batch, generator=None):
        ue, ie = self.propagate(generator)
        u, pos, neg = batch[self.USER_ID], batch[self.ITEM_ID], batch[self.NEG_ITEM_ID]
        w = batch.get("_weight")
        u_e, pos_e, neg_e = ue[u], ie[pos], ie[neg]
        loss = bpr_loss(torch.sum(u_e * pos_e, -1), torch.sum(u_e * neg_e, -1), w)
        return loss + self.reg_weight * emb_loss(*mask_rows(w, u_e, pos_e, neg_e))

    def calculate_kg_loss(self, batch, generator=None):
        """TransR BPR over KG triples with a negative tail each (JAX
        :322-337)."""
        r = batch[self.RELATION_ID]
        w = self.trans_w[r]                                            # (B, D, Dk)

        def proj(ids):
            return torch.bmm(self.entity_embedding[ids][:, None, :], w)[:, 0]

        h_e = proj(batch[self.HEAD_ENTITY_ID])
        pt_e = proj(batch[self.TAIL_ENTITY_ID])
        nt_e = proj(batch[self.NEG_TAIL_ENTITY_ID])
        r_e = self.relation_embedding[r]
        pos_score = torch.sum((h_e + r_e - pt_e) ** 2, -1)
        neg_score = torch.sum((h_e + r_e - nt_e) ** 2, -1)
        w2 = batch.get("_weight")
        loss = bpr_loss(neg_score, pos_score, w2)
        return loss + self.reg_weight * emb_loss(*mask_rows(w2, h_e, r_e, pt_e, nt_e))

    def predict(self, batch):
        ue, ie = self.propagate()
        return torch.sum(ue[batch[self.USER_ID]] * ie[batch[self.ITEM_ID]], -1)

    def full_sort_predict(self, batch):
        ue, ie = self.propagate()
        return ue[batch[self.USER_ID]] @ ie.T
