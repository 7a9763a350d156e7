"""LightGCN: linear graph-convolution collaborative filtering.

Port of recbole_tpu/models/general/lightgcn.py (parity target: reference
LightGCN, recbole/model/general_recommender/lightgcn.py): K rounds of
propagation over the symmetric-normalized user-item adjacency, the layer
mean as the embedding, BPR loss plus an L2 term on the batch's ego
(pre-propagation) embeddings.

The operator is ops/graph.py's ``BipartiteProp``: dense on small graphs
(ml-100k, ml-1m), the hub-dense + ELL hybrid beyond. Off the dense path,
and while the packed images fit ``BITGRAPH_BUDGET_BYTES``, training takes
the restricted step of ops/bitgraph.py (two full applications a step, the
batch rows through the packed-bit kernels); ``use_restricted_step`` forces
it on (True) or off (False). The operator's and the images' arrays are
non-persistent buffers, built from the dataset: Adam never sees them and
checkpoints do not hold them.
"""

import numpy as np
import torch
from torch import nn

from ..base import GeneralRecommender
from ..layers import xavier_uniform
from ..losses import bpr_loss, emb_loss
from ...ops.bitgraph import (BITGRAPH_BUDGET_BYTES, BitRestrictedGraph, LinearPropBatch,
                             bitgraph_bytes)
from ...ops.embed_grad import take_rows_dense_grad
from ...ops.graph import BipartiteProp
from ...utils.enums import InputType
from .. import register_model


def build_norm_adj(inter_matrix, n_users, n_items):
    """Symmetric-normalized bipartite adjacency as COO arrays (src, dst,
    weight): users are nodes 0..n_users-1, items follow; each interaction
    gives both directions the weight 1 / sqrt(du * di)."""
    coo = inter_matrix.tocoo()
    u, i = coo.row.astype(np.int32), coo.col.astype(np.int32)
    du = np.bincount(u, minlength=n_users).astype(np.float32)
    di = np.bincount(i, minlength=n_items).astype(np.float32)
    w = 1.0 / np.sqrt(np.maximum(du[u], 1.0) * np.maximum(di[i], 1.0))
    src = np.concatenate([u, i + n_users])
    dst = np.concatenate([i + n_users, u])
    weight = np.concatenate([w, w]).astype(np.float32)
    return src, dst, weight


@register_model("LightGCN")
class LightGCN(GeneralRecommender):
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64, "n_layers": 2, "reg_weight": 1e-5}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.reg_weight = config["reg_weight"]
        inter = dataset.inter_matrix("csr")
        self.prop = BipartiteProp(inter, self.n_users, self.n_items, device=self.device)
        self.n_nodes = self.n_users + self.n_items
        use_res = config.get("use_restricted_step")
        self.use_restricted = (
            (not self.prop.dense)
            and bitgraph_bytes(self.n_users, self.n_items) <= BITGRAPH_BUDGET_BYTES
        ) if use_res is None else bool(use_res)
        if self.use_restricted:
            self.bitgraph = BitRestrictedGraph(inter, self.n_users, self.n_items,
                                               device=self.device)
            self.lpb = LinearPropBatch(self.prop, self.bitgraph, self.n_users, self.n_items,
                                       self.n_layers)
        gen = self.init_generator()
        self.user_embedding = nn.Parameter(xavier_uniform(
            gen, (self.n_users, self.embedding_size), self.device))
        self.item_embedding = nn.Parameter(xavier_uniform(
            gen, (self.n_items, self.embedding_size), self.device))

    def propagate(self):
        """(user, item) layer-mean embeddings over the whole graph."""
        ego = torch.cat([self.user_embedding, self.item_embedding], dim=0)
        acc = ego
        x = ego
        for _ in range(self.n_layers):
            x = self.prop(x)
            acc = acc + x
        final = acc / (self.n_layers + 1)
        return final[:self.n_users], final[self.n_users:]

    def calculate_loss(self, batch, generator=None):
        # the batch's columns may be strided views of the train matrix; the
        # kernels take contiguous ids
        u, pos, neg = (batch[k].contiguous() for k in (self.USER_ID, self.ITEM_ID,
                                                        self.NEG_ITEM_ID))
        if self.use_restricted:
            e_u, e_i = self.lpb(self.user_embedding, self.item_embedding, u,
                                torch.cat([pos, neg]))
            pos_e_f, neg_e_f = e_i[:pos.shape[0]], e_i[pos.shape[0]:]
        else:
            ue, ie = self.propagate()
            e_u = take_rows_dense_grad(self.n_users, ue, u)
            pos_e_f = take_rows_dense_grad(self.n_items, ie, pos)
            neg_e_f = take_rows_dense_grad(self.n_items, ie, neg)
        w = batch.get("_weight")
        mf_loss = bpr_loss(torch.sum(e_u * pos_e_f, dim=-1),
                           torch.sum(e_u * neg_e_f, dim=-1), w)
        # EmbLoss over the batch's ego embeddings (reference lightgcn.py:146-155)
        u_e = take_rows_dense_grad(self.n_users, self.user_embedding, u)
        pos_e = take_rows_dense_grad(self.n_items, self.item_embedding, pos)
        neg_e = take_rows_dense_grad(self.n_items, self.item_embedding, neg)
        if w is not None:
            u_e, pos_e, neg_e = (t * w[:, None] for t in (u_e, pos_e, neg_e))
        return mf_loss + self.reg_weight * emb_loss(u_e, pos_e, neg_e)

    def predict(self, batch):
        ue, ie = self.propagate()
        return torch.sum(ue[batch[self.USER_ID]] * ie[batch[self.ITEM_ID]], dim=-1)

    def full_sort_predict(self, batch):
        ue, ie = self.propagate()
        return ue[batch[self.USER_ID]] @ ie.T
