"""CKE: Collaborative Knowledge-base Embedding.

Port of recbole_tpu/models/knowledge/cke.py (parity target: reference CKE,
recbole/model/knowledge_aware_recommender/cke.py). An item's representation
is its item embedding plus its linked entity's; the loss is BPR over the
rec rows, a TransR-style BPR over relation-projected entities of the KG rows
that KGTrainer's rskg mode adds to each batch, and the L2 terms, returned as
three parts. The relation projection is a plain batched product on
``trans_w[r]``, as the JAX package computes it outside any kernel.
"""

import torch
from torch import nn

from ..base import KnowledgeRecommender
from ..layers import xavier_normal
from ..losses import bpr_loss, emb_loss, mask_rows
from ...utils.enums import InputType
from .. import register_model


def _l2norm(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


@register_model("CKE")
class CKE(KnowledgeRecommender):
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64, "kg_embedding_size": 64,
                      "reg_weights": [1e-2, 1e-2]}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.kg_embedding_size = Dk = config["kg_embedding_size"]
        self.reg_weights = config["reg_weights"]
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(xavier_normal(gen, (self.n_users, D), dev))
        self.item_embedding = nn.Parameter(xavier_normal(gen, (self.n_items, D), dev))
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        self.relation_embedding = nn.Parameter(xavier_normal(gen, (self.n_relations, Dk), dev))
        # the reference stores trans_w as a 2-D (n_rel, D Dk) Embedding
        # (cke.py:48): the xavier fans are that shape's
        self.trans_w = nn.Parameter(xavier_normal(gen, (self.n_relations, D * Dk), dev)
                                    .reshape(self.n_relations, D, Dk).clone())

    def _kg_embedding(self, h, r, pos_t, neg_t):
        w = self.trans_w[r]                                   # (B, D, Dk)
        E = self.entity_embedding

        def proj(e):
            return _l2norm(torch.bmm(e[:, None, :], w)[:, 0])

        return (proj(E[h]), _l2norm(self.relation_embedding[r]), proj(E[pos_t]),
                proj(E[neg_t]))

    def calculate_loss(self, batch, generator=None):
        """(BPR over the rec rows, TransR BPR over the KG rows, the L2
        terms) (parity: JAX :61-81)."""
        u = batch[self.USER_ID]
        pos = batch[self.ITEM_ID]
        neg = batch[self.NEG_ITEM_ID]
        w = batch.get("_weight")
        u_e = self.user_embedding[u]
        pos_e = self.item_embedding[pos] + self.entity_embedding[pos]
        neg_e = self.item_embedding[neg] + self.entity_embedding[neg]
        rec_loss = bpr_loss(torch.sum(u_e * pos_e, -1), torch.sum(u_e * neg_e, -1), w)
        h_e, r_e, pt_e, nt_e = self._kg_embedding(
            batch[self.HEAD_ENTITY_ID], batch[self.RELATION_ID],
            batch[self.TAIL_ENTITY_ID], batch[self.NEG_TAIL_ENTITY_ID])
        pos_score = torch.sum((h_e + r_e - pt_e) ** 2, -1)
        neg_score = torch.sum((h_e + r_e - nt_e) ** 2, -1)
        kg_loss = bpr_loss(neg_score, pos_score, w)
        reg_loss = (self.reg_weights[0] * emb_loss(*mask_rows(w, u_e, pos_e, neg_e))
                    + self.reg_weights[1] * emb_loss(*mask_rows(w, h_e, r_e, pt_e, nt_e)))
        return rec_loss, kg_loss, reg_loss

    def predict(self, batch):
        u_e = self.user_embedding[batch[self.USER_ID]]
        i = batch[self.ITEM_ID]
        return torch.sum(u_e * (self.item_embedding[i] + self.entity_embedding[i]), -1)

    def full_sort_predict(self, batch):
        u_e = self.user_embedding[batch[self.USER_ID]]
        return u_e @ (self.item_embedding + self.entity_embedding[:self.n_items]).T
