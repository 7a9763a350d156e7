"""CFKG: Collaborative Filtering with Knowledge Graph (translation-based).

Port of recbole_tpu/models/knowledge/cfkg.py (parity target: reference
CFKG, recbole/model/knowledge_aware_recommender/cfkg.py). Users and
entities share one space; an interaction is the triple (user,
[UI-Relation], item), the extra relation being row ``n_relations`` of a
table of ``n_relations + 1`` rows. One loss over the rec and KG rows
together, reduced by ONE mean: the softplus inner-product form or the
TransE triplet margin.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..base import KnowledgeRecommender
from ..layers import xavier_normal
from ...utils.enums import InputType
from .. import register_model


@register_model("CFKG")
class CFKG(KnowledgeRecommender):
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64, "loss_function": "inner_product",
                      "margin": 1.0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.loss_function = config["loss_function"]
        self.margin = config["margin"]
        if self.loss_function not in ("inner_product", "transe"):
            raise ValueError("loss_function must be inner_product or transe")
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(xavier_normal(gen, (self.n_users, D), dev))
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        # n_relations + 1 rows: the extra last row is [UI-Relation]
        # (reference cfkg.py:50, Embedding(n_relations + 1))
        self.relation_embedding = nn.Parameter(
            xavier_normal(gen, (self.n_relations + 1, D), dev))

    def _ui_rel(self):
        return self.relation_embedding[self.n_relations]

    def _score(self, h_e, r_e, t_e):
        if self.loss_function == "inner_product":
            return torch.sum((h_e + r_e) * t_e, -1)
        # transe: the NEGATIVE L2 distance (reference cfkg.py:84-88)
        return -torch.sqrt(torch.clamp(torch.sum((h_e + r_e - t_e) ** 2, -1), min=1e-12))

    def calculate_loss(self, batch, generator=None):
        """The rec triples (user, [UI-Relation], item) and the KG triples
        concatenated and reduced by one mean (parity: JAX :53-82, reference
        cfkg.py:90-109)."""
        w = batch.get("_weight")
        E = self.entity_embedding
        u_e = self.user_embedding[batch[self.USER_ID]]
        pos_e = E[batch[self.ITEM_ID]]
        neg_e = E[batch[self.NEG_ITEM_ID]]
        h_e = E[batch[self.HEAD_ENTITY_ID]]
        r_e = self.relation_embedding[batch[self.RELATION_ID]]
        pt_e = E[batch[self.TAIL_ENTITY_ID]]
        nt_e = E[batch[self.NEG_TAIL_ENTITY_ID]]
        anchor = torch.cat([u_e + self._ui_rel()[None, :], h_e + r_e])
        pos_t = torch.cat([pos_e, pt_e])
        neg_t = torch.cat([neg_e, nt_e])
        if self.loss_function == "inner_product":
            per = (F.softplus(-torch.sum(anchor * pos_t, -1))
                   + F.softplus(torch.sum(anchor * neg_t, -1)))
        else:
            d_pos = torch.sqrt(torch.clamp(torch.sum((anchor - pos_t) ** 2, -1), min=1e-12))
            d_neg = torch.sqrt(torch.clamp(torch.sum((anchor - neg_t) ** 2, -1), min=1e-12))
            per = torch.clamp(d_pos - d_neg + self.margin, min=0.0)
        if w is None:
            return torch.mean(per)
        w2 = torch.cat([w, w]).to(per.dtype)
        return torch.sum(per * w2) / torch.clamp(torch.sum(w2), min=1.0)

    def predict(self, batch):
        u_e = self.user_embedding[batch[self.USER_ID]]
        i_e = self.entity_embedding[batch[self.ITEM_ID]]
        return self._score(u_e, self._ui_rel()[None, :], i_e)

    def full_sort_predict(self, batch):
        u_e = self.user_embedding[batch[self.USER_ID]] + self._ui_rel()[None, :]
        items = self.entity_embedding[:self.n_items]
        if self.loss_function == "inner_product":
            return u_e @ items.T
        d = (torch.sum(u_e ** 2, -1, keepdim=True) - 2 * (u_e @ items.T)
             + torch.sum(items ** 2, -1)[None, :])
        return -torch.sqrt(torch.clamp(d, min=1e-12))
