"""BPR: Bayesian Personalized Ranking matrix factorization.

Port of recbole_tpu/models/general/bpr.py (parity target: reference BPR,
recbole/model/general_recommender/bpr.py:27-100): user/item embedding
tables, pairwise BPR loss, full-sort scores = U @ V^T. The parameters keep
the JAX param dict's names, ``user_embedding`` and ``item_embedding``.
"""

import torch
from torch import nn

from ..base import GeneralRecommender
from ..layers import embedding_init, embed
from ..losses import bpr_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("BPR")
class BPR(GeneralRecommender):
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        gen = self.init_generator()
        self.user_embedding = nn.Parameter(embedding_init(
            gen, self.n_users, self.embedding_size, self.device))
        self.item_embedding = nn.Parameter(embedding_init(
            gen, self.n_items, self.embedding_size, self.device))

    def calculate_loss(self, batch, generator=None):
        u = embed(self.user_embedding, batch[self.USER_ID])
        pos = embed(self.item_embedding, batch[self.ITEM_ID])
        neg = embed(self.item_embedding, batch[self.NEG_ITEM_ID])
        pos_score = torch.sum(u * pos, dim=-1)
        neg_score = torch.sum(u * neg, dim=-1)
        return bpr_loss(pos_score, neg_score, batch.get("_weight"))

    def predict(self, batch):
        u = embed(self.user_embedding, batch[self.USER_ID])
        i = embed(self.item_embedding, batch[self.ITEM_ID])
        return torch.sum(u * i, dim=-1)

    def full_sort_predict(self, batch):
        u = embed(self.user_embedding, batch[self.USER_ID])
        return u @ self.item_embedding.T

    def full_sort_query(self, batch):
        """Dot-product structure for the fused masked top-k eval path."""
        return embed(self.user_embedding, batch[self.USER_ID]), self.item_embedding
