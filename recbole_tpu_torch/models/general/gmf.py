"""GMF: generalized matrix factorization (fork model).

Port of recbole_tpu/models/general/gmf.py (parity target: fork GMF,
recbole/model/general_recommender/gmf.py:8-60): the element-wise product of
the user's and the item's embeddings through a learned linear head, sigmoid +
BCE. Full sort folds the head into the user side, ``(u * w) @ items.T + b``,
one product over the item table.
"""

import torch
from torch import nn

from ..base import GeneralRecommender
from ..layers import normal_init, xavier_uniform
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("GMF")
class GMF(GeneralRecommender):
    input_type = InputType.POINTWISE
    default_config = {"embedding_dimension": 128, "weight_decay": 1e-8,
                      "valid_metric": "Hit@10"}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_dim = D = config["embedding_dimension"]
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(normal_init(gen, (self.n_users, D), dev))
        self.item_embedding = nn.Parameter(normal_init(gen, (self.n_items, D), dev))
        self.w = nn.Parameter(xavier_uniform(gen, (D, 1), dev))
        self.b = nn.Parameter(torch.zeros(1, device=dev))

    def _logits(self, user, item):
        x = self.user_embedding[user] * self.item_embedding[item]
        return (x @ self.w)[:, 0] + self.b[0]

    def calculate_loss(self, batch, generator=None):
        logits = self._logits(batch[self.USER_ID], batch[self.ITEM_ID])
        return bce_loss(logits, batch[self.LABEL], batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch[self.USER_ID], batch[self.ITEM_ID]))

    def full_sort_predict(self, batch):
        uw = self.user_embedding[batch[self.USER_ID]] * self.w[:, 0][None, :]
        return uw @ self.item_embedding.T + self.b[0]
