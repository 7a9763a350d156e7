"""MFSimple: biased matrix factorization with BCE (fork model).

Port of recbole_tpu/models/general/mfsimple.py (parity target: fork
MFSimple, recbole/model/general_recommender/mfsimple.py:8-64): normal(0.01)
user and item tables, user, item and global biases, sigmoid + BCE over
pointwise rows. Full sort scores every item with one product; the model has
no ``full_sort_query`` (the biases sit outside the dot product), so it takes
the trainer's non-fused step.
"""

import torch
from torch import nn

from ..base import GeneralRecommender
from ..layers import normal_init
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("MFSimple")
class MFSimple(GeneralRecommender):
    input_type = InputType.POINTWISE
    default_config = {"embedding_dimension": 128, "weight_decay": 1e-8,
                      "learning_rate": 0.002, "training_neg_sample_num": 8,
                      "epochs": 256}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_dim = D = config["embedding_dimension"]
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(normal_init(gen, (self.n_users, D), dev))
        self.item_embedding = nn.Parameter(normal_init(gen, (self.n_items, D), dev))
        self.user_bias = nn.Parameter(torch.zeros(self.n_users, device=dev))
        self.item_bias = nn.Parameter(torch.zeros(self.n_items, device=dev))
        self.bias = nn.Parameter(torch.zeros(1, device=dev))

    def _logits(self, user, item):
        return (torch.sum(self.user_embedding[user] * self.item_embedding[item], -1)
                + self.user_bias[user] + self.item_bias[item] + self.bias[0])

    def calculate_loss(self, batch, generator=None):
        logits = self._logits(batch[self.USER_ID], batch[self.ITEM_ID])
        return bce_loss(logits, batch[self.LABEL], batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch[self.USER_ID], batch[self.ITEM_ID]))

    def full_sort_predict(self, batch):
        u = batch[self.USER_ID]
        return (self.user_embedding[u] @ self.item_embedding.T + self.user_bias[u][:, None]
                + self.item_bias[None, :] + self.bias[0])
