"""MLP: neural CF with an MLP tower over the user and item embeddings (fork
model).

Port of recbole_tpu/models/general/mlp.py (parity target: fork MLP,
recbole/model/general_recommender/mlp.py:8-90): the two embeddings
concatenated (``mlp_variant: cat``) or multiplied (``mul``), dropout before
each hidden layer (in training, masks from the trainer's generator), ReLU
layers with xavier-uniform weights, a linear output, sigmoid + BCE. It has
``predict`` only: full sort takes the trainer's chunked ``score_items``.
"""

import torch
from torch import nn

from ..base import GeneralRecommender
from ..layers import MLPLayers, normal_init, xavier_uniform
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("MLP")
class MLP(GeneralRecommender):
    input_type = InputType.POINTWISE
    default_config = {"embedding_dimension": 50, "weight_decay": 1e-8,
                      "learning_rate": 0.002, "training_neg_sample_num": 8,
                      "train_batch_size": 4096, "dropout": 0.8,
                      "ff_layers": [50, 25], "mlp_variant": "cat"}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_dim = D = config["embedding_dimension"]
        self.dropout = config["dropout"]
        self.ff_layers = list(config["ff_layers"])
        self.variant = config["mlp_variant"]
        if self.variant not in ("cat", "mul"):
            raise ValueError(f"mlp_variant {self.variant!r} not implemented")
        in_dim = D * (2 if self.variant == "cat" else 1)
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(normal_init(gen, (self.n_users, D), dev))
        self.item_embedding = nn.Parameter(normal_init(gen, (self.n_items, D), dev))
        self.mlp = MLPLayers(gen, [in_dim] + self.ff_layers, dev, act="relu",
                             dropout=self.dropout, init=xavier_uniform)
        self.out_w = nn.Parameter(xavier_uniform(gen, (self.ff_layers[-1], 1), dev))
        self.out_b = nn.Parameter(torch.zeros(1, device=dev))

    def _logits(self, user, item, generator=None):
        u = self.user_embedding[user]
        i = self.item_embedding[item]
        x = torch.cat([u, i], -1) if self.variant == "cat" else u * i
        x = self.mlp(x, generator)
        return (x @ self.out_w)[:, 0] + self.out_b[0]

    def calculate_loss(self, batch, generator=None):
        logits = self._logits(batch[self.USER_ID], batch[self.ITEM_ID], generator)
        return bce_loss(logits, batch[self.LABEL], batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch[self.USER_ID], batch[self.ITEM_ID]))
