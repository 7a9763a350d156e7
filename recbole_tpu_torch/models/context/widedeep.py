"""WideDeep: a wide linear term plus a deep MLP.

Port of recbole_tpu/models/context/widedeep.py (parity target: the
reference's WideDeep, recbole/model/context_aware_recommender/widedeep.py):
y = first_order + MLP(flatten(emb)) through a 1-unit head, sigmoid + BCE.
Parameters keep the JAX tree's names (``mlp.<i>.w``, ``out_w``, ``out_b``).
"""

import torch
from torch import nn

from ..layers import MLPLayers, xavier_normal
from ..losses import bce_loss
from .. import register_model
from .context_base import ContextRecommender


@register_model("WideDeep")
class WideDeep(ContextRecommender):
    default_config = {"embedding_size": 10, "mlp_hidden_size": [32, 16, 8],
                      "dropout_prob": 0.1}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mlp_hidden = list(config["mlp_hidden_size"])
        self.dropout_prob = config["dropout_prob"]
        gen = self.init_generator()
        self.init_context_params(gen)
        self.mlp = MLPLayers(gen, [self.num_fields * self.embedding_size] + self.mlp_hidden,
                             self.device, act="relu", dropout=self.dropout_prob)
        self.out_w = nn.Parameter(xavier_normal(gen, (self.mlp_hidden[-1], 1), self.device))
        self.out_b = nn.Parameter(torch.zeros(1, device=self.device))

    def _logits(self, batch, generator=None):
        emb, linear = self.embed_and_first_order(batch)
        h = self.mlp(emb.reshape(emb.shape[0], -1), generator=generator)
        return linear + (h @ self.out_w)[:, 0] + self.out_b[0]

    def calculate_loss(self, batch, generator=None):
        return bce_loss(self._logits(batch, generator), batch[self.LABEL],
                        batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch))
