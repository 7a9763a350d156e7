"""DeepFM: FM + deep MLP tower sharing one field embedding.

Port of recbole_tpu/models/context/deepfm.py (parity target: reference
DeepFM, recbole/model/context_aware_recommender/deepfm.py):
y = first_order + FM(emb) + MLP(flatten(emb)), sigmoid + BCE. Parameters
keep the JAX param tree's names (``mlp.<i>.w`` for ``params["mlp"][i]["w"]``).
"""

import torch
from torch import nn

from ..layers import MLPLayers, fm_pairwise, xavier_normal
from ..losses import bce_loss
from .. import register_model
from .context_base import ContextRecommender


@register_model("DeepFM")
class DeepFM(ContextRecommender):
    default_config = {"embedding_size": 10, "mlp_hidden_size": [128, 128, 128],
                      "dropout_prob": 0.2}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mlp_hidden = list(config["mlp_hidden_size"])
        self.dropout_prob = config["dropout_prob"]
        gen = self.init_generator()
        self.init_context_params(gen)
        in_dim = self.num_fields * self.embedding_size
        self.mlp = MLPLayers(gen, [in_dim] + self.mlp_hidden, self.device,
                             act="relu", dropout=self.dropout_prob)
        self.deep_out_w = nn.Parameter(
            xavier_normal(gen, (self.mlp_hidden[-1], 1), self.device))
        self.deep_out_b = nn.Parameter(torch.zeros(1, device=self.device))

    def _logits(self, batch, generator=None):
        emb, linear = self.embed_and_first_order(batch)      # fused gather
        y_fm = linear + fm_pairwise(emb)
        h = self.mlp(emb.reshape(emb.shape[0], -1), generator=generator)
        y_deep = (h @ self.deep_out_w)[:, 0] + self.deep_out_b[0]
        return y_fm + y_deep

    def calculate_loss(self, batch, generator=None):
        return bce_loss(self._logits(batch, generator), batch[self.LABEL],
                        batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch))
