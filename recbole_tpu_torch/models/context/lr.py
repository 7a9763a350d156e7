"""LR: logistic regression over all fields.

Port of recbole_tpu/models/context/lr.py (parity target: reference LR,
recbole/model/context_aware_recommender/lr.py): the first-order linear term
only, sigmoid + BCE.
"""

import torch

from ..losses import bce_loss
from .. import register_model
from .context_base import ContextRecommender


@register_model("LR")
class LR(ContextRecommender):
    default_config = {"embedding_size": 10}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.init_context_params(self.init_generator())

    def calculate_loss(self, batch, generator=None):
        return bce_loss(self.first_order(batch), batch[self.LABEL],
                        batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self.first_order(batch))
