"""FwFM: field-weighted factorization machine.

Port of recbole_tpu/models/context/fwfm.py: the FM's pairwise inner
products, each weighted by one trained scalar a field pair
(``pair_weight``, zero at init), beside the first-order term.

The JAX package deviates from the reference on purpose: the reference's
fwfm_layer (fwfm.py:101-121) draws a fresh torch.randn pair weight on every
call, noise that is never trained. The port follows the JAX package's
formulation, and its tests hold it to the JAX package only.
"""

import torch
from torch import nn

from ..losses import bce_loss
from .. import register_model
from .context_base import ContextRecommender


@register_model("FwFM")
class FwFM(ContextRecommender):
    default_config = {"embedding_size": 10, "dropout_prob": 0.0, "fields": None}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        F = self.num_fields
        ii, jj = torch.triu_indices(F, F, offset=1, device=self.device)
        self.register_buffer("pair_i", ii, persistent=False)
        self.register_buffer("pair_j", jj, persistent=False)
        self.init_context_params(self.init_generator())
        self.pair_weight = nn.Parameter(torch.zeros(ii.shape[0], device=self.device))

    def _logits(self, batch):
        emb, linear = self.embed_and_first_order(batch)
        inner = torch.sum(emb[:, self.pair_i, :] * emb[:, self.pair_j, :], -1)
        return linear + inner @ self.pair_weight

    def calculate_loss(self, batch, generator=None):
        return bce_loss(self._logits(batch), batch[self.LABEL], batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch))
