"""FM: factorization machine CTR model.

Port of recbole_tpu/models/context/fm.py (parity target: reference FM,
recbole/model/context_aware_recommender/fm.py): first-order linear +
second-order pairwise interactions, sigmoid + BCE.

As there, the training logits never build the (B, F, D) field tensor: the
pairwise term 0.5*((sum_f v)^2 - sum_f v^2) needs only per-field sums, so
the merged (B, F, D+1) gather reduces straight to (B, D+1), which yields
the embedding sum and the first-order bias sum at once. ``predict`` keeps
the concat path, as the JAX model does.
"""

import torch

from ..layers import fm_pairwise
from ..losses import bce_loss
from .. import register_model
from .context_base import ContextRecommender


@register_model("FM")
class FM(ContextRecommender):
    default_config = {"embedding_size": 10}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.init_context_params(self.init_generator())

    def _logits(self, batch):
        B = self.batch_len(batch)
        D = self.embedding_size
        sum_vec = torch.zeros((B, D), device=self.device)
        sq_vec = torch.zeros((B, D), device=self.device)
        linear = torch.zeros(B, device=self.device) + self.first_order_bias
        if self.token_fields:
            rows = self._token_rows(batch)                     # (B, F, D+1)
            s = torch.sum(rows, dim=1)                         # (B, D+1)
            sq = torch.sum(rows * rows, dim=1)                 # (B, D+1)
            sum_vec = sum_vec + s[:, :-1]
            linear = linear + s[:, -1]
            sq_vec = sq_vec + sq[:, :-1]
        if self.float_fields:
            vals = self._float_values(batch)
            fv = self.float_embedding[None, :, :] * vals[:, :, None]
            sum_vec = sum_vec + torch.sum(fv, dim=1)
            sq_vec = sq_vec + torch.sum(fv * fv, dim=1)
            linear = linear + vals @ self.float_weight
        for pooled, bias in self._seq_terms(batch):
            sum_vec = sum_vec + pooled
            sq_vec = sq_vec + pooled * pooled
            linear = linear + bias
        pairwise = 0.5 * torch.sum(sum_vec * sum_vec - sq_vec, dim=-1)
        return linear + pairwise

    def calculate_loss(self, batch, generator=None):
        return bce_loss(self._logits(batch), batch[self.LABEL],
                        batch.get("_weight"))

    def predict(self, batch):
        emb, linear = self.embed_and_first_order(batch)
        return torch.sigmoid(linear + fm_pairwise(emb))
