"""FFM: field-aware factorization machine.

Port of recbole_tpu/models/context/ffm.py (parity target: the reference's
FFM, recbole/model/context_aware_recommender/ffm.py): each feature keeps an
embedding for every field it meets, and the pair (i, j) is scored with
<v_{i, field j}, v_{j, field i}>, beside the family's first-order term.

The field-aware token table ``ffm_token_embedding`` is (V, F, D), with a
(n_float, F, D) table for the float fields; a token_seq field falls back to
its pooled embedding, repeated for every field. The JAX package gathers
the 3-D table plainly, outside Pallas, so plain torch indexing is its port
(one gather of every token field's rows). The port has one device, so
there is no mesh padding of the vocabulary (the JAX model's
``_token_vocab_real``).
"""

import torch
from torch import nn

from ..layers import xavier_normal
from ..losses import bce_loss
from .. import register_model
from .context_base import ContextRecommender


@register_model("FFM")
class FFM(ContextRecommender):
    default_config = {"embedding_size": 10, "fields": None}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        F, D = self.num_fields, self.embedding_size
        ii, jj = torch.triu_indices(F, F, offset=1, device=self.device)
        self.register_buffer("pair_i", ii, persistent=False)
        self.register_buffer("pair_j", jj, persistent=False)
        gen = self.init_generator()
        self.init_context_params(gen)
        if self.token_vocab_total:
            self.ffm_token_embedding = nn.Parameter(
                xavier_normal(gen, (self.token_vocab_total, F, D), self.device))
        if self.float_fields:
            self.ffm_float_embedding = nn.Parameter(
                xavier_normal(gen, (len(self.float_fields), F, D), self.device))

    def _field_aware_embeddings(self, batch):
        """(B, F_src, F_dst, D)."""
        parts = []
        if self.token_fields:
            parts.append(self.ffm_token_embedding[self._token_ids(batch)])
        if self.float_fields:
            parts.append(self.ffm_float_embedding[None]
                         * self._float_values(batch)[:, :, None, None])
        for pooled, _ in self._seq_terms(batch):
            parts.append(pooled[:, None, None, :].expand(-1, 1, self.num_fields, -1))
        return torch.cat(parts, dim=1)

    def _logits(self, batch):
        fa = self._field_aware_embeddings(batch)
        vi = fa[:, self.pair_i, self.pair_j, :]                # v_i as field j sees it
        vj = fa[:, self.pair_j, self.pair_i, :]                # v_j as field i sees it
        return self.first_order(batch) + torch.sum(vi * vj, dim=(-1, -2))

    def calculate_loss(self, batch, generator=None):
        return bce_loss(self._logits(batch), batch[self.LABEL], batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch))
