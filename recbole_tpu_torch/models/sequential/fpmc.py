"""FPMC: factorized personalized Markov chains.

Port of recbole_tpu/models/sequential/fpmc.py (parity target: the
reference's FPMC, recbole/model/sequential_recommender/fpmc.py):
score(u, last, i) = <UI_u, IU_i> + <LI_last, IL_i>, BPR with one negative.
The roles follow the reference (fpmc.py:68-92): the last click is looked up
in ``LI``, the padding table, and candidates in ``IU`` and ``IL``. FPMC
defines its own ``full_sort_predict``, so its full sort takes the trainer's
non-fused step, as in the JAX package. It has no ``forward``, so
``score_items`` is the abstract base's: the batch repeated once a candidate
through ``predict`` (the JAX model inherits the sequential base's, which
needs a ``forward`` and raises).
"""

import torch
from torch import nn

from ..base import AbstractRecommender, SequentialRecommender
from ..layers import embedding_init
from ..losses import bpr_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("FPMC")
class FPMC(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows of LI; the trainer
    # zeroes row 0 of its gradient to match
    pad_zero_params = ("LI",)
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64, "training_neg_sample_num": 1}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.UI = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.IU = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.IL = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.LI = nn.Parameter(embedding_init(gen, self.n_items, D, dev))

    def _query(self, batch):
        """(user row of UI, last click's row of LI)."""
        seq = batch[self.ITEM_SEQ]
        idx = torch.clamp(batch[self.ITEM_SEQ_LEN] - 1, 0, seq.shape[1] - 1)
        last = torch.gather(seq, 1, idx[:, None])[:, 0]
        return self.UI[batch[self.USER_ID]], self.LI[last]

    def _score(self, batch, items):
        u, last = self._query(batch)
        return torch.sum(u * self.IU[items], -1) + torch.sum(last * self.IL[items], -1)

    def calculate_loss(self, batch, generator=None):
        return bpr_loss(self._score(batch, batch[self.POS_ITEM_ID]),
                        self._score(batch, batch[self.NEG_ITEM_ID]), batch.get("_weight"))

    def predict(self, batch):
        return self._score(batch, batch[self.ITEM_ID])

    score_items = AbstractRecommender.score_items

    def full_sort_predict(self, batch):
        u, last = self._query(batch)
        return u @ self.IU.T + last @ self.IL.T
