"""GRU4Rec: session-based recommendation with a recurrent encoder.

Port of recbole_tpu/models/sequential/gru4rec.py (parity target: reference
GRU4Rec, recbole/model/sequential_recommender/gru4rec.py): item embedding
and dropout, a multi-layer GRU, a dense projection back to the embedding
width; the output at the last position scores the items; CE over all items
or BPR with one sampled negative. The parameters keep the JAX param tree's
paths: ``item_embedding``, ``gru.<i>.{wi,wh,bi,bh}``, ``dense_w``,
``dense_b``. The GRU runs in the compute dtype (bfloat16 by default, the
bf16 instance of the recurrence kernel; ``compute_dtype: float32`` selects
the fp32 instance).
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import GRU, embedding_init, gru_apply, xavier_uniform, dropout_apply, dot_c
from ..losses import bpr_loss, ce_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("GRU4Rec")
class GRU4Rec(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of these tables' gradients to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "hidden_size": 128, "num_layers": 1,
                      "dropout_prob": 0.3, "loss_type": "CE",
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.hidden_size = config["hidden_size"]
        self.num_layers = config["num_layers"]
        self.dropout_prob = config["dropout_prob"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(
            gen, self.n_items, self.embedding_size, self.device))
        self.gru = GRU(gen, self.embedding_size, self.hidden_size, self.num_layers,
                       self.device)
        self.dense_w = nn.Parameter(xavier_uniform(
            gen, (self.hidden_size, self.embedding_size), self.device))
        self.dense_b = nn.Parameter(torch.zeros(self.embedding_size, device=self.device))

    def forward(self, batch, generator=None):
        """(B, D) output at each sequence's last position. Dropout runs in
        train mode when a generator is given."""
        seq = batch[self.ITEM_SEQ]
        x = self.embed_seq(seq)
        if generator is not None and self.training and self.dropout_prob > 0:
            x = dropout_apply(generator, x, self.dropout_prob)
        h = gru_apply(self.gru, x, compute_dtype=self.cdt)
        h = dot_c(h, self.dense_w, self.cdt) + self.dense_b
        return self.gather_last(h, batch[self.ITEM_SEQ_LEN])

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        if self.loss_type == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            pos_score = torch.sum(out * self.item_embedding[pos], -1)
            neg_score = torch.sum(out * self.item_embedding[neg], -1)
            return bpr_loss(pos_score, neg_score, w)
        logits = dot_c(out, self.item_embedding.T, self.cdt)
        return ce_loss(logits, pos, w)

    def full_sort_query(self, batch):
        """The fused eval path: scores are forward() . item_embedding^T,
        which is full_sort_predict."""
        return self.forward(batch), self.item_embedding
