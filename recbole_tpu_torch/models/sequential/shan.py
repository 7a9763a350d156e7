"""SHAN: sequential hierarchical attention network.

Port of recbole_tpu/models/sequential/shan.py (parity target: the
reference's SHAN, recbole/model/sequential_recommender/shan.py): a
long-term attention pool over the whole history queried by the user
embedding, then a short-term pool over [long-term representation; the last
``short_item_length`` items], each with a -1e9 mask on the invalid
positions. The short window is taken by a clipped gather, its positions
before the sequence's start masked. SHAN keeps the sequential base's
scoring, so its full sort takes the fused masked top-k.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import embedding_init, xavier_uniform
from ..losses import fro_norm
from ...utils.enums import InputType
from .. import register_model


def attend(x, valid, w, b, query):
    """x (B, T, D), valid (B, T) bool, query (B, D) -> the attention-pooled
    (B, D): softmax over T of <relu(x w + b), query>, -1e9 where invalid."""
    scores = torch.einsum("btk,bk->bt", torch.relu(x @ w + b), query)
    alpha = torch.softmax(torch.where(valid, scores, torch.full_like(scores, -1e9)), -1)
    return torch.sum(x * alpha[:, :, None], 1)


@register_model("SHAN")
class SHAN(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of this table's gradient to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "short_item_length": 2,
                      "loss_type": "CE", "reg_weight": [0.01, 0.0001],
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.short_len = config["short_item_length"]
        self.reg_weight = config["reg_weight"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.user_embedding = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.long_w = nn.Parameter(xavier_uniform(gen, (D, D), dev))
        self.long_b = nn.Parameter(torch.zeros(D, device=dev))
        self.short_w = nn.Parameter(xavier_uniform(gen, (D, D), dev))
        self.short_b = nn.Parameter(torch.zeros(D, device=dev))

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        B, L = seq.shape
        emb = self.embed_seq(seq)
        u = self.user_embedding[batch[self.USER_ID]]
        valid = torch.arange(L, device=seq.device)[None, :] < seq_len[:, None]
        long_rep = attend(emb, valid, self.long_w, self.long_b, u)
        pos = (seq_len[:, None] - self.short_len
               + torch.arange(self.short_len, device=seq.device)[None, :])
        idx = torch.clamp(pos, 0, L - 1)
        short = torch.gather(emb, 1, idx[:, :, None].expand(-1, -1, emb.shape[-1]))
        cat = torch.cat([long_rep[:, None, :], short], 1)
        c_valid = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=seq.device),
                             pos >= 0], 1)
        return attend(cat, c_valid, self.short_w, self.short_b, u)

    def calculate_loss(self, batch, generator=None):
        # reg_1 on the two attention weights' norms, reg_2 on the batch's
        # user and positive representations, padded scan rows masked by
        # _weight (shan.py:82-90)
        w = batch.get("_weight")
        u_e = self.user_embedding[batch[self.USER_ID]]
        pos_e = self.item_embedding[batch[self.POS_ITEM_ID]]
        if w is not None:
            u_e, pos_e = u_e * w[:, None], pos_e * w[:, None]
        reg = (self.reg_weight[0] * (fro_norm(self.long_w) + fro_norm(self.short_w))
               + self.reg_weight[1] * (fro_norm(u_e) + fro_norm(pos_e)))
        return super().calculate_loss(batch, generator) + reg
