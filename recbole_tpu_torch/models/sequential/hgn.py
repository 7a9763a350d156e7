"""HGN: hierarchical gating network.

Port of recbole_tpu/models/sequential/hgn.py (parity target: the
reference's HGN, recbole/model/sequential_recommender/hgn.py): a feature
gate (a sigmoid a dimension, from the item and the user), an instance gate
(a sigmoid a position), average or max pooling, plus the user term and the
sum of the history's item embeddings; BPR with one negative by default.

There are no position masks, as in the reference (hgn.py:99-164): a pad
position's row is the zero [PAD] row, so it adds nothing to the values, but
its instance-gate score still counts in the average's denominator and the
max's argmax.

Under BPR the positive is scored against ``item_out_embedding`` and the
negative against ``item_embedding`` (the reference's quirk,
hgn.py:175-180). Scoring uses ``item_out_embedding``
(``item_embedding_key``), so the fused masked top-k takes that table
through the base's ``_item_table()``.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import embedding_init, xavier_uniform
from ..losses import bpr_loss, fro_norm
from ...utils.enums import InputType
from .. import register_model


@register_model("HGN")
class HGN(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of this table's gradient to match
    pad_zero_params = ("item_embedding",)
    item_embedding_key = "item_out_embedding"
    default_config = {"embedding_size": 64, "loss_type": "BPR",
                      "pooling_type": "average", "reg_weight": [0.0, 0.0],
                      "training_neg_sample_num": 1}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.pooling_type = config["pooling_type"]
        self.reg_weight = config["reg_weight"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D, L, dev = self.embedding_size, self.max_seq_length, self.device
        gen = self.init_generator()

        def xu(*shape):
            return nn.Parameter(xavier_uniform(gen, shape, dev))

        self.user_embedding = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.item_out_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.w1, self.w2 = xu(D, D), xu(D, D)
        self.b = nn.Parameter(torch.zeros(D, device=dev))
        self.w3, self.w4 = xu(D), xu(L, D)

    def forward(self, batch, generator=None):
        emb = self.embed_seq(batch[self.ITEM_SEQ])                      # (B, L, D)
        u = self.user_embedding[batch[self.USER_ID]]                    # (B, D)
        gated = emb * torch.sigmoid(emb @ self.w1 + (u @ self.w2)[:, None, :] + self.b)
        ig = torch.sigmoid(gated @ self.w3 + u @ self.w4.T)             # (B, L)
        inst = gated * ig[:, :, None]
        if self.pooling_type == "max":
            idx = torch.argmax(ig, dim=1)
            pooled = inst[torch.arange(inst.shape[0], device=inst.device), idx]
        else:
            pooled = torch.sum(inst, 1) / torch.clamp(torch.sum(ig, 1, keepdim=True), min=1e-8)
        return u + pooled + torch.sum(emb, 1)

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        if self.loss_type == "BPR":
            # the positive on the prediction table, the negative on the input one
            loss = bpr_loss(torch.sum(out * self.item_out_embedding[pos], -1),
                            torch.sum(out * self.item_embedding[batch[self.NEG_ITEM_ID]], -1), w)
        else:
            loss = self.output_loss(out, batch)
        # reg_1 on the four gate weights' norms, reg_2 on the batch's user,
        # positive (prediction table) and sequence representations, padded
        # scan rows masked by _weight (hgn.py:75-90); a weight of 0 (the
        # default) adds 0 and no gradient, so its term is not built
        r1, r2 = self.reg_weight
        if r1:
            loss = loss + r1 * (fro_norm(self.w1) + fro_norm(self.w2)
                                + fro_norm(self.w3) + fro_norm(self.w4))
        if r2:
            u_e = self.user_embedding[batch[self.USER_ID]]
            pos_e = self.item_out_embedding[pos]
            seq_e = self.embed_seq(batch[self.ITEM_SEQ])
            if w is not None:
                u_e, pos_e, seq_e = u_e * w[:, None], pos_e * w[:, None], seq_e * w[:, None, None]
            loss = loss + r2 * (fro_norm(u_e) + fro_norm(pos_e) + fro_norm(seq_e))
        return loss
