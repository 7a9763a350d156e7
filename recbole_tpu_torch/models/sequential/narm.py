"""NARM: neural attentive session-based recommendation.

Port of recbole_tpu/models/sequential/narm.py (parity target: reference
NARM, recbole/model/sequential_recommender/narm.py): a GRU encoder in
float32 (the JAX model passes no compute dtype to ``gru_apply``, so the fp32
instance of the recurrence kernel runs), attention over the hidden states
queried by the last one, the session representation ``[c_local, c_global]``
through the bilinear ``b`` dotted with the item embeddings; CE or BPR.
Parameters keep the JAX tree's paths: ``item_embedding``,
``gru.<i>.{wi,wh,bi,bh}``, ``a1``, ``a2``, ``v``, ``b``. NARM defines
``full_sort_predict`` itself and no ``full_sort_query``, so its full-sort
evaluation takes the trainer's non-fused route, as in the JAX package.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import GRU, embedding_init, gru_apply, xavier_uniform, dropout_apply
from ..losses import bpr_loss, ce_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("NARM")
class NARM(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of these tables' gradients to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "hidden_size": 128, "n_layers": 1,
                      "dropout_probs": [0.25, 0.5], "loss_type": "CE",
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.hidden_size = config["hidden_size"]
        self.n_layers = config["n_layers"]
        self.dropout_probs = list(config["dropout_probs"])
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        gen = self.init_generator()
        D, H = self.embedding_size, self.hidden_size
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, self.device))
        self.gru = GRU(gen, D, H, self.n_layers, self.device)
        self.a1 = nn.Parameter(xavier_uniform(gen, (H, H), self.device))
        self.a2 = nn.Parameter(xavier_uniform(gen, (H, H), self.device))
        self.v = nn.Parameter(xavier_uniform(gen, (H, 1), self.device))
        self.b = nn.Parameter(xavier_uniform(gen, (2 * H, D), self.device))

    def forward(self, batch, generator=None):
        """(B, D) session representation. The two dropouts run in train mode
        when a generator is given."""
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        gen = generator if self.training else None
        x = self.embed_seq(seq)
        if gen is not None and self.dropout_probs[0] > 0:
            x = dropout_apply(gen, x, self.dropout_probs[0])
        h = gru_apply(self.gru, x)                                # (B, L, H) fp32
        ht = self.gather_last(h, seq_len)
        valid = (torch.arange(seq.shape[1], device=seq.device)[None, :]
                 < seq_len[:, None]).to(torch.float32)
        q = h @ self.a1 + (ht @ self.a2)[:, None, :]
        alpha = (torch.sigmoid(q) @ self.v)[:, :, 0] * valid
        cl = torch.sum(h * alpha[:, :, None], 1)
        # the reference's order (narm.py:91): [c_local, c_global]
        c = torch.cat([cl, ht], -1)
        if gen is not None and self.dropout_probs[1] > 0:
            c = dropout_apply(gen, c, self.dropout_probs[1])
        return c @ self.b

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        if self.loss_type == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            return bpr_loss(torch.sum(out * self.item_embedding[pos], -1),
                            torch.sum(out * self.item_embedding[neg], -1), w)
        return ce_loss(out @ self.item_embedding.T, pos, w)

    def full_sort_predict(self, batch):
        return self.forward(batch) @ self.item_embedding.T
