"""STAMP: short-term attention/memory priority model.

Port of recbole_tpu/models/sequential/stamp.py (parity target: the
reference's STAMP, recbole/model/sequential_recommender/stamp.py):
attention over the session queried by the last click and the mean memory,
two tanh towers multiplied, dotted with the item embeddings; CE or BPR.
STAMP defines ``full_sort_predict`` itself and no ``full_sort_query``, so
its full-sort evaluation takes the trainer's non-fused step, as in the JAX
package.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import embedding_init, xavier_uniform
from ...utils.enums import InputType
from .. import register_model


@register_model("STAMP")
class STAMP(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "loss_type": "CE",
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D = self.embedding_size
        gen = self.init_generator()

        def xu(*shape):
            return nn.Parameter(xavier_uniform(gen, shape, self.device))

        def zeros():
            return nn.Parameter(torch.zeros(D, device=self.device))

        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, self.device))
        self.w1, self.w2, self.w3 = xu(D, D), xu(D, D), xu(D, D)
        self.w0 = xu(D, 1)
        self.ba = zeros()
        self.mlp_a, self.mlp_a_b = xu(D, D), zeros()
        self.mlp_b, self.mlp_b_b = xu(D, D), zeros()

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        emb = self.embed_seq(seq)                                       # (B, L, D)
        valid = (torch.arange(seq.shape[1], device=seq.device)[None, :]
                 < seq_len[:, None]).to(torch.float32)
        last = self.gather_last(emb, seq_len)
        ms = torch.sum(emb * valid[:, :, None], 1) / torch.clamp(seq_len[:, None], min=1)
        q = emb @ self.w1 + (last @ self.w2)[:, None, :] + (ms @ self.w3)[:, None, :] + self.ba
        alpha = (torch.sigmoid(q) @ self.w0)[:, :, 0] * valid           # (B, L)
        ma = torch.sum(emb * alpha[:, :, None], 1) + ms
        hs = torch.tanh(ma @ self.mlp_a + self.mlp_a_b)
        ht = torch.tanh(last @ self.mlp_b + self.mlp_b_b)
        return hs * ht

    def full_sort_predict(self, batch):
        return self.forward(batch) @ self.item_embedding.T
