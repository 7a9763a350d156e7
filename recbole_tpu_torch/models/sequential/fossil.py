"""FOSSIL: fusing similarity models with Markov chains.

Port of recbole_tpu/models/sequential/fossil.py (parity target: the
reference's FOSSIL, recbole/model/sequential_recommender/fossil.py): a
FISM term, the history's item embeddings summed and scaled by len^-alpha,
plus a Markov term over the last ``order_len`` items weighted by the global
and the user's lambdas (``user_lambda``, a (users, order_len) table, and
``global_lambda`` start at zero); CE or BPR. The regulariser is taken on
the batch's representations (fossil.py:89-94), from the same ``forward``
output as the loss (the JAX model runs ``forward`` again; nothing in it is
random, so the value is the same); at ``reg_weight`` 0, the default, it
would add 0 and no gradient, so it is not built. FOSSIL keeps the sequential base's
scoring, so its full sort takes the fused masked top-k.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import embedding_init
from ..losses import fro_norm
from ...utils.enums import InputType
from .. import register_model


@register_model("FOSSIL")
class FOSSIL(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of this table's gradient to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "loss_type": "CE",
                      "reg_weight": 0.0, "order_len": 3, "alpha": 0.6,
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.reg_weight = config["reg_weight"]
        self.order_len = config["order_len"]
        self.alpha = config["alpha"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.user_lambda = nn.Parameter(torch.zeros((self.n_users, self.order_len), device=dev))
        self.global_lambda = nn.Parameter(torch.zeros(self.order_len, device=dev))

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        L = seq.shape[1]
        emb = self.embed_seq(seq)
        valid = (torch.arange(L, device=seq.device)[None, :] < seq_len[:, None]).to(torch.float32)
        decay = torch.pow(torch.clamp(seq_len.to(torch.float32), min=1.0), -self.alpha)
        fism = torch.sum(emb * valid[:, :, None], 1) * decay[:, None]
        pos = (seq_len[:, None] - self.order_len
               + torch.arange(self.order_len, device=seq.device)[None, :])
        idx = torch.clamp(pos, 0, L - 1)
        last = torch.gather(emb, 1, idx[:, :, None].expand(-1, -1, emb.shape[-1]))  # (B, O, D)
        lam = self.global_lambda[None, :] + self.user_lambda[batch[self.USER_ID]]
        markov = torch.sum(last * (lam * (pos >= 0))[:, :, None], 1)
        return fism + markov

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        loss = self.output_loss(out, batch)
        if not self.reg_weight:
            return loss
        w = batch.get("_weight")
        lam = self.user_lambda[batch[self.USER_ID]]
        pos_e = self.item_embedding[batch[self.POS_ITEM_ID]]
        if w is not None:
            lam, pos_e, out = lam * w[:, None], pos_e * w[:, None], out * w[:, None]
        return loss + self.reg_weight * (fro_norm(lam) + fro_norm(pos_e) + fro_norm(out))
