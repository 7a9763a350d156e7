"""HRM: hierarchical representation model.

Port of recbole_tpu/models/sequential/hrm.py (parity target: the
reference's HRM, recbole/model/sequential_recommender/hrm.py): layer 1
pools the last ``high_order`` item embeddings, layer 2 pools that with the
user embedding, max or average at each layer; CE or BPR.

Layer 1's max pool takes the last ``high_order`` positions and sets the
ones before the sequence's start to 0, not -inf: a short sequence's max
includes the reference's zero pad rows (hrm.py:97-106). Its average divides
the whole sequence's sum by min(len, high_order) (hrm.py:107-113). The user
embedding and the layer-2 stack [user, hybrid] each take a dropout, drawn
from the trainer's generator in train mode. Max pools are ``torch.amax``,
which splits the gradient of a tie evenly, as ``jnp.max`` does. HRM keeps
the sequential base's scoring, so its full sort takes the fused masked
top-k.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import dropout_apply, embedding_init
from ...utils.enums import InputType
from .. import register_model


@register_model("HRM")
class HRM(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of this table's gradient to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "high_order": 2, "loss_type": "CE",
                      "dropout_prob": 0.2, "pooling_type_layer_1": "max",
                      "pooling_type_layer_2": "max",
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.high_order = config["high_order"]
        self.dropout_prob = config["dropout_prob"]
        self.pool1 = config["pooling_type_layer_1"]
        self.pool2 = config["pooling_type_layer_2"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.user_embedding = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        gen = generator if self.training and self.dropout_prob > 0 else None
        u = self.user_embedding[batch[self.USER_ID]]
        if gen is not None:
            u = dropout_apply(gen, u, self.dropout_prob)
        if self.pool1 == "max":
            pos = (seq_len[:, None] - self.high_order
                   + torch.arange(self.high_order, device=seq.device)[None, :])
            idx = torch.clamp(pos, 0, seq.shape[1] - 1)
            wemb = self.embed_seq(torch.gather(seq, 1, idx)) * (pos >= 0)[..., None]
            hybrid = torch.amax(wemb, dim=1)
        else:
            denom = torch.clamp(torch.clamp(seq_len, max=self.high_order).to(torch.float32),
                                min=1.0)
            hybrid = torch.sum(self.embed_seq(seq), 1) / denom[:, None]
        stack = torch.stack([u, hybrid], dim=1)
        if gen is not None:
            stack = dropout_apply(gen, stack, self.dropout_prob)
        if self.pool2 == "max":
            return torch.amax(stack, dim=1)
        return torch.mean(stack, dim=1)
