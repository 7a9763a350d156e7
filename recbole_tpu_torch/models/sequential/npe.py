"""NPE: neural personalized embedding.

Port of recbole_tpu/models/sequential/npe.py (parity target: the
reference's NPE, recbole/model/sequential_recommender/npe.py):
dropout(ReLU(user embedding)) + dropout(ReLU(sum of the sequence's item
embeddings)), the two dropouts drawn independently, scored against ReLU of
the same item table (npe.py:84-96; the reference's embedding_seq_item is
dead weight there and is not kept). ``_item_table`` returns that ReLU, so
the loss, the scores and the fused masked top-k (NPE keeps the sequential
base's scoring) all take it.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import dropout_apply, embedding_init
from ...utils.enums import InputType
from .. import register_model


@register_model("NPE")
class NPE(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of this table's gradient to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "loss_type": "CE",
                      "dropout_prob": 0.3, "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.dropout_prob = config["dropout_prob"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.user_embedding = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))

    def _item_table(self):
        return torch.relu(self.item_embedding)

    def forward(self, batch, generator=None):
        s = torch.relu(torch.sum(self.embed_seq(batch[self.ITEM_SEQ]), 1))
        u = torch.relu(self.user_embedding[batch[self.USER_ID]])
        if generator is not None and self.training and self.dropout_prob > 0:
            u = dropout_apply(generator, u, self.dropout_prob)
            s = dropout_apply(generator, s, self.dropout_prob)
        return u + s
