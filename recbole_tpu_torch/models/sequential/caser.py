"""Caser: convolutional sequence embedding.

Port of recbole_tpu/models/sequential/caser.py (parity target: the
reference's Caser, recbole/model/sequential_recommender/caser.py): the
sequence's L x D embedding "image" through nv vertical filters (weighted
sums over time) and nh horizontal filters of every height 1..L, each
ReLU'd and max-pooled over time, then two fully connected layers with the
user embedding; CE or BPR.

The JAX package runs the horizontal filters as XLA convolutions, not
Pallas kernels, so ``torch.nn.functional.conv1d`` is their port, one call a
height (it never builds the sliding-window stack, about 11.6 GB a step at
batch 2,048). Each ``conv_h.<i>`` leaf keeps the JAX layout (h, D, nh) and
is permuted to torch's (nh, D, h) inside ``forward``, so ``convert.py``
carries it as it is. The pool is ``torch.amax``: on a tie it splits the
gradient evenly over the tied positions, as ``jnp.max`` does
(``torch.max(dim)`` would give all of it to one). Caser keeps the
sequential base's scoring, so its full sort takes the fused masked top-k.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..base import SequentialRecommender
from ..layers import dropout_apply, embedding_init, xavier_uniform
from ..losses import reg_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("Caser")
class Caser(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of these tables' gradients to match
    pad_zero_params = ("item_embedding", "user_embedding")
    default_config = {"embedding_size": 64, "dropout_prob": 0.4,
                      "reg_weight": 1e-4, "nv": 8, "nh": 16,
                      "loss_type": "CE", "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.dropout_prob = config["dropout_prob"]
        self.reg_weight = config["reg_weight"]
        self.nv = config["nv"]
        self.nh = config["nh"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        self.heights = list(range(1, self.max_seq_length + 1))
        D, L, dev = self.embedding_size, self.max_seq_length, self.device
        gen = self.init_generator()

        def xu(*shape):
            return nn.Parameter(xavier_uniform(gen, shape, dev))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=dev))

        self.user_embedding = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.conv_v, self.conv_v_b = xu(L, self.nv), zeros(self.nv)
        self.conv_h = nn.ParameterList([xu(h, D, self.nh) for h in self.heights])
        self.conv_h_b = nn.ParameterList([zeros(self.nh) for _ in self.heights])
        self.fc1_w = xu(self.nh * len(self.heights) + self.nv * D, D)
        self.fc1_b = zeros(D)
        self.fc2_w, self.fc2_b = xu(2 * D, D), zeros(D)

    def forward(self, batch, generator=None):
        E = self.embed_seq(batch[self.ITEM_SEQ])                        # (B, L, D)
        B = E.shape[0]
        out_v = (torch.einsum("bld,lv->bvd", E, self.conv_v)
                 + self.conv_v_b[None, :, None]).reshape(B, -1)        # (B, nv * D)
        x = E.transpose(1, 2)                                           # (B, D, L)
        out_h = torch.cat([
            torch.amax(torch.relu(F.conv1d(x, w.permute(2, 1, 0), b)), dim=2)
            for w, b in zip(self.conv_h, self.conv_h_b)], -1)           # (B, nh * L)
        z = torch.cat([out_v, out_h], -1)
        if generator is not None and self.training and self.dropout_prob > 0:
            z = dropout_apply(generator, z, self.dropout_prob)
        z = torch.relu(z @ self.fc1_w + self.fc1_b)
        u = self.user_embedding[batch[self.USER_ID]]
        return torch.relu(torch.cat([z, u], -1) @ self.fc2_w + self.fc2_b)

    def calculate_loss(self, batch, generator=None):
        # the five tables' Frobenius norms; conv_h stays out, as in the
        # reference, whose reg_loss_conv_h multiplies a running zero
        # (caser.py:132-140)
        reg = reg_loss([self.user_embedding, self.item_embedding, self.conv_v,
                        self.fc1_w, self.fc2_w])
        return super().calculate_loss(batch, generator) + self.reg_weight * reg
