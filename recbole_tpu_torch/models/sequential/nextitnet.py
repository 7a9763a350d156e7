"""NextItNet: dilated causal convolutions for next-item recommendation.

Port of recbole_tpu/models/sequential/nextitnet.py (parity target: the
reference's NextItNet, recbole/model/sequential_recommender/nextitnet.py):
``block_num`` x ``dilations`` residual blocks, each two causal dilated 1-D
convolutions (the second at twice the dilation) with a LayerNorm (eps 1e-8)
and a ReLU after each; CE or BPR.

The convolutions are XLA convolutions in the JAX package, so
``torch.nn.functional.conv1d`` is their port: the input left-padded by
(K - 1) x dilation, so that output t sees only positions up to t. Each
block's ``blocks.<i>.w1`` / ``w2`` keeps the JAX layout (K, D_in, D_out)
and is permuted to torch's (D_out, D_in, K) inside ``forward``, so
``convert.py`` carries it as it is.

The output reads position -1 of the right-padded sequence, not the last
real item (the reference's choice, nextitnet.py:87-93): the causal stack
carries the real items through the zero pad rows. NextItNet keeps the
sequential base's scoring, so its full sort takes the fused masked top-k.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..base import SequentialRecommender
from ..layers import embedding_init, layer_norm, xavier_uniform
from ..losses import fro_norm, reg_loss
from ...utils.enums import InputType
from .. import register_model


class _Block(nn.Module):
    """The 8 leaves of one residual block, under the JAX param dict's
    names."""

    def __init__(self, generator, K, D, device):
        super().__init__()
        self.w1 = nn.Parameter(xavier_uniform(generator, (K, D, D), device))
        self.b1 = nn.Parameter(torch.zeros(D, device=device))
        self.w2 = nn.Parameter(xavier_uniform(generator, (K, D, D), device))
        self.b2 = nn.Parameter(torch.zeros(D, device=device))
        self.ln1_g = nn.Parameter(torch.ones(D, device=device))
        self.ln1_b = nn.Parameter(torch.zeros(D, device=device))
        self.ln2_g = nn.Parameter(torch.ones(D, device=device))
        self.ln2_b = nn.Parameter(torch.zeros(D, device=device))


def causal_conv(x, w, b, dilation):
    """x (B, L, D), w (K, D, D) in the JAX layout -> (B, L, D): output t
    sees positions t - (K - 1) x dilation ... t."""
    pad = (w.shape[0] - 1) * dilation
    out = F.conv1d(F.pad(x.transpose(1, 2), (pad, 0)), w.permute(2, 1, 0), b,
                   dilation=dilation)
    return out.transpose(1, 2)


@register_model("NextItNet")
class NextItNet(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of this table's gradient to match
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "kernel_size": 3, "block_num": 5,
                      "dilations": [1, 4], "reg_weight": 1e-5,
                      "loss_type": "CE", "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.kernel_size = config["kernel_size"]
        self.block_num = config["block_num"]
        self.dilations = list(config["dilations"]) * self.block_num
        self.reg_weight = config["reg_weight"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.blocks = nn.ModuleList(_Block(gen, self.kernel_size, D, dev)
                                    for _ in self.dilations)
        self.out_w = nn.Parameter(xavier_uniform(gen, (D, D), dev))
        self.out_b = nn.Parameter(torch.zeros(D, device=dev))

    def forward(self, batch, generator=None):
        x = self.embed_seq(batch[self.ITEM_SEQ])
        for blk, dil in zip(self.blocks, self.dilations):
            h = causal_conv(x, blk.w1, blk.b1, dil)
            h = torch.relu(layer_norm(h, blk.ln1_g, blk.ln1_b, eps=1e-8))
            h = causal_conv(h, blk.w2, blk.b2, 2 * dil)
            h = torch.relu(layer_norm(h, blk.ln2_g, blk.ln2_b, eps=1e-8))
            x = x + h
        return x[:, -1, :] @ self.out_w + self.out_b

    def calculate_loss(self, batch, generator=None):
        # the item table and the output layer, plus each block's conv
        # kernels and LayerNorm gains (torch names a LayerNorm's scale
        # "weight", and the reference's filter takes every *weight;
        # nextitnet.py:95-123)
        reg = reg_loss([self.item_embedding, self.out_w]) + sum(
            fro_norm(b.w1) + fro_norm(b.w2) + fro_norm(b.ln1_g) + fro_norm(b.ln2_g)
            for b in self.blocks)
        return super().calculate_loss(batch, generator) + self.reg_weight * reg
