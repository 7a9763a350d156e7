"""SRGNN: session-based recommendation with graph neural networks.

Port of recbole_tpu/models/sequential/srgnn.py (parity target: the
reference's SRGNN, recbole/model/sequential_recommender/srgnn.py): the
session graph and its gated GNN (``session_graph.py``, with the edge
biases) for ``step`` rounds, then the attention readout, the local ``ht``
and the attended global ``a`` through a linear layer. It inherits the
sequential base's scoring, so full-sort evaluation takes the fused masked
top-k.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import embedding_init, xavier_uniform
from ...utils.enums import InputType
from .. import register_model
from .session_graph import SessionGNN, gnn_apply, session_graph


@register_model("SRGNN")
class SRGNN(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "step": 1, "loss_type": "CE",
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.step = config["step"]
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
        self.gnn = SessionGNN(gen, D, self.device, bias_edges=True)
        self.w1, self.b1 = xu(D, D), zeros()
        self.w2, self.b2 = xu(D, D), zeros()
        self.w3 = xu(D, 1)
        self.wt, self.bt = xu(2 * D, D), zeros()

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        B, L = seq.shape
        alias, a_in, a_out = session_graph(seq, seq_len)
        hidden = gnn_apply(self.gnn, a_in, a_out, self.embed_seq(seq), self.step)
        seq_hidden = torch.gather(hidden, 1, alias[:, :, None].expand(B, L, hidden.shape[2]))
        ht = self.gather_last(seq_hidden, seq_len)
        q1 = ht @ self.w1 + self.b1                                     # (B, D)
        q2 = seq_hidden @ self.w2 + self.b2                             # (B, L, D)
        alpha = torch.sigmoid(q1[:, None, :] + q2) @ self.w3            # (B, L, 1)
        valid = (torch.arange(L, device=seq.device)[None, :]
                 < seq_len[:, None]).to(torch.float32)
        a = torch.sum(alpha * seq_hidden * valid[:, :, None], 1)
        return torch.cat([a, ht], -1) @ self.wt + self.bt
