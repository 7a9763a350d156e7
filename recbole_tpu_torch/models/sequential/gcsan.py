"""GCSAN: graph-contextualised self-attention for session recommendation.

Port of recbole_tpu/models/sequential/gcsan.py (parity target: the
reference's GCSAN, recbole/model/sequential_recommender/gcsan.py): the
session's gated GNN (``session_graph.py``, no edge biases) for ``step``
rounds, the causal encoder over the aliased node sequence with no dropout,
then ``weight * attention's last + (1 - weight) * GNN's last``; the loss
adds ``reg_weight`` times the item table's L2 norm (``emb_loss``).
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import TransformerEncoder, embedding_init, transformer_apply
from ..losses import bpr_loss, ce_loss, emb_loss
from ...utils.enums import InputType
from .. import register_model
from .bert4rec import encoder_dtype
from .session_graph import SessionGNN, gnn_apply, session_graph


@register_model("GCSAN")
class GCSAN(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    default_config = {"n_layers": 1, "n_heads": 1, "hidden_size": 64,
                      "inner_size": 256, "hidden_dropout_prob": 0.2,
                      "attn_dropout_prob": 0.2, "hidden_act": "gelu",
                      "layer_norm_eps": 1e-12, "initializer_range": 0.02,
                      "step": 1, "weight": 0.6, "reg_weight": 5e-5,
                      "loss_type": "CE", "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.hidden_size = config["hidden_size"]
        self.n_layers = config["n_layers"]
        self.n_heads = config["n_heads"]
        self.inner_size = config["inner_size"]
        self.hidden_act = config["hidden_act"]
        self.step = config["step"]
        self.weight = config["weight"]
        self.reg_weight = config["reg_weight"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        self.trm_cdt = encoder_dtype(config)
        D = self.hidden_size
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, self.device))
        self.gnn = SessionGNN(gen, D, self.device, bias_edges=False)
        self.encoder = TransformerEncoder(gen, self.n_layers, self.n_heads, D, self.inner_size,
                                          self.device)

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        B, L = seq.shape
        alias, a_in, a_out = session_graph(seq, seq_len)
        hidden = gnn_apply(self.gnn, a_in, a_out, self.embed_seq(seq), self.step)
        seq_hidden = torch.gather(hidden, 1, alias[:, :, None].expand(B, L, hidden.shape[2]))
        ht = self.gather_last(seq_hidden, seq_len)
        key_valid = (torch.arange(L, device=seq.device)[None, :]
                     < seq_len[:, None]).to(torch.int32)
        out = transformer_apply(self.encoder.layer_params(), seq_hidden, None, self.n_heads,
                                act=self.hidden_act, compute_dtype=self.trm_cdt,
                                mask_spec=(key_valid, True),
                                fused=self.config["fused_attention"])
        at = self.gather_last(out, seq_len)
        return self.weight * at + (1 - self.weight) * ht

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        table = self.item_embedding
        if self.loss_type == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            main = bpr_loss(torch.sum(out * table[pos], -1), torch.sum(out * table[neg], -1), w)
        else:
            main = ce_loss(out @ table.T, pos, w)
        return main + self.reg_weight * emb_loss(table)
