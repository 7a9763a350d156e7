"""SASRecF: SASRec with item features fused into the encoder's input.

Port of recbole_tpu/models/sequential/sasrecf.py (parity target: the
reference's SASRecF, recbole/model/sequential_recommender/sasrecf.py): the
item embedding and the pooled feature embeddings (``feat_embed.py``)
concatenated, F x D, a linear layer to D, then the causal encoder; scores
against the item table. The frozen feature tables are persistent buffers
(``embedder.feat_<field>``), the JAX tree's ``_const`` leaves.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import (TransformerEncoder, dropout_apply, layer_norm, normal_init,
                      transformer_apply, xavier_normal)
from ...utils.enums import InputType
from .. import register_model
from .bert4rec import encoder_dtype
from .feat_embed import ItemFeatEmbedder


@register_model("SASRecF")
class SASRecF(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    default_config = {"n_layers": 2, "n_heads": 2, "hidden_size": 64,
                      "inner_size": 256, "hidden_dropout_prob": 0.5,
                      "attn_dropout_prob": 0.5, "hidden_act": "gelu",
                      "layer_norm_eps": 1e-12, "initializer_range": 0.02,
                      "selected_features": None, "pooling_mode": "sum",
                      "loss_type": "CE", "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.n_layers = config["n_layers"]
        self.n_heads = config["n_heads"]
        self.hidden_size = config["hidden_size"]
        self.inner_size = config["inner_size"]
        self.hidden_dropout_prob = config["hidden_dropout_prob"]
        self.attn_dropout_prob = config["attn_dropout_prob"]
        self.hidden_act = config["hidden_act"]
        self.initializer_range = config["initializer_range"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        self.trm_cdt = encoder_dtype(config)
        D, std = self.hidden_size, self.initializer_range
        self.embedder = ItemFeatEmbedder(dataset, config["selected_features"],
                                         config["pooling_mode"], include_item_id=True,
                                         device=self.device)
        gen = self.init_generator()
        # the JAX init's order: the frozen tables, then the trained leaves
        self.embedder.init_tables(gen, D)
        emb = normal_init(gen, (self.n_items, D), self.device, std)
        emb[0] = 0.0
        self.item_embedding = nn.Parameter(emb)
        self.position_embedding = nn.Parameter(
            normal_init(gen, (self.max_seq_length, D), self.device, std))
        self.concat_w = nn.Parameter(
            xavier_normal(gen, (self.embedder.num_fields * D, D), self.device))
        self.concat_b = nn.Parameter(torch.zeros(D, device=self.device))
        self.encoder = TransformerEncoder(gen, self.n_layers, self.n_heads, D, self.inner_size,
                                          self.device)
        self.ln_g = nn.Parameter(torch.ones(D, device=self.device))
        self.ln_b = nn.Parameter(torch.zeros(D, device=self.device))

    def const_state_map(self):
        """{JAX ``_const`` leaf: state_dict name} of the frozen tables."""
        return {n: f"embedder.{n}" for n in self.embedder.table_names()}

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        L = seq.shape[1]
        gen = generator if self.training else None
        fused = self.embedder.embed_flat(seq, self.item_embedding)      # (B, L, F*D)
        x = fused @ self.concat_w + self.concat_b
        x = x + self.position_embedding[None, :L, :]
        x = layer_norm(x, self.ln_g, self.ln_b)
        if gen is not None and self.hidden_dropout_prob > 0:
            x = dropout_apply(gen, x, self.hidden_dropout_prob)
        key_valid = (torch.arange(L, device=seq.device)[None, :]
                     < seq_len[:, None]).to(torch.int32)
        h = transformer_apply(
            self.encoder.layer_params(), x, None, self.n_heads, act=self.hidden_act,
            dropout=self.hidden_dropout_prob if gen is not None else 0.0,
            attn_dropout=self.attn_dropout_prob if gen is not None else 0.0,
            generator=gen, compute_dtype=self.trm_cdt, mask_spec=(key_valid, True),
            fused=self.config["fused_attention"])
        return self.gather_last(h, seq_len)
