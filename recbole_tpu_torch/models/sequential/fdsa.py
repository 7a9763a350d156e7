"""FDSA: feature-level deeper self-attention.

Port of recbole_tpu/models/sequential/fdsa.py (parity target: the
reference's FDSA, recbole/model/sequential_recommender/fdsa.py): two causal
encoders in one step, one over the item embeddings and one over a vanilla
attention of each position's feature embeddings (VanillaAttention,
layers.py:312); the last hidden states of both concatenated through a
linear layer, then the LayerNorm shared with the inputs and a third
dropout (``fdsa.py:120-123``); scores against the item table. The frozen
feature tables are persistent buffers (``embedder.feat_<field>``).
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


@register_model("FDSA")
class FDSA(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    default_config = {"n_layers": 2, "n_heads": 2, "hidden_size": 64,
                      "inner_size": 256, "hidden_dropout_prob": 0.5,
                      "attn_dropout_prob": 0.5, "hidden_act": "gelu",
                      "layer_norm_eps": 1e-12, "initializer_range": 0.02,
                      "selected_features": None, "pooling_mode": "mean",
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
        self.embedder = ItemFeatEmbedder(dataset, config["selected_features"],
                                         config["pooling_mode"], include_item_id=False,
                                         device=self.device)
        if self.embedder.num_fields == 0:
            raise ValueError(
                "FDSA needs item side features: add the .item file's columns to load_col "
                "(e.g. load_col: {inter: [...], item: '*'}) and/or set selected_features")
        D, std = self.hidden_size, self.initializer_range
        gen = self.init_generator()
        self.embedder.init_tables(gen, D)
        emb = normal_init(gen, (self.n_items, D), self.device, std)
        emb[0] = 0.0
        self.item_embedding = nn.Parameter(emb)
        self.position_embedding = nn.Parameter(
            normal_init(gen, (self.max_seq_length, D), self.device, std))
        self.item_encoder = TransformerEncoder(gen, self.n_layers, self.n_heads, D,
                                               self.inner_size, self.device)
        self.feat_encoder = TransformerEncoder(gen, self.n_layers, self.n_heads, D,
                                               self.inner_size, self.device)
        self.va_w1 = nn.Parameter(xavier_normal(gen, (D, D), self.device))
        self.va_b1 = nn.Parameter(torch.zeros(D, device=self.device))
        self.va_w2 = nn.Parameter(xavier_normal(gen, (D, 1), self.device))
        self.concat_w = nn.Parameter(xavier_normal(gen, (2 * D, D), self.device))
        self.concat_b = nn.Parameter(torch.zeros(D, device=self.device))
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
        pos = self.position_embedding[None, :L, :]

        item_x = layer_norm(self.embed_seq(seq) + pos, self.ln_g, self.ln_b)
        feats = self.embedder.embed(seq)                                   # (B, L, F, D)
        energy = (torch.relu(feats @ self.va_w1 + self.va_b1) @ self.va_w2)[..., 0]
        weight = torch.softmax(energy, dim=-1)
        feat_x = torch.sum(feats * weight[..., None], dim=-2) + pos
        feat_x = layer_norm(feat_x, self.ln_g, self.ln_b)
        dropping = gen is not None and self.hidden_dropout_prob > 0
        if dropping:
            item_x = dropout_apply(gen, item_x, self.hidden_dropout_prob)
            feat_x = dropout_apply(gen, feat_x, self.hidden_dropout_prob)

        key_valid = (torch.arange(L, device=seq.device)[None, :]
                     < seq_len[:, None]).to(torch.int32)
        kw = dict(act=self.hidden_act,
                  dropout=self.hidden_dropout_prob if gen is not None else 0.0,
                  attn_dropout=self.attn_dropout_prob if gen is not None else 0.0,
                  generator=gen, compute_dtype=self.trm_cdt, mask_spec=(key_valid, True),
                  fused=self.config["fused_attention"])
        item_h = transformer_apply(self.item_encoder.layer_params(), item_x, None,
                                   self.n_heads, **kw)
        feat_h = transformer_apply(self.feat_encoder.layer_params(), feat_x, None,
                                   self.n_heads, **kw)
        both = torch.cat([self.gather_last(item_h, seq_len),
                          self.gather_last(feat_h, seq_len)], dim=-1)
        out = layer_norm(both @ self.concat_w + self.concat_b, self.ln_g, self.ln_b)
        if dropping:
            out = dropout_apply(gen, out, self.hidden_dropout_prob)
        return out
