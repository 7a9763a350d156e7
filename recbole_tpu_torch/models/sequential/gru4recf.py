"""GRU4RecF: GRU4Rec with parallel item and feature recurrent encoders.

Port of recbole_tpu/models/sequential/gru4recf.py (parity target: the
reference's GRU4RecF, recbole/model/sequential_recommender/gru4recf.py):
one GRU over the item embeddings (dropout first), one over the pooled item
features (``feat_embed.py``, the id left out), their outputs concatenated
through a dense layer to the embedding width; the last position scores the
items through the sequential base's stack, so full-sort evaluation takes
the fused masked top-k. Both GRUs run the fp32 instance of the recurrence
kernel (the JAX model passes no compute dtype). The frozen feature tables
are persistent buffers (``embedder.feat_<field>``), the JAX tree's
``_const`` leaves.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import GRU, dropout_apply, embedding_init, gru_apply, xavier_normal
from ...utils.enums import InputType
from .. import register_model
from .feat_embed import ItemFeatEmbedder


@register_model("GRU4RecF")
class GRU4RecF(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    default_config = {"embedding_size": 64, "hidden_size": 128,
                      "num_layers": 1, "dropout_prob": 0.3,
                      "selected_features": None, "pooling_mode": "sum",
                      "loss_type": "CE", "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.hidden_size = config["hidden_size"]
        self.num_layers = config["num_layers"]
        self.dropout_prob = config["dropout_prob"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        self.embedder = ItemFeatEmbedder(dataset, config["selected_features"],
                                         config["pooling_mode"], include_item_id=False,
                                         device=self.device)
        if self.embedder.num_fields == 0:
            raise ValueError(
                "GRU4RecF needs item side features: add the .item file's "
                "columns to load_col (e.g. load_col: {inter: [...], "
                "item: '*'}) and/or set selected_features")
        D, H, F = self.embedding_size, self.hidden_size, self.embedder.num_fields
        gen = self.init_generator()
        # the JAX init's order: the frozen tables, then the trained leaves
        self.embedder.init_tables(gen, D)
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, self.device))
        self.item_gru = GRU(gen, D, H, self.num_layers, self.device)
        self.feat_gru = GRU(gen, F * D, H, self.num_layers, self.device)
        self.dense_w = nn.Parameter(xavier_normal(gen, (2 * H, D), self.device))
        self.dense_b = nn.Parameter(torch.zeros(D, device=self.device))

    def const_state_map(self):
        """{JAX ``_const`` leaf: state_dict name} of the frozen tables."""
        return {n: f"embedder.{n}" for n in self.embedder.table_names()}

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        x = self.embed_seq(seq)
        if generator is not None and self.training and self.dropout_prob > 0:
            x = dropout_apply(generator, x, self.dropout_prob)
        item_out = gru_apply(self.item_gru, x)
        feat_out = gru_apply(self.feat_gru, self.embedder.embed_flat(seq))   # (B, L, F*D) in
        out = torch.cat([item_out, feat_out], -1) @ self.dense_w + self.dense_b
        return self.gather_last(out, batch[self.ITEM_SEQ_LEN])
