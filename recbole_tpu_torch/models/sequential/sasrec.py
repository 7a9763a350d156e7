"""SASRec: self-attentive sequential recommendation.

Port of recbole_tpu/models/sequential/sasrec.py (parity target: reference
SASRec, recbole/model/sequential_recommender/sasrec.py): item and position
embeddings, LayerNorm and dropout, a causal transformer encoder, and the
output at the last position scores the items; CE or BPR loss. The
parameters keep the JAX param tree's paths: ``item_embedding``,
``position_embedding``, ``encoder.<i>.<leaf>``, ``ln_g``, ``ln_b``.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import (TransformerEncoder, transformer_apply, layer_norm, dropout_apply,
                      normal_init, dot_c)
from ..losses import bpr_loss, ce_loss
from ...ops.trm_layer import ACTS, MAX_SMEM_BYTES, layer_route, route_floats, widths_fit
from ...utils.enums import InputType
from ...utils.logger import get_logger
from .. import register_model


@register_model("SASRec")
class SASRec(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of these tables' gradients to match
    pad_zero_params = ("item_embedding",)
    default_config = {"n_layers": 2, "n_heads": 2, "hidden_size": 64,
                      "inner_size": 256, "hidden_dropout_prob": 0.5,
                      "attn_dropout_prob": 0.5, "hidden_act": "gelu",
                      "layer_norm_eps": 1e-12, "initializer_range": 0.02,
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
        gen = self.init_generator()
        std = self.initializer_range
        item_emb = normal_init(gen, (self.n_items, self.hidden_size), self.device, std)
        item_emb[0] = 0.0
        self.item_embedding = nn.Parameter(item_emb)
        self.position_embedding = nn.Parameter(normal_init(
            gen, (self.max_seq_length, self.hidden_size), self.device, std))
        self.encoder = TransformerEncoder(gen, self.n_layers, self.n_heads,
                                          self.hidden_size, self.inner_size, self.device)
        self.ln_g = nn.Parameter(torch.ones(self.hidden_size, device=self.device))
        self.ln_b = nn.Parameter(torch.zeros(self.hidden_size, device=self.device))
        self._log_layer_route(config["fused_attention"])

    def _log_layer_route(self, fused):
        """Say once which path the whole-layer setting takes at this shape
        (transformer_apply decides it the same way on every call)."""
        if fused not in ("layer2", "layer"):
            return
        L, D, I = self.max_seq_length, self.hidden_size, self.inner_size
        if fused == "layer" and self.cdt is not None:
            get_logger().info("fused_attention 'layer' under compute dtype %s: the layers take "
                              "the attention kernel inside plain projections and FFN (the "
                              "fused_attention: True path), as the JAX package does",
                              self.cdt)
            return
        if str(self.hidden_act).lower() not in ACTS:
            get_logger().info("fused_attention %r with hidden_act %r: the whole-layer kernel "
                              "has %s; the layers take the attention kernel inside plain "
                              "projections and FFN (the fused_attention: True path), as the "
                              "JAX package does", fused, self.hidden_act, ", ".join(ACTS))
            return
        if not widths_fit(D, I, self.n_heads):
            get_logger().info("fused_attention %r at D=%d, %d heads, inner=%d: the whole-layer "
                              "kernel takes a hidden size, head width and inner size that are "
                              "multiples of 4; the layers take the attention kernel inside "
                              "plain projections and FFN (the fused_attention: True path)",
                              fused, D, self.n_heads, I)
            return
        need = 4 * route_floats(L, D, I)
        if layer_route(L, D, I, self.n_heads) == "layer":
            get_logger().info("fused_attention %r at L=%d, D=%d, inner=%d: the whole-layer "
                              "kernel (the route's rule: %d bytes of shared memory a block)",
                              fused, L, D, I, need)
        else:
            get_logger().info("fused_attention %r at L=%d, D=%d, inner=%d: the route's rule "
                              "gives the whole layer %d bytes of shared memory a block, more "
                              "than %d; the layers take the attention kernel inside plain "
                              "projections and FFN (the fused_attention: True path)", fused, L,
                              D, I, need, MAX_SMEM_BYTES)

    def forward(self, batch, generator=None):
        """(B, D) output at each sequence's last position. Dropout runs in
        train mode when a generator is given."""
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        L = seq.shape[1]
        gen = generator if self.training else None
        x = self.embed_seq(seq) + self.position_embedding[None, :L, :]
        x = layer_norm(x, self.ln_g, self.ln_b)
        if gen is not None and self.hidden_dropout_prob > 0:
            x = dropout_apply(gen, x, self.hidden_dropout_prob)
        key_valid = (torch.arange(L, device=seq.device)[None, :]
                     < seq_len[:, None]).to(torch.int32)
        h = transformer_apply(self.encoder.layer_params(), x, None, self.n_heads,
                              act=self.hidden_act,
                              dropout=self.hidden_dropout_prob if gen is not None else 0.0,
                              attn_dropout=self.attn_dropout_prob if gen is not None else 0.0,
                              generator=gen, compute_dtype=self.cdt,
                              mask_spec=(key_valid, True),
                              fused=self.config["fused_attention"])
        return self.gather_last(h, seq_len)

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        if self.loss_type == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            pos_score = torch.sum(out * self.item_embedding[pos], -1)
            neg_score = torch.sum(out * self.item_embedding[neg], -1)
            return bpr_loss(pos_score, neg_score, w)
        logits = dot_c(out, self.item_embedding.T, self.cdt)
        return ce_loss(logits, pos, w)
