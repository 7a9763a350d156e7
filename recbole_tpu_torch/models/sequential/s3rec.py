"""S3Rec: self-supervised pretraining for sequential recommendation.

Port of recbole_tpu/models/sequential/s3rec.py (parity target: the
reference's S3Rec, recbole/model/sequential_recommender/s3rec.py), two
stages chosen by ``train_stage``:

  * pretrain: four objectives over the bidirectional encoder (the
    whole-layer kernel's ``causal = False`` instance): AAP (attributes at
    unmasked positions), MIP (masked item prediction, BCE of sigmoid(pos) -
    sigmoid(neg)), MAP (attributes at masked positions) and SP (segment
    prediction), summed as the reference sums them (no division by the
    batch). The masks, negatives and segments are drawn on the device
    (``pretrain_draws``), the negative segment from the neighbouring row;
  * finetune: the causal encoder with CE over the whole table, the [MASK]
    row included (s3rec.py:377-379), or BPR.

The attribute multi-hot of ``item_attribute`` (attribute id v > 0 at column
v - 1) is a non-persistent buffer built from the dataset. The stages meet
through ``pre_model_path``: a checkpoint the port's trainer wrote
(``S3RecTrainer``), whose parameters a finetuning model loads at
construction.
"""

import numpy as np
import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import (TransformerEncoder, dropout_apply, layer_norm, normal_init,
                      transformer_apply, xavier_normal)
from ..losses import bpr_loss, ce_loss
from ...utils.enums import FeatureType, InputType
from .. import register_model
from .bert4rec import encoder_dtype

# the objectives' heads, in the JAX init's draw order
HEADS = ("aap", "mip", "map", "sp")


@register_model("S3Rec")
class S3Rec(SequentialRecommender):
    pad_zero_params = ("item_embedding", "feature_embedding")
    default_config = {"n_layers": 2, "n_heads": 2, "hidden_size": 64,
                      "inner_size": 256, "hidden_dropout_prob": 0.5,
                      "attn_dropout_prob": 0.5, "hidden_act": "gelu",
                      "layer_norm_eps": 1e-12, "initializer_range": 0.02,
                      "item_attribute": None, "mask_ratio": 0.2,
                      "aap_weight": 1.0, "mip_weight": 0.2, "map_weight": 1.0,
                      "sp_weight": 0.5, "train_stage": "pretrain",
                      "save_step": 10, "pre_model_path": "",
                      "loss_type": "CE", "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.n_layers = config["n_layers"]
        self.n_heads = config["n_heads"]
        self.hidden_size = config["hidden_size"]
        self.inner_size = config["inner_size"]
        self.hidden_act = config["hidden_act"]
        self.hidden_dropout_prob = config["hidden_dropout_prob"]
        self.attn_dropout_prob = config["attn_dropout_prob"]
        self.initializer_range = config["initializer_range"]
        self.mask_ratio = config["mask_ratio"]
        self.aap_weight = config["aap_weight"]
        self.mip_weight = config["mip_weight"]
        self.map_weight = config["map_weight"]
        self.sp_weight = config["sp_weight"]
        self.train_stage = config["train_stage"]
        self.pre_model_path = config["pre_model_path"]
        self.loss_type = config["loss_type"]
        if self.train_stage not in ("pretrain", "finetune"):
            raise ValueError("train_stage must be pretrain or finetune")
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           and self.train_stage == "finetune" else InputType.POINTWISE)
        self.mask_token = self.n_items
        self.trm_cdt = encoder_dtype(config)

        attr_field = config["item_attribute"]
        if attr_field is None and dataset.item_feat:
            attr_field = next((f for f in dataset.item_feat
                               if dataset.field2type[f] is FeatureType.TOKEN_SEQ), None)
        if attr_field is None or dataset.item_feat is None or attr_field not in dataset.item_feat:
            raise ValueError("S3Rec needs an item attribute field (config item_attribute) "
                             "loaded from the .item file: add it to load_col")
        self.n_features = dataset.num(attr_field) - 1
        multihot = np.zeros((self.n_items + 1, self.n_features), np.float32)
        for iid, vals in enumerate(dataset.item_feat[attr_field]):
            v = np.asarray(vals, np.int64)
            v = v[v > 0]
            multihot[iid, v - 1] = 1.0
        self.register_buffer("attr_multihot", torch.as_tensor(multihot, device=self.device),
                             persistent=False)

        D, std = self.hidden_size, self.initializer_range
        gen = self.init_generator()
        emb = normal_init(gen, (self.n_items + 1, D), self.device, std)
        emb[0] = 0.0
        self.item_embedding = nn.Parameter(emb)
        self.position_embedding = nn.Parameter(
            normal_init(gen, (self.max_seq_length, D), self.device, std))
        feat = normal_init(gen, (self.n_features, D), self.device, std)
        # the JAX trainer zeroes row 0 of every pad_zero_params table at init
        feat[0] = 0.0
        self.feature_embedding = nn.Parameter(feat)
        self.encoder = TransformerEncoder(gen, self.n_layers, self.n_heads, D, self.inner_size,
                                          self.device)
        self.ln_g = nn.Parameter(torch.ones(D, device=self.device))
        self.ln_b = nn.Parameter(torch.zeros(D, device=self.device))
        for h in HEADS:
            setattr(self, f"{h}_w", nn.Parameter(xavier_normal(gen, (D, D), self.device)))
            setattr(self, f"{h}_b", nn.Parameter(torch.zeros(D, device=self.device)))
        if self.train_stage == "finetune" and self.pre_model_path:
            # the pretraining run's checkpoint (parity: init_params, :98-102)
            state = torch.load(self.pre_model_path, map_location=self.device,
                               weights_only=False)
            self.load_state_dict(state["params"])

    # ----------------------------------------------------------- encoder

    def _encode(self, seq, seq_len, bidirectional, generator=None):
        L = seq.shape[1]
        x = self.embed_seq(seq) + self.position_embedding[None, :L, :]
        x = layer_norm(x, self.ln_g, self.ln_b)
        if generator is not None and self.hidden_dropout_prob > 0:
            x = dropout_apply(generator, x, self.hidden_dropout_prob)
        if bidirectional:
            key_valid, causal = (seq != 0).to(torch.int32), False
        else:
            key_valid = (torch.arange(L, device=seq.device)[None, :]
                         < seq_len[:, None]).to(torch.int32)
            causal = True
        return transformer_apply(
            self.encoder.layer_params(), x, None, self.n_heads, act=self.hidden_act,
            dropout=self.hidden_dropout_prob if generator is not None else 0.0,
            attn_dropout=self.attn_dropout_prob if generator is not None else 0.0,
            generator=generator, compute_dtype=self.trm_cdt, mask_spec=(key_valid, causal),
            fused=self.config["fused_attention"])

    # ------------------------------------------------------------ losses

    @staticmethod
    def _bce(logits, target):
        # at a logit of exactly 0 (the zeroed row 0 of feature_embedding
        # gives one at every position) torch.maximum's half and abs's 0 give
        # the true derivative, sigmoid(0) - target; the JAX model's jnp.abs
        # takes 1 there and gives -target (ROADMAP, known faults)
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        return (torch.maximum(logits, zero) - logits * target
                + torch.log1p(torch.exp(-torch.abs(logits))))

    @staticmethod
    def _capped(loss):
        """min(loss, 100): torch's BCE clamps each log at -100."""
        return torch.minimum(loss, torch.full((), 100.0, dtype=loss.dtype, device=loss.device))

    @staticmethod
    def _softplus(x):
        """log(1 + e^x) as jnp.logaddexp(0, x)."""
        return torch.logaddexp(torch.zeros((), dtype=x.dtype, device=x.device), x)

    def pretrain_core(self, features, masked_seq, pos_items, neg_items, masked_segment,
                      pos_segment, neg_segment, last_pos, row_w=None, generator=None):
        """The four objectives over drawn tensors (parity: pretrain_core,
        :143-212). features (B, L, F) the multi-hot of ``pos_items``;
        last_pos (B,) the SP encodings' readout position."""
        B, L = masked_seq.shape
        if row_w is None:
            row_w = torch.ones(B, device=masked_seq.device)
        full = torch.full((B,), L, dtype=torch.int64, device=masked_seq.device)
        out = self._encode(masked_seq, full, True, generator)
        feat_emb = self.feature_embedding
        mask_flag = masked_seq == self.mask_token
        real = masked_seq != 0

        aap_logits = torch.einsum("bld,fd->blf", out @ self.aap_w + self.aap_b, feat_emb)
        aap_mask = (real & ~mask_flag).to(torch.float32) * row_w[:, None]
        aap = torch.sum(self._capped(self._bce(aap_logits, features)) * aap_mask[..., None])

        mip_h = out @ self.mip_w + self.mip_b
        # each side sigmoided before the difference (s3rec.py:139-144)
        pos_s = torch.sigmoid(torch.sum(mip_h * self.item_embedding[pos_items], -1))
        neg_s = torch.sigmoid(torch.sum(mip_h * self.item_embedding[neg_items], -1))
        flag_w = mask_flag.to(torch.float32) * row_w[:, None]
        mip = torch.sum(self._softplus(neg_s - pos_s) * flag_w)

        map_logits = torch.einsum("bld,fd->blf", out @ self.map_w + self.map_b, feat_emb)
        map_ = torch.sum(self._capped(self._bce(map_logits, features)) * flag_w[..., None])

        rows = torch.arange(B, device=masked_seq.device)

        def take(seq):
            return self._encode(seq, full, True, generator)[rows, last_pos]

        ctx, pos_emb, neg_emb = take(masked_segment), take(pos_segment), take(neg_segment)
        sp_h = ctx @ self.sp_w + self.sp_b
        sp_pos = torch.sigmoid(torch.sum(sp_h * pos_emb, -1))
        sp_neg = torch.sigmoid(torch.sum(sp_h * neg_emb, -1))
        sp = torch.sum(self._softplus(sp_neg - sp_pos) * row_w)
        return (self.aap_weight * aap + self.mip_weight * mip + self.map_weight * map_
                + self.sp_weight * sp)

    def pretrain_draws(self, seq, generator):
        """The pretraining draws of a batch (parity: :225-227): a (B, L)
        uniform for the masks, (B, L) negatives in [1, n_items), and two
        (B,) uniforms for the segments' lengths and starts."""
        B, L = seq.shape
        dev = seq.device
        return {"mask": torch.rand((B, L), generator=generator, device=dev),
                "neg": torch.randint(1, self.n_items, (B, L), generator=generator, device=dev),
                "seg_len": torch.rand((B,), generator=generator, device=dev),
                "seg_start": torch.rand((B,), generator=generator, device=dev)}

    def pretrain_loss(self, seq, seq_len, draws, row_w=None, generator=None):
        """The pretraining batch from ``draws`` (parity: _pretrain_loss,
        :214-256): sequences stay right-padded and the SP readout is each
        row's last real position."""
        B, L = seq.shape
        valid = seq != 0
        if row_w is None:
            row_w = torch.ones(B, device=seq.device)
        valid = valid & (row_w[:, None] > 0)
        mask_flag = (draws["mask"] < self.mask_ratio) & valid
        masked_seq = torch.where(mask_flag, self.mask_token, seq)
        neg_items = torch.where(mask_flag, draws["neg"], seq)
        half = torch.clamp(seq_len // 2, min=1)
        seg_len = (draws["seg_len"] * half).to(torch.int64) + 1
        start = (draws["seg_start"] * torch.clamp(seq_len - seg_len, min=1).to(torch.float32)
                 ).to(torch.int64)
        pos_idx = torch.arange(L, device=seq.device)[None, :]
        in_seg = (pos_idx >= start[:, None]) & (pos_idx < (start + seg_len)[:, None]) & valid
        zero = torch.zeros((), dtype=seq.dtype, device=seq.device)
        fill = torch.where(valid, self.mask_token, zero)
        masked_segment = torch.where(in_seg, self.mask_token, seq)
        pos_segment = torch.where(in_seg, seq, fill)
        rolled = torch.roll(seq, 1, dims=0)
        neg_segment = torch.where(in_seg, torch.clamp(rolled, min=1), fill)
        return self.pretrain_core(self.attr_multihot[seq], masked_seq, seq, neg_items,
                                  masked_segment, pos_segment, neg_segment,
                                  torch.clamp(seq_len - 1, 0, L - 1), row_w, generator)

    def calculate_loss(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        gen = generator if self.training else None
        if self.train_stage == "pretrain":
            draw_gen = generator or torch.Generator(device=seq.device).manual_seed(0)
            return self.pretrain_loss(seq, seq_len, self.pretrain_draws(seq, draw_gen),
                                      batch.get("_weight"), gen)
        out = self.gather_last(self._encode(seq, seq_len, False, gen), seq_len)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        table = self.item_embedding
        if self.loss_type == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            return bpr_loss(torch.sum(out * table[pos], -1), torch.sum(out * table[neg], -1), w)
        # CE over the whole table, the [MASK] row included (s3rec.py:377-379)
        return ce_loss(out @ table.T, pos, w)

    def forward(self, batch, generator=None):
        gen = generator if self.training else None
        seq_len = batch[self.ITEM_SEQ_LEN]
        return self.gather_last(self._encode(batch[self.ITEM_SEQ], seq_len, False, gen),
                                seq_len)

    def _item_table(self):
        return self.item_embedding[:self.n_items]

    def full_sort_predict(self, batch):
        """forward . item table^T. Defined here, as the JAX model defines its
        own (:289-292): the trainer's rule then sends S3Rec to the non-fused
        full-sort step, as the JAX trainer does."""
        return self.forward(batch) @ self._item_table().T
