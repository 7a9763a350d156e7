"""BERT4Rec: a bidirectional transformer trained by cloze.

Port of recbole_tpu/models/sequential/bert4rec.py (parity target: the
reference's BERT4Rec, recbole/model/sequential_recommender/bert4rec.py):
items and a [MASK] token (id ``n_items``); training masks random positions
and predicts their items through the bidirectional encoder (the whole-layer
kernel's ``causal = False`` instance); inference appends [MASK] after the
sequence and reads that position. The sequences enter with one slot more
than ``MAX_ITEM_LIST_LENGTH`` for the appended [MASK]. The parameters keep
the JAX tree's paths. The encoder gets no compute dtype, as in the JAX
package (ROADMAP, known faults): the fp32 instance, unless the config says
``compute_dtype: bfloat16``.
"""

import math

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import (TransformerEncoder, dot_c, dropout_apply, layer_norm, normal_init,
                      transformer_apply)
from ...utils.enums import InputType
from .. import register_model


def encoder_dtype(config):
    """The transformer users' encoder compute dtype: bfloat16 only where the
    config asks for it by name, else None (the JAX models pass none)."""
    return torch.bfloat16 if str(config["compute_dtype"]).lower() == "bfloat16" else None


def cloze_capacity(L, ratio):
    """M, the masked positions a row scores: ceil(L r + 6 sigma), at most L
    (a Binomial(L, r) count passes it with probability about 1e-9)."""
    mean = L * ratio
    sigma = math.sqrt(L * ratio * (1 - ratio))
    return min(L, int(math.ceil(mean + 6 * sigma)))


@register_model("BERT4Rec")
class BERT4Rec(SequentialRecommender):
    input_type = InputType.POINTWISE
    default_config = {"n_layers": 2, "n_heads": 2, "hidden_size": 64,
                      "inner_size": 256, "hidden_dropout_prob": 0.5,
                      "attn_dropout_prob": 0.5, "hidden_act": "gelu",
                      "layer_norm_eps": 1e-12, "initializer_range": 0.02,
                      "mask_ratio": 0.2, "loss_type": "CE",
                      "training_neg_sample_num": 0}

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
        self.mask_ratio = config["mask_ratio"]
        self.loss_type = config["loss_type"]
        self.mask_token = self.n_items
        self.L = self.max_seq_length + 1
        self.trm_cdt = encoder_dtype(config)
        gen = self.init_generator()
        std = self.initializer_range
        emb = normal_init(gen, (self.n_items + 1, self.hidden_size), self.device, std)
        emb[0] = 0.0
        self.item_embedding = nn.Parameter(emb)
        self.position_embedding = nn.Parameter(
            normal_init(gen, (self.L, self.hidden_size), self.device, std))
        self.encoder = TransformerEncoder(gen, self.n_layers, self.n_heads, self.hidden_size,
                                          self.inner_size, self.device)
        self.ln_g = nn.Parameter(torch.ones(self.hidden_size, device=self.device))
        self.ln_b = nn.Parameter(torch.zeros(self.hidden_size, device=self.device))

    def _encode(self, seq, generator=None):
        valid = seq != 0
        L = seq.shape[1]
        x = self.embed_seq(seq) + self.position_embedding[None, :L, :]
        x = layer_norm(x, self.ln_g, self.ln_b)
        if generator is not None and self.hidden_dropout_prob > 0:
            x = dropout_apply(generator, x, self.hidden_dropout_prob)
        # key-side masking only: a padded query row is read by nothing
        return transformer_apply(
            self.encoder.layer_params(), x, None, self.n_heads, act=self.hidden_act,
            dropout=self.hidden_dropout_prob if generator is not None else 0.0,
            attn_dropout=self.attn_dropout_prob if generator is not None else 0.0,
            generator=generator, compute_dtype=self.trm_cdt,
            mask_spec=(valid.to(torch.int32), False), fused=self.config["fused_attention"])

    def calculate_loss(self, batch, generator=None, cloze=None):
        """The cloze loss over the masked positions (parity: :76-125).
        ``cloze`` is a (B, L + 1) uniform draw (a position is masked where
        it is below ``mask_ratio``); None draws it from ``generator``."""
        seq = torch.nn.functional.pad(batch[self.ITEM_SEQ], (0, 1))
        B, L = seq.shape
        gen = generator if self.training else None
        if cloze is None:
            draw_gen = generator or torch.Generator(device=seq.device).manual_seed(0)
            cloze = torch.rand(seq.shape, generator=draw_gen, device=seq.device)
        do_mask = (cloze < self.mask_ratio) & (seq != 0)
        masked_seq = torch.where(do_mask, self.mask_token, seq)
        h = self._encode(masked_seq, gen)
        # the masked positions gathered into a fixed (B, M) buffer, earlier
        # positions first; position 0 never scores (the reference's 0-padded
        # index buffer cannot tell it from padding, bert4rec.py:229-232)
        M = cloze_capacity(L, self.mask_ratio)
        ar = torch.arange(L, device=seq.device)[None, :]
        flags = do_mask & (ar > 0)
        rank = torch.where(flags, L - ar, torch.zeros((), dtype=ar.dtype, device=seq.device))
        vals, pos = torch.topk(rank, M, dim=1)
        sel = vals > 0
        h_sel = torch.gather(h, 1, pos[:, :, None].expand(B, M, h.shape[2]))
        tgt = torch.gather(seq, 1, pos)
        logits = dot_c(h_sel, self._item_table().T, self.cdt)
        lse = torch.logsumexp(logits, -1)
        pos_logit = torch.gather(logits, 2, torch.where(sel, tgt, 0)[:, :, None])[:, :, 0]
        nll = lse - pos_logit
        w = sel.to(torch.float32)
        if "_weight" in batch:
            w = w * batch["_weight"][:, None]
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)

    def forward(self, batch, generator=None):
        """[MASK] appended after each sequence; its position read."""
        seq = torch.nn.functional.pad(batch[self.ITEM_SEQ], (0, 1))
        seq_len = batch[self.ITEM_SEQ_LEN]
        B, L = seq.shape
        pos = torch.clamp(seq_len, 0, L - 1)
        rows = torch.arange(B, device=seq.device)
        seq = seq.index_put((rows, pos), torch.full((B,), self.mask_token, dtype=seq.dtype,
                                                    device=seq.device))
        return self._encode(seq)[rows, pos]

    def _item_table(self):
        return self.item_embedding[:self.n_items]
