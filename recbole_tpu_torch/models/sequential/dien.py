"""DIEN: deep interest evolution network.

Port of recbole_tpu/models/sequential/dien.py (parity target: the
reference's DIEN, recbole/model/sequential_recommender/dien.py): the
interest extractor GRU over the history's item and feature embeddings
(``gru_apply``, the fp32 instance of the recurrence kernel at H = fields x
embedding size, states zeroed past each row's length), an auxiliary
click/no-click discriminator over a position-wise negative item sequence,
the AUGRU interest evolution gated by the target attention's scores, and a
Dice DNN over [evolution, target, user features] with a sigmoid CTR output.

The negative item sequence is drawn on the device, as the JAX package draws
it: uniform over [1, n_items), then ``neg_seq_resample_rounds`` redraws of
the positions that equal the clicked item; a batch may bring its own under
``neg_<item_id_list>``. AUGRU is a ``lax.scan`` in the JAX package, not a
Pallas kernel: here it is a loop over the positions of plain torch
operations. Ranking goes through ``score_items`` in pair blocks of 4,096
(``din.score_row_pairs``).
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import MLPLayers, _GRULayer, gru_apply, xavier_normal
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model
from .din import SequenceAttention, dice, score_row_pairs, sequence_attention
from .feat_embed import ItemFeatEmbedder


def augru_apply(p, x, att):
    """AUGRU: a GRU whose update gate is scaled by the attention score
    (parity: augru_apply, JAX dien.py:27-49; AUGRUCell, reference
    dien.py:350-392). x (B, L, D), att (B, L) -> (B, L, H)."""
    B, L, _ = x.shape
    h = torch.zeros((B, p.wh.shape[0]), dtype=torch.float32, device=x.device)
    xi = x @ p.wi + p.bi
    outs = []
    for t in range(L):
        ir, iz, in_ = xi[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ p.wh + p.bh).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz) * att[:, t, None]
        h = (1 - z) * h + z * torch.tanh(in_ + r * hn)
        outs.append(h)
    return torch.stack(outs, 1)


@register_model("DIEN")
class DIEN(SequentialRecommender):
    input_type = InputType.POINTWISE
    full_sort_fallback = True
    # a pair carries the GRU and the AUGRU over the whole history
    score_pair_block = 4096
    default_config = {"embedding_size": 10, "mlp_hidden_size": [256, 256, 256],
                      "dropout_prob": 0.0, "pooling_mode": "mean",
                      "gru_type": "AUGRU", "alpha": 1.0,
                      "training_neg_sample_num": 1, "selected_features": None,
                      "neg_seq_resample_rounds": 4}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.LABEL = config["LABEL_FIELD"]
        self.embedding_size = E = config["embedding_size"]
        self.mlp_hidden_size = list(config["mlp_hidden_size"])
        self.alpha = config["alpha"]
        self.dropout_prob = config["dropout_prob"]
        self.resample_rounds = config["neg_seq_resample_rounds"]
        self.NEG_ITEM_SEQ = (config["NEG_PREFIX"] or "neg_") + self.ITEM_SEQ
        self.embedder = ItemFeatEmbedder(dataset, config["selected_features"],
                                         config["pooling_mode"], device=self.device)
        # the user feature stream feeds the DNN (reference dien.py:127)
        self.user_embedder = ItemFeatEmbedder(dataset, None, config["pooling_mode"],
                                              device=self.device, side="user")
        self.feat_dim = H = self.embedder.num_fields * E
        self.user_dim = self.user_embedder.num_fields * E
        hidden = self.mlp_hidden_size
        gen = self.init_generator()
        # the JAX init's order: the frozen tables of both sides, then the
        # trained leaves
        self.embedder.init_tables(gen, E, frozen_id=True)
        self.user_embedder.init_tables(gen, E, frozen_id=True)
        self.extractor_gru = _GRULayer(gen, H, H, self.device)
        # [2H] + mlp_hidden_size + [1], a sigmoid after every layer
        # (interest_mlp_list, reference dien.py:68)
        self.aux_mlp = MLPLayers(gen, [2 * H] + hidden + [1], self.device, act="sigmoid")
        self.att = SequenceAttention(gen, [4 * H] + hidden, self.device)
        self.augru = _GRULayer(gen, H, H, self.device)
        # the batch-norm Dice DNN (reference dien.py:77)
        self.dnn = MLPLayers(gen, [2 * H + self.user_dim] + hidden, self.device, act=dice,
                             dropout=self.dropout_prob, bn=True)
        self.predict_w = nn.Parameter(xavier_normal(gen, (hidden[-1], 1), self.device))
        self.predict_b = nn.Parameter(torch.zeros((), device=self.device))

    def const_state_map(self):
        """{JAX ``_const`` leaf: state_dict name} of both sides' frozen
        tables."""
        return {**{n: f"embedder.{n}" for n in self.embedder.table_names()},
                **{n: f"user_embedder.{n}" for n in self.user_embedder.table_names()}}

    def _interest(self, keys, seq_len):
        """The extractor GRU's states (B, L, H), zeroed past each row's
        length (the reference re-pads its packed GRU with 0, dien.py:
        168-174)."""
        valid = torch.arange(keys.shape[1], device=keys.device)[None, :] < seq_len[:, None]
        return gru_apply([self.extractor_gru], keys) * valid[..., None].to(keys.dtype)

    def _logits_parts(self, batch, target_items, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        keys = self.embedder.embed_flat(seq)
        target = self.embedder.embed_flat(target_items)
        user_emb = self.user_embedder.embed_flat(batch[self.USER_ID])
        interest = self._interest(keys, seq_len)
        # no softmax on the scores (InterestEvolvingLayer keeps
        # SequenceAttLayer's softmax_stag=False, reference dien.py:243-252)
        _, att = sequence_attention(self.att, target, interest, seq_len)
        evolution = self.gather_last(augru_apply(self.augru, interest, att), seq_len)
        x = torch.cat([evolution, target, user_emb], -1)
        # dropout -> linear -> batch norm -> dice (the reference's MLPLayers)
        x = self.dnn(x, generator=generator, bn_w=batch.get("_weight"))
        return (x @ self.predict_w)[:, 0] + self.predict_b, keys, interest

    def _logits(self, batch, target_items, generator=None):
        return self._logits_parts(batch, target_items, generator)[0]

    def negative_sequence(self, seq, generator):
        """A negative item a position: uniform over [1, n_items), the
        positions equal to the clicked item redrawn ``resample_rounds``
        times (parity: JAX dien.py:154-165)."""
        neg = torch.randint(1, self.n_items, seq.shape, generator=generator, device=seq.device)
        for _ in range(self.resample_rounds):
            redraw = torch.randint(1, self.n_items, seq.shape, generator=generator,
                                   device=seq.device)
            neg = torch.where(neg == seq, redraw, neg)
        return neg

    def calculate_loss(self, batch, generator=None):
        """(BCE of the CTR output, alpha x the auxiliary loss): the
        discriminator over all (B, L - 1) positions, padded ones included
        (the reference never uses the lengths it passes, dien.py:177-214),
        each log clamped at -100 as torch's BCE clamps it; rows of weight
        0 left out."""
        logits, keys, interest = self._logits_parts(batch, batch[self.POS_ITEM_ID], generator)
        main = bce_loss(logits, batch[self.LABEL].to(torch.float32), batch.get("_weight"))
        seq = batch[self.ITEM_SEQ]
        neg_seq = batch.get(self.NEG_ITEM_SEQ)
        if neg_seq is None:
            if generator is None:
                generator = torch.Generator(device=seq.device).manual_seed(0)
            neg_seq = self.negative_sequence(seq, generator)
        neg_keys = self.embedder.embed_flat(neg_seq)
        h = interest[:, :-1, :]
        p_click = self.aux_mlp(torch.cat([h, keys[:, 1:, :]], -1))[..., 0]
        p_noclick = self.aux_mlp(torch.cat([h, neg_keys[:, 1:, :]], -1))[..., 0]
        per = -(torch.clamp(torch.log(p_click), min=-100.0)
                + torch.clamp(torch.log(1.0 - p_noclick), min=-100.0))     # (B, L - 1)
        w = batch.get("_weight")
        if w is None:
            aux = torch.mean(per) / 2.0
        else:
            aux = torch.sum(per * w[:, None]) / (
                2.0 * per.shape[1] * torch.clamp(torch.sum(w), min=1.0))
        return main, self.alpha * aux

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch, batch[self.ITEM_ID]))

    def score_items(self, batch, items):
        return score_row_pairs(self._logits, batch,
                               (self.ITEM_SEQ, self.ITEM_SEQ_LEN, self.USER_ID), items,
                               int(self.score_pair_block))
