"""DIN: deep interest network, target attention over the behaviour sequence.

Port of recbole_tpu/models/sequential/din.py (parity target: the
reference's DIN, recbole/model/sequential_recommender/din.py): the item and
feature embeddings of the history and of the target (``feat_embed.py``, the
id from the frozen table), the sequence attention (a query/key/difference/
product MLP with sigmoids, scaled by 1/sqrt(H), no softmax by default:
``sequence_attention``), a Dice-activated DNN with batch norm, and a sigmoid
CTR output trained by BCE against the label. Pointwise, one sampled
negative a row; no full-sort product exists (``full_sort_fallback``), so
ranking goes through ``score_items``, whose (sequence row, candidate) pairs
run in blocks of ``score_pair_block`` padded as the JAX package pads them
(``score_row_pairs``): the batch norm's statistics are the block's.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import MLPLayers, xavier_normal
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model
from .feat_embed import ItemFeatEmbedder


def dice(x):
    """Dice as the reference implements it (layers.py:228-248): its alpha
    is a plain zeros tensor that never trains and no standardisation runs,
    so f(x) = sigmoid(x) x."""
    return torch.sigmoid(x) * x


class SequenceAttention(nn.Module):
    """The attention's leaves under the JAX dict's names: ``mlp`` (the
    sigmoid MLP over [q, k, q - k, q k]), ``dense_w`` and the scalar
    ``dense_b``."""

    def __init__(self, generator, dims, device):
        super().__init__()
        self.mlp = MLPLayers(generator, dims, device, act="sigmoid")
        self.dense_w = nn.Parameter(xavier_normal(generator, (dims[-1], 1), device))
        self.dense_b = nn.Parameter(torch.zeros((), device=device))


def sequence_attention(att, query, keys, keys_len, softmax_stag=False):
    """parity: SequenceAttLayer (reference layers.py:251) with
    return_seq_weight=False. query (B, H), keys (B, L, H) -> the attended
    history (B, H) and the scores (B, L)."""
    B, L, H = keys.shape
    q = query[:, None, :].expand(B, L, H)
    score = (att.mlp(torch.cat([q, keys, q - keys, q * keys], -1)) @ att.dense_w)[:, :, 0] \
        + att.dense_b
    invalid = torch.arange(L, device=keys.device)[None, :] >= keys_len[:, None]
    # -1e9, not -inf: a row of padding alone softmaxes to uniform, not NaN
    score = torch.where(invalid, -1e9 if softmax_stag else 0.0, score) / (H ** 0.5)
    if softmax_stag:
        score = torch.softmax(score, dim=1)
    return torch.einsum("bl,blh->bh", score, keys), score


def score_row_pairs(logits_fn, batch, fields, items, block):
    """(B, C) scores of candidates ``items`` for each sequence row (parity:
    DIN.score_items / DIEN.score_items, JAX din.py:121-142, dien.py:
    189-212): the B x C (row, candidate) pairs in row-major order, padded to
    a whole number of blocks with row 0 and item 0, each block of ``block``
    pairs through ``logits_fn(rows' batch, items)``. The padding pairs take
    part in the block's batch-norm statistics, as they do in the JAX
    package."""
    B, C = items.shape
    P = B * C
    n_pb = -(-P // block)
    rows = torch.zeros(n_pb * block, dtype=torch.int64, device=items.device)
    rows[:P] = torch.arange(B, device=items.device).repeat_interleave(C)
    flat = torch.zeros(n_pb * block, dtype=items.dtype, device=items.device)
    flat[:P] = items.reshape(-1)
    out = [logits_fn({f: batch[f][r] for f in fields}, it)
           for r, it in zip(rows.split(block), flat.split(block))]
    return torch.cat(out)[:P].reshape(B, C)


@register_model("DIN")
class DIN(SequentialRecommender):
    input_type = InputType.POINTWISE
    full_sort_fallback = True
    # every pair drags its whole history through the attention and the DNN:
    # the pairs alive at once are bounded (JAX din.py:115-119)
    score_pair_block = 8192
    default_config = {"embedding_size": 10, "mlp_hidden_size": [256, 256, 256],
                      "dropout_prob": 0.0, "pooling_mode": "mean",
                      "training_neg_sample_num": 1, "selected_features": None}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.LABEL = config["LABEL_FIELD"]
        self.embedding_size = config["embedding_size"]
        self.mlp_hidden_size = list(config["mlp_hidden_size"])
        self.dropout_prob = config["dropout_prob"]
        self.embedder = ItemFeatEmbedder(dataset, config["selected_features"],
                                         config["pooling_mode"], device=self.device)
        self.feat_dim = H = self.embedder.num_fields * self.embedding_size
        gen = self.init_generator()
        # the JAX init's order: the frozen tables (the id's first), then the
        # trained leaves
        self.embedder.init_tables(gen, self.embedding_size, frozen_id=True)
        self.att = SequenceAttention(gen, [4 * H] + self.mlp_hidden_size, self.device)
        # the reference's dnn_mlp_layers carry BatchNorm1d (din.py:71): batch
        # statistics here, padded rows masked by _weight
        self.dnn = MLPLayers(gen, [3 * H] + self.mlp_hidden_size, self.device, act=dice,
                             dropout=self.dropout_prob, bn=True)
        self.predict_w = nn.Parameter(xavier_normal(gen, (self.mlp_hidden_size[-1], 1),
                                                    self.device))
        self.predict_b = nn.Parameter(torch.zeros((), device=self.device))

    def const_state_map(self):
        """{JAX ``_const`` leaf: state_dict name} of the frozen tables."""
        return {n: f"embedder.{n}" for n in self.embedder.table_names()}

    def _logits(self, batch, target_items, generator=None):
        seq = batch[self.ITEM_SEQ]
        keys = self.embedder.embed_flat(seq)                              # (B, L, H)
        target = self.embedder.embed_flat(target_items)                   # (B, H)
        user_emb, _ = sequence_attention(self.att, target, keys, batch[self.ITEM_SEQ_LEN])
        x = torch.cat([user_emb, target, user_emb * target], -1)
        # dropout -> linear -> batch norm -> dice (the reference's MLPLayers)
        x = self.dnn(x, generator=generator, bn_w=batch.get("_weight"))
        return (x @ self.predict_w)[:, 0] + self.predict_b

    def calculate_loss(self, batch, generator=None):
        logits = self._logits(batch, batch[self.POS_ITEM_ID], generator)
        return bce_loss(logits, batch[self.LABEL].to(torch.float32), batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch, batch[self.ITEM_ID]))

    def score_items(self, batch, items):
        return score_row_pairs(self._logits, batch, (self.ITEM_SEQ, self.ITEM_SEQ_LEN), items,
                               int(self.score_pair_block))
