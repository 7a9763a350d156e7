"""MKR: multi-task KG-enhanced recommendation with cross-and-compress units.

Port of recbole_tpu/models/knowledge/mkr.py (parity target: reference MKR,
recbole/model/knowledge_aware_recommender/mkr.py). The low layers'
cross-and-compress units couple an item's and its entity's embeddings; the
RS head scores a user MLP's output against the coupled item vector, the KGE
head predicts a tail from [head; relation]. ``MKRTrainer`` runs
``calculate_rs_loss`` every epoch and ``calculate_kg_loss`` every
``kge_interval``-th. The item table is entity-sized: the KG pass looks up
head entity ids in it.

A unit's cross matrix c = v e^T is never formed: c w = v (e . w) and
c^T w = e (v . w), so each unit is four dot products a row, where the JAX
package builds the (rows, D, D) tensor. Evaluation scores (user, item)
pairs by chunks of the item axis sized by ``eval_pair_bytes``.
"""

import torch
from torch import nn

from ..base import KnowledgeRecommender
from ..layers import MLPLayers, xavier_normal
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model


class _CrossCompress(nn.Module):
    """One cross-and-compress unit's weights, named as the JAX package's
    ``cc[i]`` dict: vv, ev, ve, ee (D, 1) and the biases bv, be (D,)."""

    def __init__(self, generator, D, device):
        super().__init__()
        for name in ("vv", "ev", "ve", "ee"):
            setattr(self, name, nn.Parameter(xavier_normal(generator, (D, 1), device)))
        self.bv = nn.Parameter(torch.zeros(D, device=device))
        self.be = nn.Parameter(torch.zeros(D, device=device))

    def forward(self, v, e):
        """(v, e) (B, D) -> the coupled pair (parity: JAX :64-74): v_out =
        c vv + c^T ev + bv, e_out = c ve + c^T ee + be for c = v e^T."""
        v_out = v * (e @ self.vv) + e * (v @ self.ev) + self.bv
        e_out = v * (e @ self.ve) + e * (v @ self.ee) + self.be
        return v_out, e_out


@register_model("MKR")
class MKR(KnowledgeRecommender):
    input_type = InputType.POINTWISE
    default_config = {"embedding_size": 64, "kg_embedding_size": 64,
                      "low_layers_num": 1, "high_layers_num": 1,
                      "reg_weight": 1e-6, "use_inner_product": True,
                      "kge_interval": 3, "dropout_prob": 0.0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.L = config["low_layers_num"]
        self.H = config["high_layers_num"]
        self.reg_weight = config["reg_weight"]
        self.use_inner = config["use_inner_product"]
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(xavier_normal(gen, (self.n_users, D), dev))
        # entity-sized (reference mkr.py:64-83, Embedding(n_entities))
        self.item_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        self.relation_embedding = nn.Parameter(xavier_normal(gen, (self.n_relations, D), dev))
        self.user_mlp = MLPLayers(gen, [D] * (self.L + 1), dev, act="sigmoid")
        self.tail_mlp = MLPLayers(gen, [D] * (self.L + 1), dev, act="sigmoid")
        self.kge_mlp = MLPLayers(gen, [2 * D] * self.H + [D], dev, act="sigmoid",
                                 final_act=False)
        self.cc = nn.ModuleList(_CrossCompress(gen, D, dev) for _ in range(self.L))
        if not self.use_inner:
            self.rs_mlp = MLPLayers(gen, [2 * D] * self.H + [1], dev, act="sigmoid",
                                    final_act=False)
        # a scored pair's rows: the user MLP's layers, the item and entity
        # rows and each unit's, and the RS head's
        self.eval_pair_bytes = 4 * D * (4 * self.L + 2 * self.H + 8)

    def _cross_compress(self, v, e):
        for unit in self.cc:
            v, e = unit(v, e)
        return v, e

    def _rs_reprs(self, user, item):
        u = self.user_mlp(self.user_embedding[user])
        v, _ = self._cross_compress(self.item_embedding[item], self.entity_embedding[item])
        return u, v

    def _rs_logits(self, u, v):
        if self.use_inner:
            return torch.sum(u * v, -1)
        return self.rs_mlp(torch.cat([u, v], -1))[:, 0]

    def calculate_rs_loss(self, batch, generator=None):
        """BCE + reg_weight x the batch representations' sum of squares / 2
        (parity: JAX :92-110, reference mkr.py:123-145)."""
        w = batch.get("_weight")
        u, v = self._rs_reprs(batch[self.USER_ID], batch[self.ITEM_ID])
        loss = bce_loss(self._rs_logits(u, v), batch[self.LABEL], w)
        if w is not None:
            u = u * w[:, None]
            v = v * w[:, None]
        return loss + self.reg_weight * (torch.sum(u ** 2) + torch.sum(v ** 2)) / 2.0

    calculate_loss = calculate_rs_loss

    def calculate_kg_loss(self, batch, generator=None):
        """sum over rows of -sigmoid(score) + B reg_weight (sum h_e^2 / 2 +
        sum t_e^2 / 2) (parity: JAX :114-140, reference mkr.py:149-170): the
        head's entity id looked up in the entity-sized item table too."""
        h = batch[self.HEAD_ENTITY_ID]
        _, h_e = self._cross_compress(self.item_embedding[h], self.entity_embedding[h])
        r_e = self.relation_embedding[batch[self.RELATION_ID]]
        t_e = self.tail_mlp(self.entity_embedding[batch[self.TAIL_ENTITY_ID]])
        # the tail prediction takes its own sigmoid before the dot
        # (reference mkr.py:113-115)
        pred = torch.sigmoid(self.kge_mlp(torch.cat([h_e, r_e], -1)))
        score = torch.sigmoid(torch.sum(pred * t_e, -1))
        w = batch.get("_weight")
        w = torch.ones_like(score) if w is None else w.to(score.dtype)
        h_sq = torch.sum((h_e * w[:, None]) ** 2)
        t_sq = torch.sum((t_e * w[:, None]) ** 2)
        return torch.sum(-score * w) + torch.sum(w) * self.reg_weight * (h_sq + t_sq) / 2.0

    def predict(self, batch):
        return torch.sigmoid(self._rs_logits(*self._rs_reprs(batch[self.USER_ID],
                                                             batch[self.ITEM_ID])))
