"""KTUP: translation-based user preference modelling, joint with TransH.

Port of recbole_tpu/models/knowledge/ktup.py (parity target: reference
KTUP, recbole/model/knowledge_aware_recommender/ktup.py). A user-item pair
is scored through an induced preference: a straight-through Gumbel softmax
over the relations picks the translation, and the user and the item are
projected on the preference's hyperplane (TransH). KGTrainer alternates
``train_rec_step`` rs epochs (``calculate_loss``) and ``train_kg_step`` kg
epochs (``calculate_kg_loss``, a TransH margin loss), 5 and 5 by default.
The Gumbel noise's uniform draws come from the trainer's generator; at
evaluation there is no noise.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..base import KnowledgeRecommender
from ..layers import xavier_normal
from ..losses import bpr_loss, emb_margin_loss
from ...utils.enums import InputType
from .. import register_model


def _project(e, norm):
    """TransH projection with the RAW norm vector, no unit normalisation
    (reference _transH_projection, ktup.py:138-140)."""
    return e - torch.sum(e * norm, -1, keepdim=True) * norm


def _orthogonal(rel, norm, w=None):
    """Sum over rows of (n . r)^2 / |r|^2 (reference orthogonalLoss,
    ktup.py:225-230)."""
    val = torch.sum(norm * rel, -1) ** 2 / torch.clamp(torch.sum(rel ** 2, -1), min=1e-12)
    if w is not None:
        val = val * w
    return torch.sum(val)


@register_model("KTUP")
class KTUP(KnowledgeRecommender):
    input_type = InputType.PAIRWISE
    default_config = {"train_rec_step": 5, "train_kg_step": 5,
                      "embedding_size": 64, "use_st_gumbel": True,
                      "L1_flag": False, "margin": 1.0, "kg_weight": 1.0,
                      "align_weight": 1.0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.use_st_gumbel = config["use_st_gumbel"]
        self.L1 = config["L1_flag"]
        self.margin = config["margin"]
        self.kg_weight = config["kg_weight"]
        self.align_weight = config["align_weight"]
        gen = self.init_generator()
        dev = self.device
        NR = self.n_relations
        self.user_embedding = nn.Parameter(xavier_normal(gen, (self.n_users, D), dev))
        self.item_embedding = nn.Parameter(xavier_normal(gen, (self.n_items, D), dev))
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        self.relation_embedding = nn.Parameter(xavier_normal(gen, (NR, D), dev))
        self.relation_norm = nn.Parameter(xavier_normal(gen, (NR, D), dev))
        self.pref_embedding = nn.Parameter(xavier_normal(gen, (NR, D), dev))
        self.pref_norm = nn.Parameter(xavier_normal(gen, (NR, D), dev))
        # pairs scored at once in a chunked full sort: a pair holds its
        # logits over the relations and about a dozen D-wide rows
        self.eval_pair_bytes = 4 * (3 * NR + 16 * D)

    def _dist(self, x):
        return torch.sum(torch.abs(x), -1) if self.L1 else torch.sum(x ** 2, -1)

    def _uniform(self, shape, generator):
        """The Gumbel noise's uniform draws in [1e-10, 1), as
        ``jax.random.uniform(rng, shape, minval=1e-10, maxval=1.0)``."""
        u = torch.rand(shape, generator=generator, device=self.device)
        return 1e-10 + u * (1.0 - 1e-10)

    def _preference(self, u_e, i_e, generator):
        """(preference, norm): the soft or straight-through mix of the
        preference and relation tables (parity: JAX :53-84)."""
        table = self.pref_embedding + self.relation_embedding
        logits = (u_e + i_e) @ (table.T / 2.0)
        if self.use_st_gumbel:
            # straight-through Gumbel softmax (reference ktup.py:98-124); at
            # evaluation no noise, the hard argmax output kept
            if generator is not None:
                g = -torch.log(-torch.log(self._uniform(logits.shape, generator) + 1e-10))
                y = torch.softmax(logits + g, -1)
            else:
                y = torch.softmax(logits, -1)
            hard = F.one_hot(torch.argmax(y, -1), logits.shape[-1]).to(y.dtype)
            probs = hard + y - y.detach()
        else:
            # no softmax when use_st_gumbel is off: the raw logits mix the
            # tables (reference _get_preferences, ktup.py:126-135)
            probs = logits
        pref = probs @ (table / 2.0)
        norm = probs @ ((self.pref_norm + self.relation_norm) / 2.0)
        return pref, norm

    def _align(self, ids, mask):
        """Masked mean item-entity distance (reference alignLoss,
        ktup.py:232-236)."""
        d = self._dist(self.item_embedding[ids] - self.entity_embedding[ids])
        return torch.sum(d * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def _rec_score(self, user, item, generator):
        u_e = self.user_embedding[user]
        i_e = self.item_embedding[item] + self.entity_embedding[
            torch.clamp(item, 0, self.n_entities - 1)]
        pref, norm = self._preference(u_e, i_e, generator)
        return -self._dist(_project(u_e, norm) + pref - _project(i_e, norm))

    def calculate_loss(self, batch, generator=None):
        """(BPR, the preference tables' orthogonality, the item-entity
        alignment) (parity: JAX :117-132); the positive's noise is drawn
        before the negative's."""
        pos = self._rec_score(batch[self.USER_ID], batch[self.ITEM_ID], generator)
        neg = self._rec_score(batch[self.USER_ID], batch[self.NEG_ITEM_ID], generator)
        w = batch.get("_weight")
        rec_loss = bpr_loss(pos, neg, w)
        orth = _orthogonal(self.pref_embedding, self.pref_norm)
        ids = torch.cat([batch[self.ITEM_ID], batch[self.NEG_ITEM_ID]])
        m = torch.ones_like(pos) if w is None else w.to(pos.dtype)
        align = self._align(ids, torch.cat([m, m]))
        return rec_loss, orth, self.align_weight * align

    def calculate_kg_loss(self, batch, generator=None):
        """(kg_weight x (TransH margin + orthogonality + margin regulariser),
        align_weight x the alignment of the batch's item entities) (parity:
        JAX :134-166, reference ktup.py:200-219)."""
        h = batch[self.HEAD_ENTITY_ID]
        r = batch[self.RELATION_ID]
        pos_t = batch[self.TAIL_ENTITY_ID]
        neg_t = batch[self.NEG_TAIL_ENTITY_ID]
        norm = self.relation_norm[r]
        E = self.entity_embedding
        h_raw, pt_raw, nt_raw = E[h], E[pos_t], E[neg_t]
        r_e = self.relation_embedding[r]
        h_e, pt_e, nt_e = (_project(x, norm) for x in (h_raw, pt_raw, nt_raw))
        pos = self._dist(h_e + r_e - pt_e)
        neg = self._dist(h_e + r_e - nt_e)
        hinge = torch.clamp(pos - neg + self.margin, min=0.0)
        w = batch.get("_weight")
        m = torch.ones_like(hinge) if w is None else w.to(hinge.dtype)
        loss = torch.mean(hinge) if w is None else torch.sum(hinge * m) / torch.clamp(
            torch.sum(m), min=1.0)
        orth = _orthogonal(r_e, norm, m)
        mc = m[:, None]
        reg = emb_margin_loss(h_raw * mc, pt_raw * mc, nt_raw * mc, r_e * mc)
        ent = torch.cat([h, pos_t, neg_t])
        ent_m = torch.cat([m, m, m]) * (ent < self.n_items).to(m.dtype)
        align = self._align(torch.clamp(ent, 0, self.n_items - 1), ent_m)
        return self.kg_weight * (loss + orth + reg), self.align_weight * align

    def predict(self, batch):
        return self._rec_score(batch[self.USER_ID], batch[self.ITEM_ID], None)
