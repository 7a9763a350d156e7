"""RippleNet: preference propagation over per-user ripple sets.

Port of recbole_tpu/models/knowledge/ripplenet.py (parity target: reference
RippleNet, recbole/model/knowledge_aware_recommender/ripplenet.py). Each
user has n_hop "ripple sets" of KG triples seeded by their train items (a
fixed n_memory per hop, sampled once); a candidate item's embedding attends
over each hop's relation-transformed heads R h and accumulates the tails'
responses; the score is the hop-transformed item against the summed
responses. The loss is BCE minus the KG term plus the L2 term, returned as
three parts. The parameters keep the JAX param tree's names:
``entity_embedding`` (n_entities, D), ``relation_embedding`` (NR, D, D) and
``transform`` (D, D); the ripple sets are non-persistent buffers (rebuilt
from the dataset, never trained, never in a checkpoint).

Every relation transform goes through ``ops/rel_apply.py``: the
hand-written kernels on the card, the plain version on the CPU; the fp32
instance under RippleNet's default (``compute_dtype: auto`` is float32 for
the knowledge family), the bf16 one under ``compute_dtype: bfloat16``.
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..base import KnowledgeRecommender
from ..layers import xavier_normal
from ..losses import bce_loss
from ...ops.rel_apply import rel_apply
from ...utils.enums import InputType
from .. import register_model


def build_ripple_sets(hist, hlen, kg_h, kg_r, kg_t, n_users, n_hop, n_memory, seed=2020):
    """Per-user fixed-size hop memories (H, R, T), each (n_users, n_hop,
    n_memory) int32 (parity: JAX :22-58, reference _build_ripple_set,
    ripplenet.py:83-140): hop 0 seeds from the user's train items; a hop
    with no reachable triples copies the previous hop's memories; a user
    with no hop-0 triples gets all-zero ([PAD]) memories, which stay live
    rows downstream. The same RandomState draws in the same order as the
    JAX package, so the result is the same array."""
    rng = np.random.RandomState(seed)
    out = {}
    for hh, rr, tt in zip(kg_h, kg_r, kg_t):
        out.setdefault(int(hh), []).append((int(rr), int(tt)))
    H = np.zeros((n_users, n_hop, n_memory), np.int32)
    R = np.zeros((n_users, n_hop, n_memory), np.int32)
    T = np.zeros((n_users, n_hop, n_memory), np.int32)
    for u in range(n_users):
        seeds = list(hist[u][:hlen[u]])
        for hop in range(n_hop):
            triples = []
            for s in seeds:
                for rr, tt in out.get(int(s), []):
                    triples.append((int(s), rr, tt))
            if not triples:
                if hop > 0:  # copy the previous hop (ripplenet.py:126-127)
                    H[u, hop], R[u, hop], T[u, hop] = H[u, hop - 1], R[u, hop - 1], T[u, hop - 1]
                seeds = list(T[u, hop])
                continue
            idx = rng.choice(len(triples), n_memory, replace=len(triples) < n_memory)
            for j, k in enumerate(idx):
                H[u, hop, j], R[u, hop, j], T[u, hop, j] = triples[k]
            seeds = [triples[k][2] for k in idx]
    return H, R, T


@register_model("RippleNet")
class RippleNet(KnowledgeRecommender):
    input_type = InputType.POINTWISE
    default_config = {"embedding_size": 64, "n_hop": 2, "n_memory": 16,
                      "kg_weight": 0.01, "reg_weight": 1e-7}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.n_hop = config["n_hop"]
        self.n_memory = config["n_memory"]
        self.kg_weight = config["kg_weight"]
        self.reg_weight = config["reg_weight"]
        self.bf16 = self.compute_dtype == torch.bfloat16
        hist, hlen = dataset.history_item_matrix()
        h, r, t = dataset.kg_arrays()
        sets = build_ripple_sets(hist, hlen, h, r, t, self.n_users, self.n_hop,
                                 self.n_memory, config["seed"] or 2020)
        for name, arr in zip(("rip_h", "rip_r", "rip_t"), sets):
            self.register_buffer(name, torch.as_tensor(arr, dtype=torch.int64,
                                                       device=self.device), persistent=False)
        gen = self.init_generator()
        D, NR = self.embedding_size, self.n_relations
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D),
                                                           self.device))
        # relations as (D, D) matrices; the reference stores a 2-D
        # (NR, D * D) Embedding (ripplenet.py:72), so the xavier fans are
        # those of that shape
        self.relation_embedding = nn.Parameter(
            xavier_normal(gen, (NR, D * D), self.device).reshape(NR, D, D).clone())
        self.transform = nn.Parameter(xavier_normal(gen, (D, D), self.device))

    def _rel_apply(self, rels, vecs):
        """y[b, m] = R[rels[b, m]] vecs[b, m] through the rel_apply kernels,
        without a per-memory (D, D) matrix."""
        B, M = rels.shape
        D = self.embedding_size
        flat = rel_apply(vecs.reshape(B * M, D), rels.reshape(B * M), self.relation_embedding,
                         bf16=self.bf16)
        return flat.reshape(B, M, D)

    def _score_candidates(self, user, cand, return_kg=False):
        """user (B,), cand (B, C) -> (B, C) scores. The per-user ripple
        tensors are gathered once per user and shared by all C candidates
        (what keeps full-sort evaluation in memory); the relation transforms
        of every hop run as one rel_apply, which also serves the training
        loss's KG and L2 terms."""
        B = user.shape[0]
        D = self.embedding_size
        E = self.entity_embedding
        v = E[cand]                                          # (B, C, D)
        h_all = E[self.rip_h[user]]                          # (B, n_hop, M, D)
        t_all = E[self.rip_t[user]]
        r_all = self.rip_r[user]                             # (B, n_hop, M)
        rh_all = self._rel_apply(r_all.reshape(B, -1),
                                 h_all.reshape(B, -1, D)).reshape(h_all.shape)
        o_sum = torch.zeros_like(v)
        for hop in range(self.n_hop):
            probs = torch.softmax(torch.einsum("bmi,bci->bcm", rh_all[:, hop], v), dim=-1)
            o = torch.einsum("bcm,bmi->bci", probs, t_all[:, hop])
            o_sum = o_sum + o
            v = (v + o) @ self.transform
        # the item embedding has been through the transform n_hop times by
        # the final dot (reference ripplenet.py:174-178, 215-216)
        scores = torch.sum(v * o_sum, dim=-1)
        if return_kg:
            return scores, (rh_all, h_all, t_all, r_all)
        return scores

    def score_items(self, batch, items):
        return self._score_candidates(batch[self.USER_ID], items)

    def calculate_loss(self, batch, generator=None):
        """(BCE, -kg_weight x KG term, reg_weight x L2 term) (parity: JAX
        :186-231, reference ripplenet.py:220-252): the KG term is the raw
        per-hop mean of sigmoid(t . R h), subtracted; the L2 term is each
        hop's norms of the gathered heads, tails and relation matrices over
        B n_memory rows, plus the transform's norm over D."""
        user, item = batch[self.USER_ID], batch[self.ITEM_ID]
        w = batch.get("_weight")
        scores, (rh_all, h_all, t_all, r_all) = self._score_candidates(
            user, item[:, None], return_kg=True)
        loss = bce_loss(scores[:, 0], batch[self.LABEL], w)
        B = user.shape[0]
        row_w = (torch.ones(B, device=user.device) if w is None
                 else w.to(torch.float32))
        eff_b = torch.clamp(torch.sum(row_w), min=1.0)

        rec = torch.sum(t_all * rh_all, dim=-1)              # (B, n_hop, M)
        sig = torch.sigmoid(rec) * row_w[:, None, None]
        kge = torch.sum(torch.mean(sig, dim=2).sum(dim=0) / eff_b)

        # the relation matrices' norm from per-relation row counts against
        # the (NR, D, D) table, without the gathered (B, M, D, D) copy
        R = self.relation_embedding
        rel_sq = torch.sum(R.reshape(self.n_relations, -1) ** 2, dim=-1)
        reg = 0.0
        for hop in range(self.n_hop):
            h_sq = torch.sum(h_all[:, hop] ** 2, dim=(1, 2)) @ row_w
            t_sq = torch.sum(t_all[:, hop] ** 2, dim=(1, 2)) @ row_w
            onehot = F.one_hot(r_all[:, hop], self.n_relations).to(torch.float32)
            counts = torch.sum(onehot * row_w[:, None, None], dim=(0, 1))
            r_sq = counts @ rel_sq
            # EmbLoss divides by the gathered rows' count, B n_memory
            reg = reg + (torch.sqrt(torch.clamp(h_sq, min=1e-12))
                         + torch.sqrt(torch.clamp(t_sq, min=1e-12))
                         + torch.sqrt(torch.clamp(r_sq, min=1e-12))) / (eff_b * self.n_memory)
        W = self.transform
        reg = reg + torch.sqrt(torch.clamp(torch.sum(W ** 2), min=1e-12)) / W.shape[0]
        return loss, -self.kg_weight * kge, self.reg_weight * reg

    def predict(self, batch):
        return torch.sigmoid(self._score_candidates(batch[self.USER_ID],
                                                    batch[self.ITEM_ID][:, None])[:, 0])
