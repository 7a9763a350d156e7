"""KGCN: knowledge graph convolutional network.

Port of recbole_tpu/models/knowledge/kgcn.py (parity target: reference KGCN,
recbole/model/knowledge_aware_recommender/kgcn.py). A candidate item's
sampled KG neighbourhood (``neighbor_sample_size`` neighbours an entity,
both edge directions, drawn once from a numpy seed) is aggregated over
``n_iter`` hops with user-relation attention; the score is the user against
the aggregated item. The neighbour tables are non-persistent buffers. The
full sort at one hop scores items in chunks of 128, each chunk's
neighbourhood gathered once for every user; past one hop it falls back to
the trainer's chunked ``score_items``, in pair blocks of 8,192.
"""

import numpy as np
import torch
from torch import nn

from ..base import KnowledgeRecommender
from ..layers import xavier_normal
from ..losses import bce_loss, emb_loss
from ...utils.enums import InputType
from .. import register_model


def build_neighbor_tables(h, r, t, n_entities, sample_size, seed=2020):
    """(n_entities, S) sampled neighbour entity and relation tables, int32
    (parity: JAX :21-40): both edge directions; an entity without neighbours
    points to itself. The same RandomState draws in the same order as the
    JAX package, so the same arrays."""
    rng = np.random.RandomState(seed)
    adj = [[] for _ in range(n_entities)]
    for hh, rr, tt in zip(h, r, t):
        adj[hh].append((tt, rr))
        adj[tt].append((hh, rr))
    ent = np.zeros((n_entities, sample_size), np.int32)
    rel = np.zeros((n_entities, sample_size), np.int32)
    for e in range(n_entities):
        if not adj[e]:
            ent[e] = e
            continue
        idx = rng.choice(len(adj[e]), sample_size, replace=len(adj[e]) < sample_size)
        for j, k in enumerate(idx):
            ent[e, j], rel[e, j] = adj[e][k]
    return ent, rel


@register_model("KGCN")
class KGCN(KnowledgeRecommender):
    input_type = InputType.POINTWISE
    default_config = {"embedding_size": 64, "n_iter": 1, "aggregator": "sum",
                      "reg_weight": 1e-7, "neighbor_sample_size": 4}

    # every (user, item) pair drags its sampled neighbour tree through the
    # aggregators: the pairs scored at once in the chunked full sort
    score_pair_block = 8192

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.n_iter = config["n_iter"]
        self.aggregator = config["aggregator"]
        self.reg_weight = config["reg_weight"]
        self.S = config["neighbor_sample_size"]
        h, r, t = dataset.kg_arrays()
        ent, rel = build_neighbor_tables(h, r, t, self.n_entities, self.S,
                                         config["seed"] or 2020)
        for name, arr in (("adj_ent", ent), ("adj_rel", rel)):
            self.register_buffer(name, torch.as_tensor(arr, dtype=torch.int64,
                                                       device=self.device), persistent=False)
        # the dense full sort is the single-hop aggregation; deeper stacks
        # take the chunked pair scoring
        self.full_sort_fallback = self.n_iter != 1
        gen = self.init_generator()
        dev = self.device
        self.user_embedding = nn.Parameter(xavier_normal(gen, (self.n_users, D), dev))
        self.entity_embedding = nn.Parameter(xavier_normal(gen, (self.n_entities, D), dev))
        self.relation_embedding = nn.Parameter(xavier_normal(gen, (self.n_relations, D), dev))
        d_in = 2 * D if self.aggregator == "concat" else D
        self.agg_w = nn.ParameterList(nn.Parameter(xavier_normal(gen, (d_in, D), dev))
                                      for _ in range(self.n_iter))
        self.agg_b = nn.ParameterList(nn.Parameter(torch.zeros(D, device=dev))
                                      for _ in range(self.n_iter))

    def _hops(self, item):
        """The hop entity lists (hop 0 the item (B, 1), hop k (B, S^k)) and
        the relations between consecutive hops."""
        entities, relations = [item[:, None]], []
        for _ in range(self.n_iter):
            prev = entities[-1]
            entities.append(self.adj_ent[prev].reshape(prev.shape[0], -1))
            relations.append(self.adj_rel[prev].reshape(prev.shape[0], -1))
        return entities, relations

    def _neighbor_scores(self, u_e, rels):
        """Softmax over the S neighbours of the user-relation score, the
        MEAN over dims (÷D) (reference mix_neighbor_vectors, kgcn.py:173-190)."""
        return torch.softmax(torch.einsum("bd,bmsd->bms", u_e, rels) / self.embedding_size, -1)

    def _mix(self, self_vec, agg, it):
        if self.aggregator == "sum":
            x = self_vec + agg
        elif self.aggregator == "neighbor":
            x = agg
        else:  # concat
            x = torch.cat([self_vec.expand_as(agg), agg], -1)
        act = torch.tanh if it == self.n_iter - 1 else torch.relu
        return act(x @ self.agg_w[it] + self.agg_b[it])

    def _item_repr(self, user, item):
        """(B, D): the item's n_iter-hop neighbourhood aggregated with
        user-relation scores (parity: JAX :79-114)."""
        D = self.embedding_size
        u_e = self.user_embedding[user]
        entities, relations = self._hops(item)
        vectors = [self.entity_embedding[e] for e in entities]
        for it in range(self.n_iter):
            new_vectors = []
            for hop in range(self.n_iter - it):
                B, M, _ = vectors[hop].shape
                neigh = vectors[hop + 1].reshape(B, M, self.S, D)
                rels = self.relation_embedding[relations[hop].reshape(B, M, self.S)]
                scores = self._neighbor_scores(u_e, rels)
                # the MEAN over the S neighbours (÷S)
                agg_n = torch.mean(scores[..., None] * neigh, 2)
                new_vectors.append(self._mix(vectors[hop], agg_n, it))
            vectors = new_vectors
        return vectors[0][:, 0]

    def _logits(self, user, item):
        return torch.sum(self.user_embedding[user] * self._item_repr(user, item), -1)

    def _pair_scores(self, users, items):
        return self._logits(users, items)

    def _rec_loss(self, batch):
        """(BCE, the L2 of the batch representations, the logits' inputs)."""
        user, item = batch[self.USER_ID], batch[self.ITEM_ID]
        w = batch.get("_weight")
        i_repr = self._item_repr(user, item)
        u_e = self.user_embedding[user]
        loss = bce_loss(torch.sum(u_e * i_repr, -1), batch[self.LABEL], w)
        # EmbLoss over the batch representations (reference kgcn.py:272-289)
        if w is not None:
            u_e = u_e * w[:, None]
            i_repr = i_repr * w[:, None]
        return loss, self.reg_weight * emb_loss(u_e, i_repr)

    def calculate_loss(self, batch, generator=None):
        loss, reg = self._rec_loss(batch)
        return loss + reg

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch[self.USER_ID], batch[self.ITEM_ID]))

    def full_sort_predict(self, batch):
        """Dense single-hop full sort (parity: JAX :150-193): the items in
        chunks of 128, each chunk's (C, S) neighbours and relations gathered
        once and every user routed through them by products."""
        E = self.entity_embedding
        W, b = self.agg_w[0], self.agg_b[0]
        u_e = self.user_embedding[batch[self.USER_ID]]
        n = self.n_items
        chunk = min(128, n)
        out = []
        for lo in range(0, n, chunk):
            ids = torch.arange(lo, min(lo + chunk, n), device=u_e.device)
            neigh = E[self.adj_ent[ids]]                          # (C, S, D)
            rels = self.relation_embedding[self.adj_rel[ids]]
            self_vec = E[ids]
            p = torch.softmax(torch.einsum("bd,csd->bcs", u_e, rels)
                              / self.embedding_size, -1)
            agg = torch.einsum("bcs,csd->bcd", p, neigh) / self.S
            if self.aggregator == "sum":
                x = self_vec[None] + agg
            elif self.aggregator == "neighbor":
                x = agg
            else:  # concat
                x = torch.cat([self_vec[None].expand_as(agg), agg], -1)
            x = torch.tanh(x @ W + b)
            out.append(torch.einsum("bd,bcd->bc", u_e, x))
        return torch.cat(out, dim=1)
