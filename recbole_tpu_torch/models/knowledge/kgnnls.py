"""KGNN-LS: KGCN with label-smoothness regularisation.

Port of recbole_tpu/models/knowledge/kgnnls.py (parity target: reference
KGNNLS, recbole/model/knowledge_aware_recommender/kgnnls.py). KGCN's
aggregation plus a label-smoothness term: each user's labels (1 for a
train positive, 0 for a construction-time sample of random user-item pairs,
0.5 unknown) are propagated over the candidate item's sampled neighbourhood
with the same user-relation attention, the item itself held out, and its
propagated label is scored by BCE against the true label. The two label
tables (the history for the 1s, a sampled per-user matrix for the 0s) are
non-persistent buffers.
"""

import numpy as np
import torch

from ..losses import bce_loss
from .. import register_model
from .kgcn import KGCN


def sample_neg_label_table(users, items, n_users, n_items, seed):
    """As many 0-labelled (user, item) pairs as there are positives,
    rejecting collisions with the positives, as a padded per-user matrix and
    its lengths (parity: JAX :28-60, reference sample_neg_interaction,
    kgnnls.py:113-132: ids drawn from the INCLUSIVE ranges [0, n_users] x
    [0, n_items]). The same RandomState draws as the JAX package, so the
    same arrays."""
    rng = np.random.RandomState(seed)
    offset = np.int64(n_items + 1)
    pos = set((users.astype(np.int64) * offset + items).tolist())
    need = len(users)
    got = set()
    while len(got) < need:
        u = rng.randint(0, n_users + 1, size=2 * (need - len(got)))
        i = rng.randint(0, n_items + 1, size=u.shape[0])
        for k in (u.astype(np.int64) * offset + i).tolist():
            if k not in pos and k not in got:
                got.add(k)
                if len(got) == need:
                    break
    keys = np.fromiter(got, np.int64, len(got))
    nu = (keys // offset).astype(np.int64)
    ni = (keys % offset).astype(np.int32)
    order = np.argsort(nu, kind="stable")
    nu, ni = nu[order], ni[order]
    counts = np.bincount(nu, minlength=n_users + 1)
    width = max(int(counts.max()), 1)
    table = np.zeros((n_users + 1, width), np.int32)
    lens = counts.astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for u in np.unique(nu):
        s = starts[u]
        table[u, :counts[u]] = ni[s:s + counts[u]]
    return table, lens


@register_model("KGNNLS")
class KGNNLS(KGCN):
    default_config = {**KGCN.default_config, "ls_weight": 0.5}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.ls_weight = config["ls_weight"]
        hist, hlen = dataset.history_item_matrix()
        users = dataset.inter_feat[dataset.uid_field]
        items = dataset.inter_feat[dataset.iid_field]
        neg_table, neg_lens = sample_neg_label_table(users, items, self.n_users, self.n_items,
                                                     config["seed"] or 2020)
        for name, arr in (("hist", hist), ("hlen", hlen), ("neg_hist", neg_table),
                          ("neg_len", neg_lens)):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr), dtype=torch.int64,
                                                       device=self.device), persistent=False)

    def _initial_labels(self, user, ents):
        """(B, M) labels of an entity block: 1.0 for the user's train
        positives, 0.0 for the sampled negative pairs, 0.5 unknown (reference
        lookup_interaction_table, kgnnls.py:317-324)."""
        def member(table, lens):
            t = table[user]
            valid = torch.arange(t.shape[1], device=t.device)[None, :] < lens[user][:, None]
            return torch.any((ents[:, :, None] == t[:, None, :]) & valid[:, None, :], -1)

        pos = member(self.hist, self.hlen)
        neg = member(self.neg_hist, self.neg_len)
        half = torch.full(ents.shape, 0.5, device=ents.device)
        return torch.where(pos, torch.ones_like(half), torch.where(neg, torch.zeros_like(half),
                                                                   half))

    def _label_smoothness(self, user, item, label, weight):
        """The reference's label propagation (kgnnls.py:298-371; JAX
        :95-131): initial labels a hop with the batch item held out at 0.5,
        labelled entities pinned by reset masks, n_iter rounds of
        attention-weighted neighbour mixing (the same ÷D score mean and ÷S
        neighbour mean as the aggregator), BCE on the held-out item's
        propagated label."""
        u_e = self.user_embedding[user]
        entities, relations = self._hops(item)
        labels, resets = [], []
        for ents in entities:
            lbl = self._initial_labels(user, ents)
            holdout = ents != item[:, None]
            resets.append((lbl != 0.5) & holdout)
            labels.append(torch.where(holdout, lbl, torch.full_like(lbl, 0.5)))
        for it in range(self.n_iter):
            new_labels = []
            for hop in range(self.n_iter - it):
                B, M = labels[hop].shape
                neigh = labels[hop + 1].reshape(B, M, self.S)
                rels = self.relation_embedding[relations[hop].reshape(B, M, self.S)]
                agg = torch.mean(self._neighbor_scores(u_e, rels) * neigh, -1)
                new_labels.append(torch.where(resets[hop], labels[hop], agg))
            labels = new_labels
        return bce_loss(labels[0][:, 0], label, weight)

    def calculate_loss(self, batch, generator=None):
        """BCE + ls_weight x the label-smoothness BCE + the L2 term (parity:
        JAX :133-147)."""
        loss, reg = self._rec_loss(batch)
        ls_loss = self._label_smoothness(batch[self.USER_ID], batch[self.ITEM_ID],
                                         batch[self.LABEL], batch.get("_weight"))
        return loss + self.ls_weight * ls_loss + reg
