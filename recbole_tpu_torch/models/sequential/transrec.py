"""TransRec: translation-based recommendation.

Port of recbole_tpu/models/sequential/transrec.py (parity target: the
reference's TransRec, recbole/model/sequential_recommender/transrec.py):
items are points, a user a translation vector beside the shared T, and
score(u, last, i) = bias_i - ||last + u + T - i||, the true L2 distance with
its square clamped at 1e-12 before the root; BPR with one negative.

The regulariser is ``EmbLoss`` on the positive item's, the user's and the
bias's lookups taken without gradient (the reference detaches them, so they
move the loss's value only), plus T's L1 norm (the reference hands RegLoss
a bare 1-D tensor, whose loop runs over its elements). The L1 term's
gradient at an element that is exactly 0 is 0 here, the true subgradient
(torch's ``abs``); ``jnp.abs`` gives 1 there. T is drawn N(0, 0.01), so an
exact 0 does not arise in training.

``item_bias`` is a 1-D ``pad_zero_params`` table: Adam's zero head there is
its one element at row 0. TransRec defines its own ``full_sort_predict``
(the expanded square) and ``score_items``, so its full sort takes the
trainer's non-fused step, as in the JAX package.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import embedding_init, normal_init
from ..losses import bpr_loss, emb_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("TransRec")
class TransRec(SequentialRecommender):
    # the reference pins Embedding(padding_idx=0) rows; the trainer zeroes
    # row 0 of these tables' gradients to match
    pad_zero_params = ("user_embedding", "item_embedding", "item_bias")
    input_type = InputType.PAIRWISE
    default_config = {"embedding_size": 64, "training_neg_sample_num": 1}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        D, dev = self.embedding_size, self.device
        gen = self.init_generator()
        self.user_embedding = nn.Parameter(embedding_init(gen, self.n_users, D, dev))
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, dev))
        self.T = nn.Parameter(normal_init(gen, (D,), dev, std=0.01))
        self.item_bias = nn.Parameter(torch.zeros(self.n_items, device=dev))

    def _last_item(self, batch):
        seq = batch[self.ITEM_SEQ]
        idx = torch.clamp(batch[self.ITEM_SEQ_LEN] - 1, 0, seq.shape[1] - 1)
        return torch.gather(seq, 1, idx[:, None])[:, 0]

    def _translated(self, batch):
        return (self.item_embedding[self._last_item(batch)]
                + self.user_embedding[batch[self.USER_ID]] + self.T[None, :])

    def _score(self, batch, items):
        d2 = torch.sum((self._translated(batch) - self.item_embedding[items]) ** 2, -1)
        return self.item_bias[items] - torch.sqrt(torch.clamp(d2, min=1e-12))

    def calculate_loss(self, batch, generator=None):
        pos_items = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        loss = bpr_loss(self._score(batch, pos_items),
                        self._score(batch, batch[self.NEG_ITEM_ID]), w)
        with torch.no_grad():
            pos_e = self.item_embedding[pos_items]
            u_e = self.user_embedding[batch[self.USER_ID]]
            b_e = self.item_bias[pos_items][:, None]
            if w is not None:
                pos_e, u_e, b_e = pos_e * w[:, None], u_e * w[:, None], b_e * w[:, None]
            emb = emb_loss(pos_e) + emb_loss(u_e) + emb_loss(b_e)
        return loss + emb + torch.sum(torch.abs(self.T))

    def predict(self, batch):
        return self._score(batch, batch[self.ITEM_ID])

    def score_items(self, batch, items):
        pred = self._translated(batch)                                    # (B, D)
        d2 = torch.sum((pred[:, None, :] - self.item_embedding[items]) ** 2, -1)
        return self.item_bias[items] - torch.sqrt(torch.clamp(d2, min=1e-12))

    def full_sort_predict(self, batch):
        pred = self._translated(batch)
        items = self.item_embedding
        d2 = (torch.sum(pred ** 2, -1, keepdim=True) - 2 * (pred @ items.T)
              + torch.sum(items ** 2, -1)[None, :])
        return self.item_bias[None, :] - torch.sqrt(torch.clamp(d2, min=1e-12))
