"""KSR: knowledge-enhanced sequential recommendation with a key-value memory.

Port of recbole_tpu/models/sequential/ksr.py (parity target: the
reference's KSR, recbole/model/sequential_recommender/ksr.py): a GRU over
the item embeddings (the fp32 instance of the recurrence kernel) through a
dense layer for the sequential preference; beside it a memory of one slot a
relation over the KG embeddings, written at each position by a sigmoid gate
with the tails taken as head + relation, latched at each row's last real
position (a loop over the positions, the JAX package's ``lax.scan``), and
read by a softmax over ``gamma`` x the slots' products with the relation
keys. The two go through ``dense_u``; items are scored against the combined
table ``[item_embedding, entity] @ dense_i_w``. The entity and relation
tables come from ``preload_weight`` ``ent_id`` and ``rel_id`` when the
dataset has them. The relation table never trains (the reference's
relation matrix is a plain tensor): its gradient is cut, so Adam leaves it
as it is; ``freeze_kg`` cuts the entity table's. KSR defines
``full_sort_predict`` itself, so full-sort evaluation takes the trainer's
non-fused step. It runs on a ``KGSeqDataset``.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import GRU, dropout_apply, embedding_init, gru_apply, xavier_normal
from ..losses import bpr_loss, ce_loss
from ...ops.embed_grad import take_rows_dense_grad
from ...utils.enums import InputType
from .. import register_model
from .gru4reckg import preloaded_table


@register_model("KSR")
class KSR(SequentialRecommender):
    pad_zero_params = ("item_embedding", "entity_embedding")
    default_config = {"embedding_size": 64, "hidden_size": 128,
                      "num_layers": 1, "dropout_prob": 0.1,
                      "loss_type": "CE", "freeze_kg": False, "gamma": 10,
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.hidden_size = H = config["hidden_size"]
        self.num_layers = config["num_layers"]
        self.dropout_prob = config["dropout_prob"]
        self.loss_type = config["loss_type"]
        self.freeze_kg = config["freeze_kg"]
        self.gamma = config["gamma"]
        self.n_relations = dataset.relation_num - 1          # without [UI-Relation]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        pre_ent = preloaded_table(dataset, "ent_id", D, self.n_items, "KSR")
        pre_rel = preloaded_table(dataset, "rel_id", D, self.n_relations, "KSR")
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, self.device))
        ent = (embedding_init(gen, self.n_items, D, self.device) if pre_ent is None
               else pre_ent.to(self.device))
        ent[0] = 0.0
        self.entity_embedding = nn.Parameter(ent)
        self.relation_embedding = nn.Parameter(
            xavier_normal(gen, (self.n_relations, D), self.device) if pre_rel is None
            else pre_rel.to(self.device))
        self.gru = GRU(gen, D, H, self.num_layers, self.device)
        self.dense_w = nn.Parameter(xavier_normal(gen, (H, D), self.device))
        self.dense_b = nn.Parameter(torch.zeros(D, device=self.device))
        self.dense_u_w = nn.Parameter(xavier_normal(gen, (2 * D, D), self.device))
        self.dense_u_b = nn.Parameter(torch.zeros(D, device=self.device))
        self.dense_i_w = nn.Parameter(xavier_normal(gen, (2 * D, D), self.device))
        self.dense_i_b = nn.Parameter(torch.zeros(D, device=self.device))

    def _entities(self):
        ent = self.entity_embedding
        return ent.detach() if self.freeze_kg else ent

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        seq_len = batch[self.ITEM_SEQ_LEN]
        B, L = seq.shape
        rel = self.relation_embedding.detach()
        x = self.embed_seq(seq)
        if generator is not None and self.training and self.dropout_prob > 0:
            x = dropout_apply(generator, x, self.dropout_prob)
        h = gru_apply(self.gru, x) @ self.dense_w + self.dense_b
        seq_output = self.gather_last(h, seq_len)                       # (B, D)

        # the memory write: tails = head + relation, a gated update a
        # position, the memory latched at each row's last real position
        ent = self._entities()
        heads = ent[seq] if self.freeze_kg else take_rows_dense_grad(ent.shape[0], ent, seq)
        last_pos = torch.clamp(seq_len - 1, 0, L - 1)
        memory = torch.zeros((B, self.n_relations, self.embedding_size), device=seq.device)
        latched = memory
        for t in range(L):
            update = heads[:, t, None, :] + rel[None, :, :]               # (B, R, D)
            z = torch.sigmoid(torch.sum(memory * update, -1))[..., None]
            memory = (1.0 - z) * memory + z * update
            latched = torch.where((last_pos == t)[:, None, None], memory, latched)

        # the memory read: attention against the relation keys
        att = torch.softmax(self.gamma * torch.sum(latched * rel[None, :, :], -1), dim=-1)
        u_m = torch.sum(latched * att[..., None], 1)                     # (B, D)
        return torch.cat([seq_output, u_m], -1) @ self.dense_u_w + self.dense_u_b

    def _item_table(self):
        """The combined item table [item_embedding, entity] @ dense_i_w."""
        both = torch.cat([self.item_embedding, self._entities()], -1)
        return both @ self.dense_i_w + self.dense_i_b

    def calculate_loss(self, batch, generator=None):
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        table = self._item_table()
        if self.loss_type == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            return bpr_loss(torch.sum(out * table[pos], -1), torch.sum(out * table[neg], -1), w)
        return ce_loss(out @ table.T, pos, w)

    def full_sort_predict(self, batch):
        return self.forward(batch) @ self._item_table().T
