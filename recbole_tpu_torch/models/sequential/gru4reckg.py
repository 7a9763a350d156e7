"""GRU4RecKG: GRU4Rec with a parallel recurrent encoder over KG entities.

Port of recbole_tpu/models/sequential/gru4reckg.py (parity target: the
reference's GRU4RecKG, recbole/model/sequential_recommender/gru4reckg.py):
two GRUs over the item sequence, one on the learned item embeddings, one on
the entity embeddings of the same items (``preload_weight`` ``ent_id``, its
first n_items rows, when the dataset has it; else a random table, with a
warning), their outputs concatenated through a dense layer. ``freeze_kg``
keeps the entity table out of the gradient. Both GRUs run the fp32 instance
of the recurrence kernel; the model inherits the sequential base's scoring,
so full-sort evaluation takes the fused masked top-k. It runs on a
``KGSeqDataset``.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import GRU, dropout_apply, embedding_init, gru_apply, xavier_normal
from ...ops.embed_grad import take_rows_dense_grad
from ...utils.enums import InputType
from ...utils.logger import get_logger
from .. import register_model


def preloaded_table(dataset, field, dim, rows, model_name):
    """The first ``rows`` rows of the dataset's preloaded ``field`` matrix,
    padded with zero rows to ``rows`` (parity: JAX gru4reckg.py:43-67,
    ksr.py:46-57 and :63-73); None, with a warning, when the dataset has
    none. A width other than ``dim`` raises."""
    try:
        w = dataset.get_preload_weight(field)
    except ValueError:
        get_logger().warning("%s: no preloaded %s weights (preload_weight %s); "
                             "initializing randomly", model_name, field, field)
        return None
    if w.shape[1] != dim:
        raise ValueError(f"preloaded {field} dim {w.shape[1]} != embedding_size {dim}")
    table = torch.zeros((rows, dim), dtype=torch.float32)
    n = min(rows, w.shape[0])
    table[:n] = torch.as_tensor(w[:n], dtype=torch.float32)
    return table


@register_model("GRU4RecKG")
class GRU4RecKG(SequentialRecommender):
    pad_zero_params = ("item_embedding", "entity_embedding")
    default_config = {"embedding_size": 64, "hidden_size": 128,
                      "num_layers": 1, "dropout_prob": 0.1,
                      "freeze_kg": True, "loss_type": "CE",
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = D = config["embedding_size"]
        self.hidden_size = H = config["hidden_size"]
        self.num_layers = config["num_layers"]
        self.dropout_prob = config["dropout_prob"]
        self.freeze_kg = config["freeze_kg"]
        self.loss_type = config["loss_type"]
        self.input_type = (InputType.PAIRWISE if self.loss_type == "BPR"
                           else InputType.POINTWISE)
        pre = preloaded_table(dataset, "ent_id", D, self.n_items, "GRU4RecKG")
        gen = self.init_generator()
        self.item_embedding = nn.Parameter(embedding_init(gen, self.n_items, D, self.device))
        ent = (embedding_init(gen, self.n_items, D, self.device) if pre is None
               else pre.to(self.device))
        ent[0] = 0.0
        self.entity_embedding = nn.Parameter(ent)
        self.item_gru = GRU(gen, D, H, self.num_layers, self.device)
        self.entity_gru = GRU(gen, D, H, self.num_layers, self.device)
        self.dense_w = nn.Parameter(xavier_normal(gen, (2 * H, D), self.device))
        self.dense_b = nn.Parameter(torch.zeros(D, device=self.device))

    def forward(self, batch, generator=None):
        seq = batch[self.ITEM_SEQ]
        x = self.embed_seq(seq)
        ent = self.entity_embedding
        e = ent.detach()[seq] if self.freeze_kg else take_rows_dense_grad(ent.shape[0], ent, seq)
        if generator is not None and self.training and self.dropout_prob > 0:
            x = dropout_apply(generator, x, self.dropout_prob)
            e = dropout_apply(generator, e, self.dropout_prob)
        out = torch.cat([gru_apply(self.item_gru, x), gru_apply(self.entity_gru, e)], -1)
        return self.gather_last(out @ self.dense_w + self.dense_b, batch[self.ITEM_SEQ_LEN])
