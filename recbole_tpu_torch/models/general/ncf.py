"""NCF: neural collaborative filtering, GMF and MLP towers (fork model).

Port of recbole_tpu/models/general/ncf.py (parity target: fork NCF,
recbole/model/general_recommender/ncf.py:10-100): an MLP tower halving its
width each layer over the concatenated MLP embeddings, a GMF tower, and an
affine output over both, sigmoid + BCE. The fork looks its
``gmf_item_embedding`` up with the USER ids (ncf.py:57); the JAX package
keeps that by default and so does the port (``ncf_fix_gmf_item_lookup: True``
looks up the items). Where there are more users than items (ml-1m), a user
id past the item table reads its last row and sends that row no gradient,
as the JAX package's gather clamps an out-of-range index and its gradient's
scatter drops it (the fork's torch lookup raises there). It has ``predict``
only: full sort takes the trainer's chunked ``score_items``.
"""

import torch
from torch import nn

from ..base import GeneralRecommender
from ..layers import MLPLayers, normal_init, xavier_uniform
from ..losses import bce_loss
from ...utils.enums import InputType
from .. import register_model


@register_model("NCF")
class NCF(GeneralRecommender):
    input_type = InputType.POINTWISE
    default_config = {"mlp_embedding_dimension": 128,
                      "gmf_embedding_dimension": 128,
                      "weight_decay": 1e-8, "mlp_n_layers": 3,
                      "valid_metric": "Hit@10",
                      "ncf_fix_gmf_item_lookup": False}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.gmf_dim = G = config["gmf_embedding_dimension"]
        self.mlp_dim = M = config["mlp_embedding_dimension"]
        self.n_layers = config["mlp_n_layers"]
        self.fix_gmf_item_lookup = bool(config["ncf_fix_gmf_item_lookup"])
        dims = [M * 2]
        for _ in range(self.n_layers):
            dims.append(dims[-1] // 2)
        gen = self.init_generator()
        dev = self.device
        self.mlp_user_embedding = nn.Parameter(normal_init(gen, (self.n_users, M), dev))
        self.mlp_item_embedding = nn.Parameter(normal_init(gen, (self.n_items, M), dev))
        self.gmf_user_embedding = nn.Parameter(normal_init(gen, (self.n_users, G), dev))
        self.gmf_item_embedding = nn.Parameter(normal_init(gen, (self.n_items, G), dev))
        self.mlp = MLPLayers(gen, dims, dev, act="relu", init=xavier_uniform)
        self.out_w = nn.Parameter(xavier_uniform(gen, (dims[-1] + G, 1), dev))
        self.out_b = nn.Parameter(torch.zeros(1, device=dev))

    def _logits(self, user, item):
        x = self.mlp(torch.cat([self.mlp_user_embedding[user],
                                self.mlp_item_embedding[item]], -1))
        gu = self.gmf_user_embedding[user]
        if self.fix_gmf_item_lookup:
            gi = self.gmf_item_embedding[item]
        else:
            gi = self.gmf_item_embedding[torch.clamp(user, max=self.n_items - 1)]
            gi = torch.where((user < self.n_items)[:, None], gi, gi.detach())
        return (torch.cat([x, gu * gi], -1) @ self.out_w)[:, 0] + self.out_b[0]

    def calculate_loss(self, batch, generator=None):
        logits = self._logits(batch[self.USER_ID], batch[self.ITEM_ID])
        return bce_loss(logits, batch[self.LABEL], batch.get("_weight"))

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch[self.USER_ID], batch[self.ITEM_ID]))
