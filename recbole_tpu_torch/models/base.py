"""Model base classes as torch ``nn.Module``s.

Port of recbole_tpu/models/base.py's ``AbstractRecommender`` and
``GeneralRecommender``. The contract keeps its names (calculate_loss /
predict / full_sort_predict / full_sort_query), but a model now owns its
parameters, created on ``config["device"]`` from a torch.Generator seeded
with ``config["seed"]``. The JAX package's ``ConstRef``/``bind_consts``
machinery keeps device constants out of jit literals; eager PyTorch has no
such literals, so it is left out.

Batch convention: a dict of tensors keyed by field name. The trainer adds
``neg_<iid>`` columns for pairwise models.
"""

import torch
from torch import nn

from ..utils.enums import ModelType, InputType


class AbstractRecommender(nn.Module):
    # the model family, read by Config from the class (shadows nn.Module.type,
    # the dtype cast, which the port never calls)
    type = ModelType.GENERAL
    input_type = InputType.POINTWISE
    default_config: dict = {}

    def __init__(self, config, dataset):
        super().__init__()
        self.config = config
        self.device = torch.device(config["device"])

    def init_generator(self):
        """A fresh generator on the model's device, seeded from the config."""
        return torch.Generator(device=self.device).manual_seed(
            int(self.config["seed"] or 0))

    def calculate_loss(self, batch, generator=None):
        """Scalar training loss. ``generator`` is the trainer's
        torch.Generator, for models that draw dropout masks."""
        raise NotImplementedError

    def predict(self, batch):
        """(B,) score of each (user, item) row."""
        raise NotImplementedError

    def full_sort_predict(self, batch):
        """(B, n_items) scores of every item for each row's user."""
        raise NotImplementedError

    def __str__(self):
        return self.__class__.__name__


class GeneralRecommender(AbstractRecommender):
    type = ModelType.GENERAL

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.USER_ID = config["USER_ID_FIELD"]
        self.ITEM_ID = config["ITEM_ID_FIELD"]
        self.NEG_ITEM_ID = config["NEG_PREFIX"] + self.ITEM_ID
        self.LABEL = config["LABEL_FIELD"]
        self.n_users = dataset.user_num
        self.n_items = dataset.item_num
