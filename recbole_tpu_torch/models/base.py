"""Model base classes as torch ``nn.Module``s.

Port of recbole_tpu/models/base.py's ``AbstractRecommender``,
``GeneralRecommender``, ``SequentialRecommender`` and
``KnowledgeRecommender``. The contract keeps its names (calculate_loss /
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

    # names of parameters whose row 0 is a [PAD] entry (the reference's
    # Embedding(padding_idx=0)): zero at init, and the trainer zeroes row 0 of
    # their gradient so that it never trains
    pad_zero_params: tuple = ()

    # what compute_dtype: "auto" means for the family: float32 here, bfloat16
    # for the sequential towers. An explicit config value always wins. (The
    # JAX package resolves "auto" to float32 off the TPU; the port resolves
    # it the same way on every device.)
    _auto_compute_dtype = "float32"

    def __init__(self, config, dataset):
        super().__init__()
        self.config = config
        self.device = torch.device(config["device"])
        dtype = str(config["compute_dtype"] or "auto").lower()
        if dtype == "auto":
            dtype = self._auto_compute_dtype
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {dtype!r}: the port has float32 and bfloat16")
        self.compute_dtype = getattr(torch, dtype)
        # None when float32, so that layers skip the cast (layers.dot_c)
        self.cdt = None if dtype == "float32" else self.compute_dtype

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

    def score_items(self, batch, items):
        """(B, C) scores of candidate ``items`` (B, C) for each row (parity:
        base.py:183-206, without the pair blocks of models not ported yet):
        the batch repeated C times with the candidates as its item column,
        through ``predict``. Models with one query vector dotted with the
        item table, or with per-user state shared by all candidates
        (RippleNet), override it."""
        B, C = items.shape
        flat = {k: (v if v.dim() == 0 else v.repeat_interleave(C, dim=0))
                for k, v in batch.items()}
        flat[self.config["ITEM_ID_FIELD"]] = items.reshape(-1)
        return self.predict(flat).reshape(B, C)

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


class SequentialRecommender(AbstractRecommender):
    """parity: SequentialRecommender (base.py:252-338). The transformer
    towers compute in bfloat16 by default (float32 sums everywhere;
    embeddings, LayerNorms and losses stay float32); ``compute_dtype:
    float32`` opts out."""

    type = ModelType.SEQUENTIAL
    _auto_compute_dtype = "bfloat16"
    item_embedding_key = "item_embedding"

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.USER_ID = config["USER_ID_FIELD"]
        self.ITEM_ID = config["ITEM_ID_FIELD"]
        self.ITEM_SEQ = self.ITEM_ID + config["LIST_SUFFIX"]
        self.ITEM_SEQ_LEN = config["ITEM_LIST_LENGTH_FIELD"]
        self.POS_ITEM_ID = self.ITEM_ID
        self.NEG_ITEM_ID = config["NEG_PREFIX"] + self.ITEM_ID
        self.max_seq_length = config["MAX_ITEM_LIST_LENGTH"]
        self.n_items = dataset.item_num
        self.n_users = dataset.user_num

    @staticmethod
    def gather_last(seq_output, seq_len):
        """Hidden state at the last real position of each sequence (parity:
        gather_indexes, abstract_recommender.py:117-121)."""
        idx = torch.clamp(seq_len - 1, 0, seq_output.shape[1] - 1)
        return seq_output[torch.arange(seq_output.shape[0], device=seq_output.device), idx]

    def embed_seq(self, ids, key="item_embedding"):
        """Input-sequence embedding lookup ``table[ids]`` whose backward is
        the dense (V, D) accumulation of ops/embed_grad.py, on every device
        (the JAX package switches to a plain gather off the TPU)."""
        from ..ops.embed_grad import take_rows_dense_grad
        table = getattr(self, key)
        return take_rows_dense_grad(table.shape[0], table, ids)

    # default scoring for models that expose forward() -> (B, D) and score
    # items by a dot product with the item table

    def forward(self, batch, generator=None):
        raise NotImplementedError

    def _item_table(self):
        return getattr(self, self.item_embedding_key)

    def calculate_loss(self, batch, generator=None):
        from .losses import bpr_loss, ce_loss
        out = self.forward(batch, generator)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        table = self._item_table()
        if getattr(self, "loss_type", "CE") == "BPR":
            neg = batch[self.NEG_ITEM_ID]
            return bpr_loss(torch.sum(out * table[pos], -1),
                            torch.sum(out * table[neg], -1), w)
        return ce_loss(out @ table.T, pos, w)

    def predict(self, batch):
        out = self.forward(batch)
        return torch.sum(out * self._item_table()[batch[self.ITEM_ID]], -1)

    def score_items(self, batch, items):
        out = self.forward(batch)
        return torch.einsum("bd,bcd->bc", out, self._item_table()[items])

    def full_sort_predict(self, batch):
        return self.forward(batch) @ self._item_table().T

    def full_sort_query(self, batch):
        """(query (B, D), item table (N, D)) for the fused masked top-k."""
        return self.forward(batch), self._item_table()


class KnowledgeRecommender(AbstractRecommender):
    """parity: KnowledgeRecommender (base.py:341-358): the rec fields, the KG
    fields, and the entity and relation vocabularies of a
    KnowledgeBasedDataset. float32 by default, as the rest of the port off
    the sequential family."""

    type = ModelType.KNOWLEDGE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.USER_ID = config["USER_ID_FIELD"]
        self.ITEM_ID = config["ITEM_ID_FIELD"]
        self.NEG_ITEM_ID = config["NEG_PREFIX"] + self.ITEM_ID
        self.LABEL = config["LABEL_FIELD"]
        self.ENTITY_ID = config["ENTITY_ID_FIELD"]
        self.RELATION_ID = config["RELATION_ID_FIELD"]
        self.HEAD_ENTITY_ID = config["HEAD_ENTITY_ID_FIELD"]
        self.TAIL_ENTITY_ID = config["TAIL_ENTITY_ID_FIELD"]
        self.NEG_TAIL_ENTITY_ID = config["NEG_PREFIX"] + self.TAIL_ENTITY_ID
        self.n_users = dataset.user_num
        self.n_items = dataset.item_num
        self.n_entities = dataset.entity_num
        self.n_relations = dataset.relation_num
