"""Item-feature embedding for the feature-rich sequential models.

Port of recbole_tpu/models/sequential/feat_embed.py (parity target: the
reference's ContextSeqEmbLayer / FeatureSeqEmbLayer,
recbole/model/layers.py:554-826, used by SASRecF, FDSA, GRU4RecF, DIN and
DIEN): per-field embeddings of an item's (or, with ``side="user"``, a
user's) side features, token fields looked up, token_seq fields pooled
(mean, max or sum), float fields scaling a one-row table.

The aligned feature table (row i = item id i) lives on the device as
non-persistent buffers built from the dataset, so embedding a batch of ids
is one gather a field. The embedding tables themselves are the reference's
frozen N(0, 1) tables: it keeps them in plain dicts, out of the optimizer
and out of ``state_dict`` (layers.py:566-611); the JAX package keeps them
under ``params["_const"]`` (:79-111). Here they are persistent buffers,
``feat_<field>``: random state that the checkpoint carries and that no
optimizer sees. ``convert.py`` maps them to and from the JAX tree's
``_const`` (``const_state_map``). DIN's and DIEN's id table is one of them
too (``frozen_id``: the reference keeps it in the same unregistered layer),
``item_embedding`` or, on the user side, ``user_embedding``.
"""

import numpy as np
import torch
from torch import nn

from ...ops.embed_grad import take_rows_dense_grad
from ...utils.enums import FeatureType


class ItemFeatEmbedder(nn.Module):
    """Embeds item ids (user ids with ``side="user"``, DIEN's user stream,
    JAX :30-42) into per-field feature vectors: (..., F, D).

    Field 0 is the id itself when ``include_item_id``: from the caller's
    trainable table, or from the frozen one that ``init_tables(...,
    frozen_id=True)`` draws (DIN's and DIEN's); the others follow
    ``selected_features`` order when given (the reference's field_names
    iteration, layers.py:576-587), else the dataset's feature order."""

    def __init__(self, dataset, selected_features=None, pooling="mean", include_item_id=True,
                 device="cpu", side="item"):
        super().__init__()
        self.pooling = pooling
        self.include_item_id = include_item_id
        if side == "item":
            feat, key_field, self.n_rows = dataset.item_feat or {}, dataset.iid_field, \
                dataset.item_num
        else:
            feat, key_field, self.n_rows = dataset.user_feat or {}, dataset.uid_field, \
                dataset.user_num
        self.id_key = f"{side}_embedding"
        self.frozen_id = False
        self.device_ = torch.device(device)
        if selected_features is not None:
            names = [f for f in selected_features if f in feat]
        else:
            names = [f for f in feat if f != key_field]
        # (field, vocab) of each kind, in walk order; the aligned columns
        # are non-persistent buffers
        self.token_fields, self.float_fields, self.seq_fields = [], [], []
        for field in names:
            if field == key_field:
                continue
            col = feat[field]
            ftype = dataset.field2type[field]
            if ftype is FeatureType.TOKEN:
                self.token_fields.append((field, dataset.num(field)))
                self._col(f"ids_{field}", np.asarray(col, np.int64))
            elif ftype is FeatureType.FLOAT:
                self.float_fields.append(field)
                self._col(f"vals_{field}", np.asarray(col, np.float32))
            elif ftype is FeatureType.TOKEN_SEQ:
                lens = np.array([len(s) for s in col], np.int64)
                L = max(int(lens.max()) if len(lens) else 1, 1)
                padded = np.zeros((len(col), L), np.int64)
                for r, s in enumerate(col):
                    padded[r, :len(s)] = s
                self.seq_fields.append((field, dataset.num(field)))
                self._col(f"seq_{field}", padded)
                self._col(f"len_{field}", lens)

    def _col(self, name, array):
        self.register_buffer(name, torch.as_tensor(array, device=self.device_),
                             persistent=False)

    @property
    def num_fields(self):
        """Feature fields (+1 for the item-id field when included)."""
        return ((1 if self.include_item_id else 0) + len(self.token_fields)
                + len(self.float_fields) + len(self.seq_fields))

    def table_names(self):
        """The frozen tables' names, in the JAX init's draw order: the id
        table when frozen, then ``feat_<field>`` of the token, float and
        token_seq fields."""
        return (([self.id_key] if self.frozen_id else [])
                + [f"feat_{f}" for f, _ in self.token_fields]
                + [f"feat_{f}" for f in self.float_fields]
                + [f"feat_{f}" for f, _ in self.seq_fields])

    def init_tables(self, generator, emb_size, frozen_id=False):
        """N(0, 1) frozen tables as persistent buffers (parity: init,
        :79-111): with ``frozen_id`` (DIN, DIEN) the id table (n_rows, D)
        first, then a token or token_seq field's (vocab, D), a float
        field's (1, D). SASRecF and FDSA train their own id table and pass
        ``frozen_id=False``, as they pass ``frozen_item_id=False``."""
        def normal(shape):
            return torch.randn(shape, generator=generator, device=self.device_)

        if self.include_item_id and frozen_id:
            self.frozen_id = True
            self.register_buffer(self.id_key, normal((self.n_rows, emb_size)))
        for field, vocab in self.token_fields:
            self.register_buffer(f"feat_{field}", normal((vocab, emb_size)))
        for field in self.float_fields:
            self.register_buffer(f"feat_{field}", normal((1, emb_size)))
        for field, vocab in self.seq_fields:
            self.register_buffer(f"feat_{field}", normal((vocab, emb_size)))

    def embed(self, items, id_table=None):
        """items: int tensor of any shape -> (*items.shape, F, D). Field
        order: the id (with ``include_item_id``: from ``id_table``, the
        caller's trainable table, or, when it is None, the frozen one),
        token fields, token_seq fields, then float fields (the reference's
        [sparse, dense] concatenation, layers.py:755-766)."""
        parts = []
        if self.include_item_id and id_table is None:
            parts.append(getattr(self, self.id_key)[items][..., None, :])
        elif self.include_item_id:
            # the lookup's gradient through the embedding-gradient kernels, as
            # the sequential base's embed_seq takes it (the library's
            # sort-based index backward was half of SASRecF's step on the card)
            parts.append(take_rows_dense_grad(id_table.shape[0], id_table, items)[..., None, :])
        for field, _ in self.token_fields:
            parts.append(getattr(self, f"feat_{field}")[getattr(self, f"ids_{field}")[items]]
                         [..., None, :])
        for field, _ in self.seq_fields:
            padded = getattr(self, f"seq_{field}")
            member = getattr(self, f"feat_{field}")[padded[items]]      # (..., L, D)
            ln = getattr(self, f"len_{field}")[items]
            valid = (torch.arange(padded.shape[1], device=items.device)
                     < ln[..., None]).to(torch.float32)[..., None]
            if self.pooling == "max":
                # emb - (1 - mask) 1e9 (layers.py:683-688), not a hard mask
                pooled = torch.max(member - (1.0 - valid) * 1e9, dim=-2).values
            elif self.pooling == "sum":
                pooled = torch.sum(member * valid, dim=-2)
            else:
                pooled = (torch.sum(member * valid, dim=-2)
                          / (ln[..., None].to(torch.float32) + 1e-8))
            parts.append(pooled[..., None, :])
        for field in self.float_fields:
            parts.append((getattr(self, f"feat_{field}")[0]
                          * getattr(self, f"vals_{field}")[items][..., None])[..., None, :])
        return torch.cat(parts, dim=-2)

    def embed_flat(self, items, id_table=None):
        """(*items.shape, F*D): the fields concatenated."""
        e = self.embed(items, id_table)
        return e.reshape(e.shape[:-2] + (-1,))
