"""ContextRecommender: the CTR field-embedding machine.

Port of recbole_tpu/models/context/context_base.py (parity target:
reference ContextRecommender, recbole/model/abstract_recommender.py:151-412,
with FMEmbedding/FMFirstOrderLinear, layers.py:121, 905). All loaded fields
but the label become model inputs: token fields share ONE embedding table
through per-field offsets, float fields get a per-field embedding scaled by
the value, token_seq fields mean-pool their members' embeddings; a parallel
first-order linear term sums per-token biases and float weights.

As in the JAX package, user and item side features are not joined into the
batches on the host: the aligned side tables live on the model's device
(as buffers) and the forward gathers them by user or item id, so batches
stay (B,)-shaped whatever the feature count.

The token table is MERGED storage, (V, D+1): columns 0..D-1 are the
embedding and column D the first-order bias, so both terms ride one gather.
That gather always goes through ``ops.embed_grad.GroupedTakeRows``, whose
backward builds the dense gradient with the hand-written kernels; the JAX
package picks that route on the TPU and a plain gather elsewhere
(:196-198), and its three environment switches are not ported. The mesh
padding (:67-76) and ``sharded_take_rows`` (:205-213) belong to the
parallel package (ROADMAP Queue 1, item 11); ``mesh_shape`` raises in the
port's Config.
"""

import numpy as np
import torch
from torch import nn

from ..base import AbstractRecommender
from ..layers import xavier_normal
from ...ops.embed_grad import grouped_take_rows
from ...utils.enums import ModelType, InputType, FeatureType, FeatureSource


class ContextRecommender(AbstractRecommender):
    type = ModelType.CONTEXT
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.USER_ID = config["USER_ID_FIELD"]
        self.ITEM_ID = config["ITEM_ID_FIELD"]
        self.LABEL = config["LABEL_FIELD"]
        self.embedding_size = config["embedding_size"]
        self.n_users = dataset.user_num
        self.n_items = dataset.item_num

        # enumerate usable fields in schema order
        self.token_fields = []      # (field, vocab, fetch)
        self.float_fields = []      # (field, fetch)
        self.token_seq_fields = []  # (field, vocab, fetch)
        # only LABEL is excluded: the reference treats every other loaded
        # field (including a raw timestamp) as a feature
        # (abstract_recommender.py:207-219)
        available = self._available_fields(dataset)
        for field, ftype in dataset.field2type.items():
            if field == self.LABEL or field not in available:
                continue
            fetch = self._make_fetch(dataset, field, dataset.field2source[field])
            if fetch is None:
                continue
            if ftype is FeatureType.TOKEN:
                self.token_fields.append((field, dataset.num(field), fetch))
            elif ftype is FeatureType.FLOAT:
                self.float_fields.append((field, fetch))
            elif ftype is FeatureType.TOKEN_SEQ:
                self.token_seq_fields.append((field, dataset.num(field), fetch))

        # unified token vocabulary offsets (parity: FMEmbedding offset trick)
        self.token_offsets = []
        total = 0
        for _, vocab, _ in self.token_fields:
            self.token_offsets.append(total)
            total += vocab
        self.token_vocab_total = total
        self.register_buffer(
            "_token_offsets", torch.tensor(self.token_offsets, dtype=torch.int64,
                                           device=self.device), persistent=False)

        self.seq_offsets = []
        seq_total = 0
        for _, vocab, _ in self.token_seq_fields:
            self.seq_offsets.append(seq_total)
            seq_total += vocab
        self.seq_vocab_total = seq_total

        self.num_fields = (len(self.token_fields) + len(self.float_fields)
                           + len(self.token_seq_fields))
        # (offset, vocab) per token field, for the field-grouped backward
        self._field_spec = tuple(
            (off, vocab) for (_, vocab, _), off
            in zip(self.token_fields, self.token_offsets))

    def _available_fields(self, dataset):
        fields = set(dataset.inter_feat.keys())
        if dataset.user_feat is not None:
            fields |= set(dataset.user_feat.keys())
        if dataset.item_feat is not None:
            fields |= set(dataset.item_feat.keys())
        return fields

    def _side_table(self, field, array):
        name = f"_side_{len(self._buffers)}"
        self.register_buffer(name, torch.as_tensor(array, device=self.device),
                             persistent=False)
        return name

    def _make_fetch(self, dataset, field, src):
        """Build a device fetch: batch -> (B,) value (token/float) or
        (B, L) ids + (B,) lens (token_seq)."""
        ftype = dataset.field2type[field]
        if src in (FeatureSource.INTERACTION, FeatureSource.USER_ID,
                   FeatureSource.ITEM_ID):
            if ftype is FeatureType.TOKEN_SEQ:
                return None  # seq fields in .inter not yet supported
            return lambda batch, f=field: batch[f]

        if src is FeatureSource.USER:
            table = dataset.user_feat
            key = self.USER_ID
        elif src is FeatureSource.ITEM:
            table = dataset.item_feat
            key = self.ITEM_ID
        else:
            return None
        col = table[field]
        if ftype is FeatureType.TOKEN_SEQ:
            lens = np.array([len(s) for s in col], np.int64)
            L = max(int(lens.max()), 1)
            padded = np.zeros((len(col), L), np.int64)
            for r, s in enumerate(col):
                padded[r, :len(s)] = s
            npad = self._side_table(field, padded)
            nlen = self._side_table(field, lens)
            return lambda batch, k=key: (getattr(self, npad)[batch[k]],
                                         getattr(self, nlen)[batch[k]])
        ncol = self._side_table(field, col.astype(
            np.float32 if ftype is FeatureType.FLOAT else np.int64))
        return lambda batch, k=key: getattr(self, ncol)[batch[k]]

    # ---------------------------------------------------------------- params

    def init_context_params(self, generator):
        """Create the family's shared parameters, under the JAX param
        dict's names."""
        D = self.embedding_size
        if self.token_vocab_total:
            # the xavier fan of the embedding part is computed on (V, D);
            # the bias column starts at zero
            emb = xavier_normal(generator, (self.token_vocab_total, D), self.device)
            self.token_embedding = nn.Parameter(torch.cat(
                [emb, torch.zeros((self.token_vocab_total, 1), device=self.device)],
                dim=1))
        if self.float_fields:
            self.float_embedding = nn.Parameter(xavier_normal(
                generator, (len(self.float_fields), D), self.device))
            self.float_weight = nn.Parameter(
                torch.zeros(len(self.float_fields), device=self.device))
        if self.seq_vocab_total:
            self.seq_embedding = nn.Parameter(xavier_normal(
                generator, (self.seq_vocab_total, D), self.device))
            self.seq_bias = nn.Parameter(
                torch.zeros(self.seq_vocab_total, device=self.device))
        self.first_order_bias = nn.Parameter(torch.zeros((), device=self.device))

    # --------------------------------------------------------------- forward

    def _token_ids(self, batch):
        """(B, F) offset token ids across every token field, for ONE batched
        lookup instead of F separate gathers."""
        ids = torch.stack([fetch(batch) for _, _, fetch in self.token_fields], dim=1)
        return ids + self._token_offsets[None, :]

    def _lookup(self, table, ids):
        """(B, F) global-offset ids -> (B, F, D) rows of ``table``, with the
        field-grouped dense backward."""
        return grouped_take_rows(self._field_spec, table, ids)

    def _token_rows(self, batch):
        """(B, F, D+1) rows of the merged token table (embedding cols
        0..D-1, first-order bias col D): ONE gather serves both terms."""
        return self._lookup(self.token_embedding, self._token_ids(batch))

    def _float_values(self, batch):
        """(B, n_float) float32 values of the float fields."""
        return torch.stack([fetch(batch) for _, fetch in self.float_fields],
                           dim=1).to(torch.float32)

    def _seq_terms(self, batch):
        """Per token_seq field: (mean-pooled embedding (B, D), bias sum (B,))."""
        out = []
        for (_, _, fetch), off in zip(self.token_seq_fields, self.seq_offsets):
            ids, lens = fetch(batch)
            emb = self.seq_embedding[ids + off]                   # (B, L, D)
            valid = (torch.arange(ids.shape[1], device=ids.device)[None, :]
                     < lens[:, None]).to(torch.float32)
            pooled = torch.sum(emb * valid[:, :, None], dim=1) \
                / torch.clamp(lens[:, None], min=1)
            out.append((pooled, torch.sum(self.seq_bias[ids + off] * valid, dim=1)))
        return out

    def embed_input(self, batch):
        """(B, num_fields, D) second-order embeddings."""
        parts = []
        if self.token_fields:
            parts.append(self._token_rows(batch)[..., :-1])
        if self.float_fields:
            parts.append(self.float_embedding[None, :, :]
                         * self._float_values(batch)[:, :, None])
        parts.extend(pooled[:, None, :] for pooled, _ in self._seq_terms(batch))
        return torch.cat(parts, dim=1)

    def embed_and_first_order(self, batch):
        """Fused (emb, linear) = (embed_input, first_order) for models that
        need both: with the merged (V, D+1) table both terms ride one
        gather."""
        if not self.token_fields:
            return self.embed_input(batch), self.first_order(batch)
        rows = self._token_rows(batch)                            # (B, F, D+1)
        parts = [rows[..., :-1]]
        linear = torch.sum(rows[..., -1], dim=1) + self.first_order_bias
        if self.float_fields:
            vals = self._float_values(batch)
            parts.append(self.float_embedding[None, :, :] * vals[:, :, None])
            linear = linear + vals @ self.float_weight
        for pooled, bias in self._seq_terms(batch):
            parts.append(pooled[:, None, :])
            linear = linear + bias
        return torch.cat(parts, dim=1), linear

    def batch_len(self, batch):
        """Batch size from any (B,)-leading column: pure-feature datasets
        (USER_ID_FIELD: ~) have no id column to anchor on."""
        if self.USER_ID in batch:
            return batch[self.USER_ID].shape[0]
        for v in batch.values():
            if hasattr(v, "dim") and v.dim() >= 1:
                return v.shape[0]
        raise ValueError("cannot infer batch size from an empty batch")

    def first_order(self, batch):
        """(B,) linear term (parity: FMFirstOrderLinear, layers.py:905)."""
        total = torch.zeros(self.batch_len(batch), device=self.device) \
            + self.first_order_bias
        if self.token_fields:
            # standalone first_order (LR and friends): gather from the
            # sliced bias column, a (V, 1) strided view of the merged table,
            # not full (D+1)-wide rows. Autograd lands the column's dense
            # gradient in column D of the table's gradient.
            col = self.token_embedding[:, -1:]                    # (V, 1)
            total = total + torch.sum(
                self._lookup(col, self._token_ids(batch))[..., 0], dim=1)
        if self.float_fields:
            total = total + self._float_values(batch) @ self.float_weight
        for _, bias in self._seq_terms(batch):
            total = total + bias
        return total
