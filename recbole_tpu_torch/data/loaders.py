"""Batch pipelines.

Port of recbole_tpu/data/loaders.py: ``TrainLoader`` (:17),
``ArrayTrainLoader`` (:63), ``SeqTransform`` (:103), ``SequentialTrainLoader``
(:152), ``SequentialEvalLoader`` (:193), ``SequentialSampledEvalLoader``
(:255), ``RowEvalLoader`` (:271), ``FullSortEvalLoader`` (:345),
``DatasetNegEvalLoader`` (:415) and ``SampledEvalLoader`` (:499). A train
loader only holds the columnar training table: the trainer uploads it to the
device once and slices shuffled batches there, the eager counterpart of the
JAX trainer's scanned epoch (trainer.py:503-509). Negatives, of training and
of the sampled eval protocols, are drawn on the device by the trainer.
``UserTrainLoader`` (:306) comes with the MultiVAE family (ROADMAP Queue 1,
item 10).
"""

import numpy as np
import torch


class TrainLoader:
    """The training split as columnar numpy arrays, in batches of
    ``batch_size`` shuffled rows (the last batch may be shorter)."""

    def __init__(self, config, dataset, batch_size=None, shuffle=True):
        self.config = config
        self.dataset = dataset
        self.batch_size = batch_size or config["train_batch_size"]
        self.shuffle = shuffle
        self.fields = {f: np.asarray(v) for f, v in dataset.inter_feat.items()
                       if v.dtype != object}
        self.n = len(dataset)

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def columns(self):
        """Full training table as columnar numpy arrays."""
        return dict(self.fields)


class ArrayTrainLoader:
    """Train loader over an explicit columnar table (shared machinery for
    the sequential and KG streams). ``device_transform`` shapes a batch on
    the device inside the step."""

    def __init__(self, config, columns, batch_size=None, shuffle=True,
                 device_transform=None):
        self.config = config
        self.batch_size = batch_size or config["train_batch_size"]
        self.shuffle = shuffle
        self._columns = columns
        self.device_transform = device_transform
        self.n = len(next(iter(columns.values())))

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def columns(self):
        return dict(self._columns)


class SeqTransform:
    """Padded-sequence materialisation from the global item stream, on the
    device: one gather inside the step replaces the reference's per-row
    Python ``augmentation`` loop (sequential_dataloader.py:115-146). The
    stream is uploaded once per device (``consts``) and handed to the call
    by the trainer."""

    def __init__(self, item_stream, max_len, seq_field, len_field):
        self.item_stream = np.asarray(item_stream)
        self.max_len = max_len
        self.seq_field = seq_field
        self.len_field = len_field
        self._consts = {}

    def consts(self, device):
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = {"item_stream": torch.as_tensor(
                self.item_stream, dtype=torch.int64, device=device)}
        return self._consts[device]

    def __call__(self, batch, consts):
        if self.seq_field in batch:
            # sequences already materialised (SequentialTrainLoader.columns)
            return {k: v for k, v in batch.items() if k != "seq_start"}
        stream = consts["item_stream"]
        offs = torch.arange(self.max_len, device=stream.device)
        idx = batch["seq_start"][:, None] + offs[None, :]
        valid = offs[None, :] < batch[self.len_field][:, None]
        zero = torch.zeros((), dtype=idx.dtype, device=idx.device)
        seq = torch.where(valid, stream[torch.where(valid, idx, zero)], zero)
        out = {k: v for k, v in batch.items() if k != "seq_start"}
        out[self.seq_field] = seq
        return out



class SequentialTrainLoader(ArrayTrainLoader):
    def __init__(self, config, split, batch_size=None):
        iid_f = config["ITEM_ID_FIELD"]
        columns = {
            config["USER_ID_FIELD"]: split.uid,
            "seq_start": split.start,
            config["ITEM_LIST_LENGTH_FIELD"]: split.length,
            iid_f: split.target,
        }
        transform = SeqTransform(
            split.item_stream, config["MAX_ITEM_LIST_LENGTH"],
            iid_f + config["LIST_SUFFIX"], config["ITEM_LIST_LENGTH_FIELD"])
        super().__init__(config, columns, batch_size, device_transform=transform)
        self.dataset = split
        self._len_field = config["ITEM_LIST_LENGTH_FIELD"]
        self._seq_field = iid_f + config["LIST_SUFFIX"]
        self._max_len = config["MAX_ITEM_LIST_LENGTH"]

    def columns(self):
        """The train table WITH the sequences materialised as an (N, L)
        matrix, so that a batch is one gather of contiguous rows, not N * L
        element gathers from the flat stream. Memory: N * L ids (the trainer
        uploads them as int64: 393 MB at the ml-1m shape)."""
        cols = dict(self._columns)
        start = cols.pop("seq_start")
        L = self._max_len
        lens = cols[self._len_field]
        stream = np.asarray(self.dataset.item_stream)
        idx = start[:, None].astype(np.int64) + np.arange(L)[None, :]
        valid = np.arange(L)[None, :] < lens[:, None]
        cols[self._seq_field] = np.where(
            valid, stream[np.clip(idx, 0, len(stream) - 1)], 0
        ).astype(np.int32)
        return cols


class SequentialEvalLoader:
    """Eval batches for sequential splits: one (seq -> target) example per row.

    pos_len is always 1; no history masking (items may repeat; parity:
    SequentialFullDataLoader, sequential_dataloader.py:236-294, history_index
    None) and negative sampling is repeatable.
    """

    mask_history = False
    repeatable_sampling = True

    def __init__(self, config, split, n_items, batch_size=None):
        self.config = config
        self.split = split
        self.n_items = n_items
        self.uid_f = config["USER_ID_FIELD"]
        self.len_f = config["ITEM_LIST_LENGTH_FIELD"]
        self.max_pos = 1
        self.device_transform = SeqTransform(
            split.item_stream, config["MAX_ITEM_LIST_LENGTH"],
            config["ITEM_ID_FIELD"] + config["LIST_SUFFIX"], self.len_f)
        if batch_size is None:
            # the JAX package's rule (loaders.py:214-220): about
            # eval_batch_size * 32768 scores per batch
            budget = (config["eval_batch_size"] or 4096) * 32768
            batch_size = int(np.clip(budget // max(n_items, 1), 8, 4096))
            batch_size = min(batch_size, max(len(split), 8))
        self.batch_size = batch_size
        self.n = len(split)

    @property
    def n_eval_users(self):
        return self.n

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        B = self.batch_size
        for start in range(0, self.n, B):
            sl = slice(start, min(start + B, self.n))
            cnt = sl.stop - sl.start
            pad = B - cnt

            def padded(a, fill=0):
                out = np.full((B,) + a.shape[1:], fill, dtype=a.dtype)
                out[:cnt] = a[sl]
                return out

            yield {
                self.uid_f: padded(self.split.uid),
                "seq_start": padded(self.split.start),
                self.len_f: np.maximum(padded(self.split.length), 1),
                "pos_items": padded(self.split.target)[:, None],
                "pos_len": np.concatenate([np.ones(cnt, np.int32),
                                           np.zeros(pad, np.int32)]),
                "_mask": np.concatenate([np.ones(cnt, np.float32),
                                         np.zeros(pad, np.float32)]),
            }


class SequentialSampledEvalLoader(SequentialEvalLoader):
    """Sampled ranking over sequential splits (uni<k>/pop<k>): each row's
    target, then k negatives drawn on the device without exclusion. The
    batch keeps batch x (1 + k) candidates near eval_batch_size x 4096."""

    def __init__(self, config, split, n_items, neg_sample_args, batch_size=None):
        self.neg_k = int(neg_sample_args["by"])
        self.distribution = neg_sample_args.get("distribution", "uniform")
        super().__init__(config, split, n_items, batch_size)
        if batch_size is None:
            width = max(1 + self.neg_k, 1)
            budget = (self.config["eval_batch_size"] or 4096) * 4096
            self.batch_size = int(np.clip(budget // width, 4, 4096))
            self.batch_size = min(self.batch_size, max(self.n, 4))

    @property
    def num_candidates(self):
        return 1 + self.neg_k


class RowEvalLoader:
    """Plain row batches for INDIVIDUAL (value-metric) evaluation: AUC/LogLoss/
    MAE/RMSE over (label, prediction) pairs (parity: reference LossEvaluator
    path, evaluators.py:289-367: CTR protocols are ungrouped, no sampling).
    The trainer uploads ``fields`` once and slices batches on the device;
    iterating yields the same batches as padded numpy arrays with a
    ``_mask`` column."""

    def __init__(self, config, dataset, batch_size=None):
        self.config = config
        self.dataset = dataset
        # rows are a handful of scalars, so the dispatch count, not memory,
        # bounds this path; floor the batch well above the top-k default
        self.batch_size = batch_size or max(config["eval_batch_size"] or 4096,
                                            65536)
        self.fields = {f: np.asarray(v) for f, v in dataset.inter_feat.items()
                       if v.dtype != object}
        self.n = len(dataset)

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        B = self.batch_size
        for start in range(0, self.n, B):
            sl = slice(start, min(start + B, self.n))
            cnt = sl.stop - sl.start
            pad = B - cnt
            batch = {}
            for f, col in self.fields.items():
                out = np.zeros((B,) + col.shape[1:], dtype=col.dtype)
                out[:cnt] = col[sl]
                batch[f] = out
            batch["_mask"] = np.concatenate([np.ones(cnt, np.float32),
                                             np.zeros(pad, np.float32)])
            yield batch


class FullSortEvalLoader:
    """Full-sort ranking evaluation batches.

    Groups the eval split by user; each batch is:
        user_id:  (B,)  int32
        pos_items:(B, P) int32, padded with 0
        pos_len:  (B,)  int32
        _mask:    (B,)  float32 — 0 for padding users

    History masking (items from EARLIER phases must score -inf,
    trainer.py:343-345 in the reference) is applied on device from the
    phase history matrix — not here.
    """

    def __init__(self, config, dataset, n_items, batch_size=None):
        self.config = config
        uid_field = config["USER_ID_FIELD"]
        iid_field = config["ITEM_ID_FIELD"]
        uids = np.asarray(dataset.inter_feat[uid_field])
        iids = np.asarray(dataset.inter_feat[iid_field])
        # positives-only eval: when an explicit label column exists, rank only
        # label==1 rows (labeled-dataset workflows, fork §2.9)
        label_field = config["LABEL_FIELD"]
        if label_field in dataset.inter_feat:
            pos_mask = np.asarray(dataset.inter_feat[label_field]) > 0.5
            uids, iids = uids[pos_mask], iids[pos_mask]

        # per-user padded positives via the shared vectorized grouper
        from .dataset import build_history_matrix
        users = np.unique(uids)
        full_pos, full_len = build_history_matrix(
            uids, iids, int(uids.max()) + 1 if len(uids) else 1)
        self.users = users.astype(np.int32)
        self.pos_items = full_pos[users]
        self.pos_len = full_len[users].astype(np.int32)
        self.max_pos = self.pos_items.shape[1]

        if batch_size is None:
            # the JAX package's user-batch rule (loaders.py:382-388): about
            # eval_batch_size * 32768 scores per batch, never padding beyond
            # the actual eval-user count
            budget = (config["eval_batch_size"] or 4096) * 32768
            batch_size = int(np.clip(budget // max(n_items, 1), 8, 4096))
            batch_size = min(batch_size, max(len(self.users), 8))
        self.batch_size = batch_size

    def __len__(self):
        return (len(self.users) + self.batch_size - 1) // self.batch_size

    @property
    def n_eval_users(self):
        return len(self.users)

    def __iter__(self):
        B = self.batch_size
        for start in range(0, len(self.users), B):
            sl = slice(start, start + B)
            u = self.users[sl]
            p = self.pos_items[sl]
            l = self.pos_len[sl]
            pad = B - len(u)
            mask = np.ones(B, dtype=np.float32)
            if pad:
                u = np.concatenate([u, np.zeros(pad, np.int32)])
                p = np.concatenate([p, np.zeros((pad, p.shape[1]), np.int32)])
                l = np.concatenate([l, np.zeros(pad, np.int32)])
                mask[-pad:] = 0.0
            yield {"user_id": u, "pos_items": p, "pos_len": l, "_mask": mask}


class SampledEvalLoader(FullSortEvalLoader):
    """Sampled ranking evaluation (uni<k>/pop<k> presets).

    Reference semantics (general_dataloader.py:132-265): each user's
    candidate list is their P positives followed by P*k sampled negatives (k
    per positive), the negatives excluding every item the user interacted
    with in any phase up to this one. Negatives are drawn on the device per
    batch.
    """

    def __init__(self, config, dataset, n_items, neg_sample_args, batch_size=None):
        self.neg_k = int(neg_sample_args["by"])
        self.distribution = neg_sample_args.get("distribution", "uniform")
        super().__init__(config, dataset, n_items, batch_size)
        if batch_size is None:
            # candidate width P*(1+k); keep batch x width bounded, and never
            # pad beyond the real user count
            width = max(self.max_pos * (1 + self.neg_k), 1)
            budget = (self.config["eval_batch_size"] or 4096) * 4096
            self.batch_size = int(np.clip(budget // width, 4, 4096))
            self.batch_size = min(self.batch_size, max(len(self.users), 4))

    @property
    def num_candidates(self):
        return self.max_pos * (1 + self.neg_k)


class DatasetNegEvalLoader:
    """Ranking evaluation against the dataset's OWN labeled negatives.

    Parity target: the fork's GeneralNegFromDatasetDataLoader
    (general_dataloader.py:53-129): per user, the candidate list is their
    label-1 rows (positives first) followed by their label-0 rows; pos_len
    and neg_len come from the data, no sampling, no history mask. Users
    without a positive are left out: they add nothing to grouped metrics.
    """

    mask_history = False

    def __init__(self, config, dataset, n_items, batch_size=None):
        from .dataset import build_history_matrix
        self.config = config
        self.n_items = n_items
        label_f = config["LABEL_FIELD"]
        if label_f not in dataset.inter_feat:
            raise ValueError("eval_use_dataset_negatives requires a label "
                             "column in the dataset")
        uids = np.asarray(dataset.inter_feat[config["USER_ID_FIELD"]])
        iids = np.asarray(dataset.inter_feat[config["ITEM_ID_FIELD"]])
        labels = np.asarray(dataset.inter_feat[label_f]) > 0.5

        def group(u, i):
            if len(u) == 0:
                return (np.zeros(0, np.int64), np.zeros((0, 1), np.int32),
                        np.zeros(0, np.int32))
            users = np.unique(u)
            mat, lens = build_history_matrix(u, i, int(u.max()) + 1)
            return users, mat[users], lens[users].astype(np.int32)

        pu, pos, plen = group(uids[labels], iids[labels])
        nu, neg, nlen = group(uids[~labels], iids[~labels])
        # each positive user's row of the negative table (none: 0 negatives)
        if len(nu):
            row = np.minimum(np.searchsorted(nu, pu), len(nu) - 1)
            has = nu[row] == pu
        else:
            row, has = np.zeros(len(pu), np.int64), np.zeros(len(pu), bool)
        self.users = pu.astype(np.int32)
        self.pos_items, self.pos_len = pos, plen
        self.neg_items = np.zeros((len(pu), neg.shape[1]), np.int32)
        self.neg_len = np.zeros(len(pu), np.int32)
        self.neg_items[has] = neg[row[has]]
        self.neg_len[has] = nlen[row[has]]
        self.max_pos = pos.shape[1]
        self.max_neg = neg.shape[1]
        if batch_size is None:
            width = max(self.max_pos + self.max_neg, 1)
            budget = (config["eval_batch_size"] or 4096) * 4096
            batch_size = int(np.clip(budget // width, 4, 4096))
            batch_size = min(batch_size, max(len(self.users), 4))
        self.batch_size = batch_size

    @property
    def n_eval_users(self):
        return len(self.users)

    def __len__(self):
        return (len(self.users) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        B = self.batch_size
        for start in range(0, len(self.users), B):
            sl = slice(start, start + B)
            arrs = {"user_id": self.users[sl], "pos_items": self.pos_items[sl],
                    "pos_len": self.pos_len[sl], "neg_items": self.neg_items[sl],
                    "neg_len": self.neg_len[sl]}
            cnt = len(arrs["user_id"])
            pad = B - cnt
            mask = np.ones(B, np.float32)
            if pad:
                arrs = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                        for k, v in arrs.items()}
                mask[-pad:] = 0.0
            arrs["_mask"] = mask
            yield arrs
