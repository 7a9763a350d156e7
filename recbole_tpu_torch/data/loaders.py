"""Batch pipelines.

Port of recbole_tpu/data/loaders.py: ``TrainLoader`` (:17),
``RowEvalLoader`` (:271) and ``FullSortEvalLoader`` (:345). The train loader only holds the columnar
training table: the trainer uploads it to the device once and slices
shuffled batches there, the eager counterpart of the JAX trainer's scanned
epoch (trainer.py:503-509). Negatives are drawn on the device by the
trainer. The sampled and dataset-negative eval loaders are not ported yet.
"""

import numpy as np


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


class SampledEvalLoader:
    """Sampled ranking evaluation (uni<k>/pop<k>): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "sampled evaluation (uni<k>/pop<k>, and valid_full_to_uni1000) is "
            "not ported yet (ROADMAP Queue 1, item 3); use full-sort eval")


class DatasetNegEvalLoader:
    """Ranking against the dataset's labeled negatives: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "eval_use_dataset_negatives is not ported yet (ROADMAP Queue 1, "
            "item 3)")
