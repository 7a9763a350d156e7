"""SequentialDataset: time-ordered stream + index-based augmentation.

Port of recbole_tpu/data/seq_dataset.py, numpy throughout as there (parity
target: reference SequentialDataset,
recbole/data/dataset/sequential_dataset.py:22-155): per user sorted by time,
one training example per target position, WITHOUT materializing sequences;
enforced temporal ordering + leave-one-out split.

The sorted item stream is one flat int32 array; each example is (uid,
window_start, window_len, target). Padded sequence batches are gathered
from the stream on the device (data/loaders.py, ``SeqTransform``), or
materialised once as an (N, L) matrix for the train table
(``SequentialTrainLoader.columns``); the reference's per-row Python
``augmentation`` loop (sequential_dataloader.py:115-146) disappears.
"""

import numpy as np

from .dataset import Dataset


class SequentialSplit:
    """One split of sequential examples sharing the global item stream."""

    def __init__(self, parent, uid, start, length, target):
        self.parent = parent
        self.uid = uid
        self.start = start
        self.length = length
        self.target = target

    def __len__(self):
        return len(self.uid)

    def __getattr__(self, name):
        parent = self.__dict__.get("parent")
        if parent is None:
            raise AttributeError(name)
        return getattr(parent, name)


class SequentialDataset(Dataset):
    def __init__(self, config, _build=True):
        super().__init__(config, _build)
        self.max_seq_len = config["MAX_ITEM_LIST_LENGTH"]

    def build(self, eval_setting):
        """Temporal sort -> stream -> augment -> leave-one-out on examples.

        The reference requires TO ordering and loo splitting for sequential
        models (sequential_dataset.py:137-155); ratio splits raise.
        With ``benchmark_filename``, each pre-split part is augmented
        independently (no re-splitting — parity: dataset.py:1390-1393).
        """
        uids = np.asarray(self.inter_feat[self.uid_field])
        iids = np.asarray(self.inter_feat[self.iid_field])
        times = (np.asarray(self.inter_feat[self.time_field])
                 if self.time_field in self.inter_feat
                 else np.arange(len(uids), dtype=np.float32))

        if self.benchmark_lens is not None:
            cum = np.cumsum([0] + self.benchmark_lens)
            # one shared stream; each part's examples are built only from
            # that part's rows (the stream is part-contiguous so windows
            # never cross split boundaries)
            streams, parts = [], []
            for i in range(len(self.benchmark_lens)):
                sl = slice(cum[i], cum[i + 1])
                order = np.lexsort((times[sl], uids[sl])) + cum[i]
                streams.append(order)
            order_all = np.concatenate(streams) if streams else np.zeros(0, int)
            self.item_stream = iids[order_all].astype(np.int32)
            stream_uids = uids[order_all]
            for i in range(len(self.benchmark_lens)):
                lo, hi = cum[i], cum[i + 1]
                parts.append(self._augment_range(stream_uids, lo, hi))
            return parts

        if eval_setting.split_args["strategy"] != "loo":
            raise ValueError("SequentialDataset requires leave-one-out "
                             "splitting (TO_LS)")
        leave_one_num = eval_setting.split_args.get("leave_one_num", 2)

        # global (user, time)-sorted stream
        order = np.lexsort((times, uids))
        self.item_stream = iids[order].astype(np.int32)
        stream_uids = uids[order]

        users, starts = np.unique(stream_uids, return_index=True)
        counts = np.diff(np.append(starts, len(stream_uids)))
        n = len(stream_uids)
        L = self.max_seq_len

        # fully vectorized augmentation: every stream position with at least
        # one prior same-user item becomes an example
        row_start = np.repeat(starts, counts)                  # (n,)
        t = np.arange(n) - row_start                           # position in group
        is_ex = t >= 1
        gpos = np.arange(n)[is_ex]
        tt = t[is_ex]
        ln = np.minimum(tt, L)
        ex = (stream_uids[is_ex].astype(np.int32),
              (row_start[is_ex] + tt - ln).astype(np.int32),
              ln.astype(np.int32),
              self.item_stream[gpos])

        # leave-one-out over each user's example list (reference
        # _split_index_by_leave_one_out semantics, dataset.py:1317-1338):
        # the LAST examples go to test/valid; users with too few examples
        # contribute fewer held-out parts (single-example users stay in train)
        n_ex_user = np.maximum(counts - 1, 0)
        n_ex_per_ex = np.repeat(n_ex_user, n_ex_user)          # (n_examples,)
        ex_in_user = tt - 1
        legal = np.minimum(leave_one_num, n_ex_per_ex - 1)
        boundary = n_ex_per_ex - legal
        part = np.where(
            ex_in_user < boundary, 0,
            leave_one_num + 1 - legal + (ex_in_user - boundary))

        out = []
        for p in range(leave_one_num + 1):
            idx = np.nonzero(part == p)[0]
            out.append(SequentialSplit(self, *(a[idx] for a in ex)))
        return out

    def _augment_range(self, stream_uids, lo, hi):
        """All augmented examples whose window lies in stream[lo:hi]."""
        L = self.max_seq_len
        seg = stream_uids[lo:hi]
        if len(seg) == 0:
            z = np.zeros(0, np.int32)
            return SequentialSplit(self, z, z, z, z)
        users, starts = np.unique(seg, return_index=True)
        counts = np.diff(np.append(starts, len(seg)))
        row_start = np.repeat(starts, counts)
        t = np.arange(len(seg)) - row_start
        is_ex = t >= 1
        tt = t[is_ex]
        ln = np.minimum(tt, L)
        return SequentialSplit(
            self,
            seg[is_ex].astype(np.int32),
            (lo + row_start[is_ex] + tt - ln).astype(np.int32),
            ln.astype(np.int32),
            self.item_stream[lo + np.arange(len(seg))[is_ex]])
