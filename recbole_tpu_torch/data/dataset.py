"""Dataset: columnar in-memory store + preprocessing + split engine.

Port of recbole_tpu/data/dataset.py, numpy throughout as there.
Parity target: reference Dataset (recbole/data/dataset/dataset.py:33-1709),
re-designed columnar-numpy-first: every field is a flat numpy array, token
fields become contiguous int32 ids with 0 reserved for [PAD], and the split
engine emits index arrays — nothing touches a DataFrame after load.

Pipeline (parity: dataset.py:100-158): load -> filter (nan / dup / value /
k-core / feat-consistency) -> remap ids -> user/item feat align -> fillna ->
label-from-threshold -> normalize.
"""

import logging
import os
import pickle

import numpy as np
import scipy.sparse as sp

from .atomic import read_atomic_file, atomic_path
from ..utils.enums import FeatureType, FeatureSource


def isin(values, test):
    """np.isin, by hashing where either side holds objects (tokens before
    the remap): numpy's isin compares an object array element by element
    against each test value, 94 s for an ml-1m-sized .inter against its
    3,706 items."""
    if values.dtype == object or np.asarray(test).dtype == object:
        import pandas as pd
        return pd.Series(values).isin(test).to_numpy()
    return np.isin(values, test)

PAD_TOKEN = "[PAD]"


def build_history_matrix(keys, values, num_keys, max_len=None):
    """Dense per-key history: (num_keys, width) padded with 0 + lengths.

    Fully vectorized (stable sort + group-offset arithmetic); this is on the
    critical path for million-interaction datasets.
    """
    keys = np.asarray(keys)
    values = np.asarray(values)
    counts = np.bincount(keys, minlength=num_keys)
    width = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if max_len is not None:
        width = min(width, max_len)
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], values[order]
    starts = np.zeros(num_keys + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(sk)) - starts[sk]
    keep = pos < width
    hist = np.zeros((num_keys, width), dtype=np.int32)
    hist[sk[keep], pos[keep]] = sv[keep]
    lens = np.minimum(counts, width).astype(np.int32)
    return hist, lens


class Dataset:
    """Columnar dataset.

    Attributes:
        inter_feat / user_feat / item_feat: dict[field -> np.ndarray]. After
            preprocessing, token fields are int32 id arrays; *_seq fields are
            object arrays of int32/float32 vectors. user_feat/item_feat are
            aligned: row i describes entity with id i (row 0 = PAD).
        field2type / field2source: schema metadata.
        field2id_token: field -> np.ndarray mapping id -> original token.
        field2token_id: field -> dict token -> id.
    """

    def __init__(self, config, _build=True):
        self.config = config
        self.dataset_name = config["dataset"]
        self.logger = logging.getLogger("recbole_tpu_torch")
        self.dataset_path = os.path.join(config["data_path"], self.dataset_name)

        self.uid_field = config["USER_ID_FIELD"]
        self.iid_field = config["ITEM_ID_FIELD"]
        self.label_field = config["LABEL_FIELD"]
        self.time_field = config["TIME_FIELD"]

        self.field2type = {}
        self.field2source = {}
        self.field2id_token = {}
        self.field2token_id = {}
        self.inter_feat = {}
        self.user_feat = None
        self.item_feat = None
        self.benchmark_lens = None

        if _build:
            self._load_all()
            self._process()

    # ------------------------------------------------------------------ load

    def _load_all(self):
        self._load_inter()
        self._load_side("user", self.uid_field)
        self._load_side("item", self.iid_field)
        self._load_additional()

    def _selected_cols(self, suffix):
        load_col = self.config["load_col"]
        if load_col is None:
            return None  # load everything
        cols = load_col.get(suffix)
        return cols  # None means: don't load this file at all (except inter)

    def _load_inter(self):
        bench = self.config["benchmark_filename"]
        sep = self.config["field_separator"]
        seq_sep = self.config["seq_separator"]
        usecols = self._selected_cols("inter")
        unload = (self.config["unload_col"] or {}).get("inter")
        if bench:
            # pre-split files <ds>.<part>.inter concatenated; lengths recorded so
            # build() can slice them back (parity: dataset.py:229-249, 1390-1393)
            parts, lens = [], []
            for name in bench:
                path = os.path.join(self.dataset_path, f"{self.dataset_name}.{name}.inter")
                cols, types = read_atomic_file(path, sep, seq_sep, usecols, unload)
                parts.append(cols)
                lens.append(len(next(iter(cols.values()))))
                self._merge_schema(types, FeatureSource.INTERACTION)
            self.inter_feat = {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}
            self.benchmark_lens = lens
        else:
            path = atomic_path(self.config["data_path"], self.dataset_name, "inter")
            cols, types = read_atomic_file(path, sep, seq_sep, usecols, unload)
            self.inter_feat = cols
            self._merge_schema(types, FeatureSource.INTERACTION)

    def _load_side(self, suffix, key_field):
        path = atomic_path(self.config["data_path"], self.dataset_name, suffix)
        usecols = self._selected_cols(suffix)
        if not os.path.isfile(path) or (self.config["load_col"] is not None and usecols is None):
            return
        unload = (self.config["unload_col"] or {}).get(suffix)
        cols, types = read_atomic_file(path, self.config["field_separator"],
                                       self.config["seq_separator"], usecols, unload)
        if key_field not in cols:
            raise ValueError(f"{suffix} file must contain {key_field}")
        src = FeatureSource.USER if suffix == "user" else FeatureSource.ITEM
        self._merge_schema(types, src)
        setattr(self, f"{suffix}_feat", cols)

    def _load_additional(self):
        for suffix in self.config["additional_feat_suffix"] or []:
            path = atomic_path(self.config["data_path"], self.dataset_name, suffix)
            usecols = self._selected_cols(suffix)
            cols, types = read_atomic_file(path, self.config["field_separator"],
                                           self.config["seq_separator"], usecols, None)
            self._merge_schema(types, FeatureSource.INTERACTION)
            setattr(self, f"{suffix}_feat", cols)

    def _merge_schema(self, types, source):
        for f, t in types.items():
            if f in self.field2type and self.field2type[f] is not t:
                raise ValueError(f"field {f} has conflicting types")
            self.field2type[f] = t
            self.field2source.setdefault(f, source)
        # id fields get their dedicated source tag (parity: dataset.py:330-340)
        if self.uid_field in self.field2source and source is FeatureSource.INTERACTION:
            self.field2source[self.uid_field] = FeatureSource.USER_ID
        if self.iid_field in self.field2source and source is FeatureSource.INTERACTION:
            self.field2source[self.iid_field] = FeatureSource.ITEM_ID

    # --------------------------------------------------------------- process

    def _process(self):
        if self.benchmark_lens is None:
            self._filter_nan_ids()
            self._remove_duplicate_inters()
            self._filter_by_value()
            self._filter_by_feat_consistency()
            self._filter_kcore()
        self._remap_ids()
        self._align_side_feats()
        self._fill_nan()
        self._set_label_by_threshold()
        self._normalize()
        self._preload_weight_matrix()

    def _inter_len(self):
        if not self.inter_feat:
            return 0
        return len(next(iter(self.inter_feat.values())))

    def _apply_inter_mask(self, mask):
        self.inter_feat = {f: v[mask] for f, v in self.inter_feat.items()}

    def _filter_nan_ids(self):
        n = self._inter_len()
        mask = np.ones(n, dtype=bool)
        import pandas as pd
        for f in (self.uid_field, self.iid_field):
            if f in self.inter_feat:
                mask &= ~pd.isna(self.inter_feat[f])
        if not mask.all():
            self._apply_inter_mask(mask)

    def _remove_duplicate_inters(self):
        keep = self.config["rm_dup_inter"]
        if keep is None or self.uid_field not in self.inter_feat:
            return
        if keep not in ("first", "last"):
            raise ValueError("rm_dup_inter must be 'first', 'last' or None")
        n = self._inter_len()
        if n == 0:
            return
        order = np.arange(n)
        if self.time_field in self.inter_feat:
            order = np.argsort(self.inter_feat[self.time_field], kind="stable")
        uids, iids = self.inter_feat[self.uid_field], self.inter_feat[self.iid_field]
        # vectorized first/last-per-(u,i): factorize pairs, then keep the
        # first occurrence along the (time-)order (reversed for 'last')
        u_codes = np.unique(uids, return_inverse=True)[1]
        i_codes = np.unique(iids, return_inverse=True)[1]
        pair = u_codes.astype(np.int64) * (i_codes.max() + 1) + i_codes
        seq = order if keep == "first" else order[::-1]
        _, first_idx = np.unique(pair[seq], return_index=True)
        mask = np.zeros(n, dtype=bool)
        mask[seq[first_idx]] = True
        self._apply_inter_mask(mask)

    def _filter_by_value(self):
        specs = (("lowest_val", np.greater_equal), ("highest_val", np.less_equal),
                 ("equal_val", np.equal), ("not_equal_val", np.not_equal))
        n = self._inter_len()
        mask = np.ones(n, dtype=bool)
        changed = False
        for key, op in specs:
            rules = self.config[key]
            if not rules:
                continue
            for field, val in rules.items():
                if field in self.inter_feat:
                    mask &= op(self.inter_feat[field].astype(np.float32), val)
                    changed = True
                else:
                    # value filters can also prune side tables (parity: dataset.py:721-746)
                    for feat in (self.user_feat, self.item_feat):
                        if feat is not None and field in feat:
                            fmask = op(feat[field].astype(np.float32), val)
                            for f in feat:
                                feat[f] = feat[f][fmask]
                            changed = True
        if changed:
            self._apply_inter_mask(mask)

    def _filter_by_feat_consistency(self):
        """Drop interactions whose user/item is absent from a loaded side table
        (parity: dataset.py:764-780, filter_inter_by_user_or_item)."""
        if not self.config["filter_inter_by_user_or_item"]:
            return
        mask = np.ones(self._inter_len(), dtype=bool)
        if self.user_feat is not None:
            mask &= isin(self.inter_feat[self.uid_field],
                            self.user_feat[self.uid_field])
        if self.item_feat is not None:
            mask &= isin(self.inter_feat[self.iid_field],
                            self.item_feat[self.iid_field])
        if not mask.all():
            self._apply_inter_mask(mask)

    def _filter_kcore(self):
        """Iterative k-core by user/item interaction counts
        (parity: dataset.py:605-671)."""
        min_u = self.config["min_user_inter_num"] or 0
        min_i = self.config["min_item_inter_num"] or 0
        max_u = self.config["max_user_inter_num"]
        max_i = self.config["max_item_inter_num"]
        if min_u <= 1 and min_i <= 1 and max_u is None and max_i is None:
            return
        uids = self.inter_feat[self.uid_field]
        iids = self.inter_feat[self.iid_field]
        keep = np.ones(len(uids), dtype=bool)
        while True:
            u_vals, u_inv = np.unique(uids[keep], return_inverse=True)
            u_cnt = np.bincount(u_inv)
            i_vals, i_inv = np.unique(iids[keep], return_inverse=True)
            i_cnt = np.bincount(i_inv)
            bad_u = u_vals[(u_cnt < min_u) | ((u_cnt > max_u) if max_u else False)]
            bad_i = i_vals[(i_cnt < min_i) | ((i_cnt > max_i) if max_i else False)]
            if not len(bad_u) and not len(bad_i):
                break
            new_keep = keep.copy()
            idx = np.nonzero(keep)[0]
            drop = isin(uids[idx], bad_u) | isin(iids[idx], bad_i)
            new_keep[idx[drop]] = False
            if new_keep.sum() == keep.sum():
                break
            keep = new_keep
        self._apply_inter_mask(keep)
        # prune side tables of removed entities to keep vocabularies tight
        if self.user_feat is not None:
            m = isin(self.user_feat[self.uid_field],
                        self.inter_feat[self.uid_field])
            self.user_feat = {f: v[m] for f, v in self.user_feat.items()}
        if self.item_feat is not None:
            m = isin(self.item_feat[self.iid_field],
                        self.inter_feat[self.iid_field])
            self.item_feat = {f: v[m] for f, v in self.item_feat.items()}

    # -------------------------------------------------------------- remap ids

    def _remap_spaces(self):
        """Group token fields into shared id spaces (parity: dataset.py:810-928,
        fields_in_same_space; uid/iid anchor their own spaces)."""
        token_fields = [f for f, t in self.field2type.items()
                        if t in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ)]
        spaces = []
        assigned = {}
        for group in self.config["fields_in_same_space"] or []:
            group = [f for f in group if f in token_fields]
            if group:
                spaces.append(list(group))
                for f in group:
                    assigned[f] = len(spaces) - 1
        for f in token_fields:
            if f not in assigned:
                spaces.append([f])
                assigned[f] = len(spaces) - 1
        return spaces

    def _field_arrays(self, field):
        """Yield (container, key) pairs holding this field across sources."""
        for feat in (self.inter_feat, self.user_feat, self.item_feat):
            if feat is not None and field in feat:
                yield feat, field

    def _remap_ids(self):
        for space in self._remap_spaces():
            # collect all tokens in the space, in first-occurrence order
            # (parity with pd.factorize semantics; PAD gets id 0)
            token_list = []
            for field in space:
                ftype = self.field2type[field]
                for feat, key in self._field_arrays(field):
                    col = feat[key]
                    if ftype is FeatureType.TOKEN:
                        token_list.append(col.astype(object))
                    else:
                        token_list.append(np.concatenate([np.asarray(s, dtype=object)
                                                          for s in col])
                                          if len(col) else np.zeros(0, object))
            if not token_list:
                continue
            all_tokens = np.concatenate(token_list)
            # missing tokens (empty cells read as NaN) map to [PAD]=0 — the
            # reference's pd.factorize gives NaN code -1 -> id 0
            # (dataset.py:810-928); astype(str) would mint a live "nan" token
            import pandas as pd
            nan_mask = pd.isna(all_tokens)
            new_codes = np.zeros(len(all_tokens), dtype=np.int64)
            valid_pos = np.nonzero(~nan_mask)[0]
            vt = all_tokens[valid_pos].astype(str)
            uniq, codes = np.unique(vt, return_inverse=True)
            # order by first occurrence so ids are deterministic given file order
            first_pos = np.full(len(uniq), len(all_tokens), dtype=np.int64)
            np.minimum.at(first_pos, codes, valid_pos)
            order = np.argsort(first_pos, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            new_codes[valid_pos] = rank[codes] + 1  # 0 reserved for [PAD]
            id2token = np.concatenate([[PAD_TOKEN], uniq[order]])
            token2id = {t: i for i, t in enumerate(id2token)}

            # write back
            pos = 0
            for field in space:
                ftype = self.field2type[field]
                for feat, key in self._field_arrays(field):
                    col = feat[key]
                    if ftype is FeatureType.TOKEN:
                        n = len(col)
                        feat[key] = new_codes[pos:pos + n].astype(np.int32)
                        pos += n
                    else:
                        out = np.empty(len(col), dtype=object)
                        for r, s in enumerate(col):
                            k = len(s)
                            out[r] = new_codes[pos:pos + k].astype(np.int32)
                            pos += k
                        feat[key] = out
                self.field2id_token[field] = id2token
                self.field2token_id[field] = token2id

    def _align_side_feats(self):
        """Reindex user/item tables so row i = entity id i; row 0 = PAD
        (parity: dataset.py user/item feat reindex + fillna order)."""
        for name, key_field, num in (("user_feat", self.uid_field, None),
                                     ("item_feat", self.iid_field, None)):
            feat = getattr(self, name)
            if feat is None:
                continue
            key_num = len(self.field2id_token[key_field])
            new_feat = {}
            ids = feat[key_field]
            for f, col in feat.items():
                ftype = self.field2type[f]
                if ftype is FeatureType.TOKEN:
                    out = np.zeros(key_num, dtype=np.int32)
                    out[ids] = col
                elif ftype is FeatureType.FLOAT:
                    out = np.full(key_num, np.nan, dtype=np.float32)
                    out[ids] = col
                else:
                    out = np.empty(key_num, dtype=object)
                    empty = (np.zeros(0, np.int32) if ftype is FeatureType.TOKEN_SEQ
                             else np.zeros(0, np.float32))
                    out[:] = [empty] * key_num
                    for rid, val in zip(ids, col):
                        out[rid] = val
                new_feat[f] = out
            new_feat[key_field] = np.arange(key_num, dtype=np.int32)
            setattr(self, name, new_feat)

    def _fill_nan(self):
        """token -> 0, float -> mean, seq -> empty (parity: dataset.py:482-503)."""
        for feat in (self.inter_feat, self.user_feat, self.item_feat):
            if feat is None:
                continue
            for f, col in feat.items():
                if self.field2type[f] is FeatureType.FLOAT and np.issubdtype(
                        col.dtype, np.floating):
                    nan = np.isnan(col)
                    if nan.any():
                        mean = np.nanmean(col) if not nan.all() else 0.0
                        col[nan] = mean

    def _set_label_by_threshold(self):
        thr = self.config["threshold"]
        if not thr:
            return
        if len(thr) != 1:
            raise ValueError("threshold must contain exactly one field")
        (field, val), = thr.items()
        if field not in self.inter_feat:
            raise ValueError(f"threshold field {field} not loaded")
        self.inter_feat[self.label_field] = (
            self.inter_feat[field].astype(np.float32) >= val).astype(np.float32)
        self.field2type[self.label_field] = FeatureType.FLOAT
        self.field2source[self.label_field] = FeatureSource.INTERACTION
        if field != self.label_field:
            for feat, key in self._field_arrays(field):
                del feat[key]

    def _normalize(self):
        fields = self.config["normalize_field"]
        if self.config["normalize_all"]:
            fields = [f for f, t in self.field2type.items()
                      if t is FeatureType.FLOAT and f != self.label_field]
        for f in fields or []:
            if self.field2type.get(f) is not FeatureType.FLOAT:
                raise ValueError(f"normalize_field {f} is not a float field")
            for feat, key in self._field_arrays(f):
                col = feat[key].astype(np.float32)
                lo, hi = col.min(), col.max()
                feat[key] = (col - lo) / (hi - lo) if hi > lo else np.zeros_like(col)

    # ------------------------------------------------------- preload weights

    def _preload_weight_matrix(self):
        """Build pretrained-embedding matrices from additional feat files
        (parity: dataset.py:423-480 + get_preload_weight:1670).

        config ``preload_weight: {<id_field>: <value_field>}`` — an
        additional_feat_suffix file holds (id token, float_seq vector) rows;
        the matrix row index is the id's position in its vocabulary. The
        vocabulary is the id field's own when it was remapped, otherwise the
        known vocab (entity/item/user/relation/...) with the best token
        hit-rate.
        """
        self._preloaded_weight = {}
        preload = self.config["preload_weight"]
        if not preload:
            return
        tables = []
        for suffix in self.config["additional_feat_suffix"] or []:
            tab = getattr(self, f"{suffix}_feat", None)
            if tab is not None:
                tables.append(tab)
        for id_field, value_field in preload.items():
            tab = next((t for t in tables
                        if id_field in t and value_field in t), None)
            if tab is None:
                raise ValueError(
                    f"preload_weight: no additional feat file contains both "
                    f"{id_field!r} and {value_field!r} "
                    f"(set additional_feat_suffix)")
            tokens = np.asarray(tab[id_field]).astype(str)
            vecs = tab[value_field]
            dim = len(vecs[0]) if len(vecs) else 0
            token2id = self._resolve_preload_vocab(id_field, tokens)
            n_vocab = max(token2id.values(), default=0) + 1
            matrix = np.zeros((max(n_vocab, 1), dim), np.float32)
            for tok, vec in zip(tokens, vecs):
                rid = token2id.get(tok)
                if rid is not None:
                    matrix[rid] = np.asarray(vec, np.float32)[:dim]
            self._preloaded_weight[id_field] = matrix

    def _resolve_preload_vocab(self, id_field, tokens):
        if id_field in self.field2token_id:
            return self.field2token_id[id_field]
        space = (self.config["preload_weight_space"] or {}).get(id_field)
        if space:
            return self.field2token_id[space]
        sample = set(tokens[:200].tolist())
        best, best_hits = None, -1
        for field, mapping in self.field2token_id.items():
            hits = sum(1 for t in sample if t in mapping)
            if hits > best_hits:
                best, best_hits = mapping, hits
        if best is None:
            raise ValueError(f"preload_weight: cannot resolve a vocabulary "
                             f"for {id_field!r}")
        return best

    def get_preload_weight(self, id_field):
        """parity: reference get_preload_weight (dataset.py:1670)."""
        if id_field not in getattr(self, "_preloaded_weight", {}):
            raise ValueError(f"no preloaded weight for field {id_field!r}")
        return self._preloaded_weight[id_field]

    # ------------------------------------------------------------- vocab API

    def num(self, field):
        """Vocabulary size of a token field (parity: dataset.py:937-1000)."""
        if field not in self.field2type:
            raise ValueError(f"field {field} not in dataset")
        t = self.field2type[field]
        if t in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ):
            return len(self.field2id_token[field])
        return 1

    @property
    def user_num(self):
        # pure-feature CTR datasets (e.g. Criteo/Avazu: USER_ID_FIELD: ~) have
        # no user axis; report a PAD-only vocabulary so downstream shapes work
        if self.uid_field is None:
            return 1
        return self.num(self.uid_field)

    @property
    def item_num(self):
        if self.iid_field is None:
            return 1
        return self.num(self.iid_field)

    @property
    def inter_num(self):
        return self._inter_len()

    @property
    def avg_actions_of_users(self):
        return self.inter_num / max(self.user_num - 1, 1)

    @property
    def avg_actions_of_items(self):
        return self.inter_num / max(self.item_num - 1, 1)

    @property
    def sparsity(self):
        return 1 - self.inter_num / ((self.user_num - 1) * (self.item_num - 1))

    def token2id(self, field, tokens):
        mapping = self.field2token_id[field]
        if isinstance(tokens, str):
            return mapping[tokens]
        return np.array([mapping[t] for t in tokens], dtype=np.int32)

    def token2id_exists(self, field, tokens):
        """Unknown tokens map to -1 (fork addition, dataset.py:1060-1079)."""
        mapping = self.field2token_id[field]
        if isinstance(tokens, str):
            return mapping.get(tokens, -1)
        return np.array([mapping.get(t, -1) for t in tokens], dtype=np.int32)

    def id2token(self, field, ids):
        return self.field2id_token[field][ids]

    @property
    def fields(self):
        return list(self.field2type)

    # ------------------------------------------------------- derived matrices

    def inter_matrix(self, form="coo", value_field=None):
        """User-item interaction matrix (parity: dataset.py:1453-1557)."""
        uids = self.inter_feat[self.uid_field]
        iids = self.inter_feat[self.iid_field]
        data = (np.ones(len(uids), dtype=np.float32) if value_field is None
                else self.inter_feat[value_field].astype(np.float32))
        mat = sp.coo_matrix((data, (uids, iids)),
                            shape=(self.user_num, self.item_num))
        if form == "coo":
            return mat
        if form == "csr":
            return mat.tocsr()
        raise ValueError(f"matrix form {form!r} not supported")

    def history_item_matrix(self, max_history_len=None):
        """Dense per-user history (parity: dataset.py:1559-1618).

        Returns (history, lengths): history is (user_num, max_len) int32 padded
        with 0; lengths is (user_num,). This is the device-side used-ids table
        for masked negative-sampling and eval history masking.
        """
        return self._history_matrix(self.inter_feat[self.uid_field],
                                    self.inter_feat[self.iid_field],
                                    self.user_num, max_history_len)

    def history_user_matrix(self, max_history_len=None):
        return self._history_matrix(self.inter_feat[self.iid_field],
                                    self.inter_feat[self.uid_field],
                                    self.item_num, max_history_len)

    @staticmethod
    def _history_matrix(keys, values, num_keys, max_len=None):
        return build_history_matrix(keys, values, num_keys, max_len)

    # ----------------------------------------------------------------- build

    def build(self, eval_setting):
        """Order + split into (train, valid, test) datasets
        (parity: dataset.py:1377-1413)."""
        if self.benchmark_lens is not None:
            cum = np.cumsum([0] + self.benchmark_lens)
            parts = [self._subset(np.arange(cum[i], cum[i + 1]))
                     for i in range(len(self.benchmark_lens))]
            return parts

        ordering = eval_setting.ordering_args
        n = self._inter_len()
        # the ordering is DEFERRED: kept as an index array and composed into
        # the final per-split gathers instead of materializing a reordered
        # copy of every column first. One full-table copy instead of two —
        # at Criteo scale (2.3M rows x 40 columns) the copies are page-fault
        # bound on fresh memory and dominate data_preparation
        order = None
        if ordering["strategy"] == "shuffle":
            order = np.random.permutation(n)
        elif ordering["strategy"] == "by":
            field = ordering["field"]
            if field not in self.inter_feat:
                raise ValueError(
                    f"temporal ordering needs field {field!r} — add it to "
                    f"load_col (e.g. load_col: {{inter: [user_id, item_id, "
                    f"{field}]}})")
            order = np.argsort(self.inter_feat[field], kind="stable")

        split = eval_setting.split_args
        group_field = eval_setting.group_field
        if split["strategy"] == "by_ratio":
            index_parts = self._split_by_ratio(split["ratios"], group_field,
                                               order)
        elif split["strategy"] == "loo":
            if group_field is None:
                raise ValueError("leave-one-out requires grouping")
            index_parts = self._split_leave_one_out(group_field,
                                                    split["leave_one_num"],
                                                    order)
        else:
            raise NotImplementedError(f"split strategy {split['strategy']}")
        parts = []
        for idx in index_parts:
            idx = np.asarray(idx, dtype=np.int64)
            parts.append(self._subset(idx if order is None else order[idx]))
        return parts

    def _grouped_index(self, values):
        order = np.argsort(values, kind="stable")
        sorted_vals = values[order]
        boundaries = np.nonzero(np.diff(sorted_vals))[0] + 1
        return np.split(order, boundaries)

    @staticmethod
    def _calc_split_points(tot, ratios):
        """Reference rounding rule (dataset.py:1258-1279): all parts but the
        first round down; tiny nonzero parts steal one element from part 0."""
        cnt = [int(r * tot) for r in ratios]
        cnt[0] = tot - sum(cnt[1:])
        for i in range(1, len(ratios)):
            if cnt[0] <= 1:
                break
            if 0 < ratios[-i] * tot < 1:
                cnt[-i] += 1
                cnt[0] -= 1
        return np.cumsum(cnt)[:-1]

    def _ordered_group_values(self, group_field, order):
        """Group-field column as seen through the (deferred) ordering."""
        values = self.inter_feat[group_field]
        return values if order is None else values[order]

    def _split_by_ratio(self, ratios, group_field, order=None):
        """Split-part indices are positions in the ORDERED view; build()
        composes them through ``order`` into raw row indices."""
        tot = sum(ratios)
        ratios = [r / tot for r in ratios]
        n = self._inter_len()
        if group_field is None:
            pts = self._calc_split_points(n, ratios)
            return np.split(np.arange(n), pts)
        parts = [[] for _ in ratios]
        for grp in self._grouped_index(
                self._ordered_group_values(group_field, order)):
            pts = self._calc_split_points(len(grp), ratios)
            for part, chunk in zip(parts, np.split(grp, pts)):
                part.extend(chunk.tolist())
        return parts

    def _split_leave_one_out(self, group_field, leave_one_num, order=None):
        parts = [[] for _ in range(leave_one_num + 1)]
        for grp in self._grouped_index(
                self._ordered_group_values(group_field, order)):
            k = min(leave_one_num, len(grp) - 1)
            pr = len(grp) - k
            parts[0].extend(grp[:pr].tolist())
            for i in range(k):
                parts[len(parts) - k + i].append(int(grp[pr + i]))
        return parts

    def _subset(self, index):
        new = self.copy({f: v[index] for f, v in self.inter_feat.items()})
        return new

    def copy(self, new_inter_feat):
        """Shallow copy sharing schema/side-tables, new interactions
        (parity: dataset.py:1218)."""
        new = type(self).__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.inter_feat = new_inter_feat
        return new

    # ------------------------------------------------------------ persistence

    def save(self, filepath):
        os.makedirs(filepath, exist_ok=True)
        with open(os.path.join(filepath, f"{self.dataset_name}-dataset.pkl"), "wb") as fh:
            pickle.dump(self, fh)

    def __len__(self):
        return self._inter_len()

    def __str__(self):
        info = [self.dataset_name]
        try:
            info += [f"The number of users: {self.user_num}",
                     f"Average actions of users: {self.avg_actions_of_users:.4f}",
                     f"The number of items: {self.item_num}",
                     f"Average actions of items: {self.avg_actions_of_items:.4f}",
                     f"The number of inters: {self.inter_num}",
                     f"The sparsity of the dataset: {self.sparsity * 100:.6f}%"]
        except (KeyError, ValueError):
            info.append(f"The number of inters: {self.inter_num}")
        return "\n".join(info)

    __repr__ = __str__
