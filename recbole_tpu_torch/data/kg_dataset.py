"""KnowledgeBasedDataset: KG triples + item-entity linkage.

Port of recbole_tpu/data/kg_dataset.py (parity target: reference
KnowledgeBasedDataset, recbole/data/dataset/kg_dataset.py:28-561). It loads
<ds>.kg (head_id, relation_id, tail_id) and <ds>.link (item_id, entity_id);
entities are remapped TOGETHER with item ids in three consecutive sections:

    [0]                  [PAD]
    [1 .. n_items-1]     items (linked entities share their item's id)
    [n_items .. n_ent-1] kg-only entities

Relations get their own id space, in first-occurrence order between [PAD]
and a trailing [UI-Relation] token (which collaborative-KG models use to
label user-item edges). numpy throughout, as the rest of the data layer.
"""

import os

import numpy as np

from .atomic import read_atomic_file, atomic_path
from .dataset import Dataset, PAD_TOKEN
from ..utils.enums import FeatureType, FeatureSource


class KnowledgeBasedDataset(Dataset):
    UI_RELATION = "[UI-Relation]"

    def __init__(self, config, _build=True):
        self.head_field = config["HEAD_ENTITY_ID_FIELD"]
        self.tail_field = config["TAIL_ENTITY_ID_FIELD"]
        self.relation_field = config["RELATION_ID_FIELD"]
        self.entity_field = config["ENTITY_ID_FIELD"]
        self.kg_feat = None
        self.link_items = None
        self.link_entities = None
        super().__init__(config, _build)

    # ------------------------------------------------------------------ load

    def _load_all(self):
        super()._load_all()
        self._load_kg()
        self._load_link()

    def _load_kg(self):
        path = atomic_path(self.config["data_path"], self.dataset_name, "kg")
        if not os.path.isfile(path):
            raise ValueError(f"knowledge-based models need {path}")
        cols, types = read_atomic_file(path, self.config["field_separator"],
                                       self.config["seq_separator"])
        for f in (self.head_field, self.tail_field, self.relation_field):
            if f not in cols:
                raise ValueError(f".kg file must contain {f}")
        self.kg_feat = cols
        self._merge_schema(types, FeatureSource.KG)

    def _load_link(self):
        path = atomic_path(self.config["data_path"], self.dataset_name, "link")
        if not os.path.isfile(path):
            raise ValueError(f"knowledge-based models need {path}")
        cols, _ = read_atomic_file(path, self.config["field_separator"],
                                   self.config["seq_separator"])
        self.link_items = cols[self.iid_field]
        self.link_entities = cols[self.entity_field]

    # ----------------------------------------------------------------- remap

    def _remap_ids(self):
        super()._remap_ids()
        self._remap_entities()

    def _remap_entities(self):
        """Entities share the item id space via .link; kg-only entities extend
        it in first-occurrence order over heads then tails (parity:
        kg_dataset.py:264-398)."""
        item2id = self.field2token_id[self.iid_field]
        ent2id = {}
        for item_tok, ent_tok in zip(self.link_items, self.link_entities):
            iid = item2id.get(str(item_tok))
            if iid is not None:
                ent2id[str(ent_tok)] = iid

        n_items = len(self.field2id_token[self.iid_field])
        next_id = n_items
        heads = self.kg_feat[self.head_field]
        tails = self.kg_feat[self.tail_field]
        for tok in np.concatenate([heads, tails]):
            tok = str(tok)
            if tok not in ent2id:
                ent2id[tok] = next_id
                next_id += 1

        id2ent = np.empty(next_id, dtype=object)
        id2ent[:] = PAD_TOKEN
        id2ent[:n_items] = self.field2id_token[self.iid_field]
        for tok, eid in ent2id.items():
            if eid >= n_items:
                id2ent[eid] = tok
        self.kg_feat[self.head_field] = np.array([ent2id[str(t)] for t in heads], np.int32)
        self.kg_feat[self.tail_field] = np.array([ent2id[str(t)] for t in tails], np.int32)
        self.field2id_token[self.entity_field] = id2ent
        self.field2token_id[self.entity_field] = ent2id
        self.field2type[self.entity_field] = FeatureType.TOKEN
        self.field2source[self.entity_field] = FeatureSource.KG

        # relations: ids in first-occurrence order (the reference's
        # pd.factorize; np.unique's sorted order would permute them), then
        # the trailing [UI-Relation]
        vt = self.kg_feat[self.relation_field].astype(str)
        uniq, codes = np.unique(vt, return_inverse=True)
        first_pos = np.full(len(uniq), len(vt), dtype=np.int64)
        np.minimum.at(first_pos, codes, np.arange(len(vt)))
        order = np.argsort(first_pos, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        id2rel = np.concatenate([[PAD_TOKEN], uniq[order], [self.UI_RELATION]])
        self.kg_feat[self.relation_field] = (rank[codes] + 1).astype(np.int32)
        self.field2id_token[self.relation_field] = id2rel
        self.field2token_id[self.relation_field] = {t: i for i, t in enumerate(id2rel)}
        self.field2type[self.relation_field] = FeatureType.TOKEN
        self.field2source[self.relation_field] = FeatureSource.KG

    # ------------------------------------------------------------------ stats

    @property
    def entity_num(self):
        return len(self.field2id_token[self.entity_field])

    @property
    def relation_num(self):
        return len(self.field2id_token[self.relation_field])

    @property
    def kg_num(self):
        return len(self.kg_feat[self.head_field])

    def kg_arrays(self):
        """(heads, relations, tails) int32 arrays."""
        return (self.kg_feat[self.head_field],
                self.kg_feat[self.relation_field],
                self.kg_feat[self.tail_field])

    def kg_graph(self, form="coo", value_field=None):
        """The (entity_num, entity_num) head -> tail matrix, valued by the
        relation id when ``value_field`` is given, else by 1."""
        import scipy.sparse as sp
        h, r, t = self.kg_arrays()
        data = r.astype(np.float32) if value_field else np.ones(len(h), np.float32)
        mat = sp.coo_matrix((data, (h, t)), shape=(self.entity_num, self.entity_num))
        return mat.tocsr() if form == "csr" else mat

    def ckg_arrays(self):
        """Collaborative KG edges: the kg triples, then the interactions both
        ways, labelled by the trailing [UI-Relation] id. Users come AFTER the
        entities: the node of user u is entity_num + u (parity: ckg_graph,
        kg_dataset.py:455-530)."""
        h, r, t = self.kg_arrays()
        uids = np.asarray(self.inter_feat[self.uid_field]) + self.entity_num
        iids = np.asarray(self.inter_feat[self.iid_field])
        ui_rel = np.full(len(uids), self.relation_num - 1, np.int32)
        heads = np.concatenate([h, uids, iids]).astype(np.int32)
        rels = np.concatenate([r, ui_rel, ui_rel]).astype(np.int32)
        tails = np.concatenate([t, iids, uids]).astype(np.int32)
        return heads, rels, tails

    def __str__(self):
        return (f"{super().__str__()}\nThe number of entities: {self.entity_num}"
                f"\nThe number of relations: {self.relation_num}"
                f"\nThe number of triples: {self.kg_num}")
