"""KGSeqDataset: sequential examples over a dataset with a knowledge graph.

Port of recbole_tpu/data/kg_seq_dataset.py (parity target: the reference's
Kg_Seq_Dataset, recbole/data/dataset/kg_seq_dataset.py:13-22), the diamond
of ``KnowledgeBasedDataset`` and ``SequentialDataset`` that the KG-enhanced
sequential models (GRU4RecKG, KSR) run on. The MRO puts the KG side first,
so the .kg and .link loading and the three-section entity remap run (once,
inside ``Dataset.__init__``), while ``build()`` comes from the sequential
side.
"""

from .kg_dataset import KnowledgeBasedDataset
from .seq_dataset import SequentialDataset


class KGSeqDataset(KnowledgeBasedDataset, SequentialDataset):
    def __init__(self, config, _build=True):
        super().__init__(config, _build)
