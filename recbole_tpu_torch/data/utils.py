"""Dataset/dataloader assembly.

Port of recbole_tpu/data/utils.py (:44-178) for the general, context,
sequential and knowledge model families: ``create_dataset`` and
``data_preparation``, including the pure-feature CTR case (``USER_ID_FIELD:
~``), the value-metric ``RowEvalLoader``, the knowledge family's KG columns
on the train loader and the fork's validation override. When the protocol
is full-sort and no benchmark split files are given,
``valid_full_to_uni1000`` downgrades VALIDATION to uniform-1000 sampled
ranking (reference data/utils.py:84-88). Sampled protocols (uni<k>/pop<k>)
get the sampled loaders, general and sequential, and
``eval_use_dataset_negatives`` the dataset-negative loader. A model may
name its own Dataset class (``DATASET_REGISTRY``: GRU4RecKG and KSR run on
the KG-sequential diamond); the social dataset is not ported yet and raises.
"""

import numpy as np

from .dataset import Dataset, build_history_matrix
from .loaders import (TrainLoader, FullSortEvalLoader, SampledEvalLoader,
                      DatasetNegEvalLoader, RowEvalLoader, SequentialTrainLoader,
                      SequentialEvalLoader, SequentialSampledEvalLoader)
from ..config.eval_setting import EvalSetting
from ..sampler.sampler import PhaseHistory
from ..utils.enums import ModelType, EvaluatorType
from ..utils.logger import get_logger


# name-keyed Dataset overrides: <Model> -> Dataset subclass (parity:
# data/utils.py:21-41; the reference's customized_dataset.py:17-26)
DATASET_REGISTRY = {}


def register_dataset(model_name):
    def deco(cls):
        DATASET_REGISTRY[model_name] = cls
        return cls
    return deco


def _register_builtin_datasets():
    from .kg_seq_dataset import KGSeqDataset
    # the KG-enhanced sequential models run on the diamond dataset
    DATASET_REGISTRY.setdefault("GRU4RecKG", KGSeqDataset)
    DATASET_REGISTRY.setdefault("KSR", KGSeqDataset)


def create_dataset(config):
    """The Dataset subclass: the model-name registry first, then the model's
    family (parity: data/utils.py:44-60). The social dataset is not ported
    yet."""
    model_type = config["MODEL_TYPE"]
    _register_builtin_datasets()
    if config["model"] in DATASET_REGISTRY:
        return DATASET_REGISTRY[config["model"]](config)
    if model_type is ModelType.SEQUENTIAL:
        from .seq_dataset import SequentialDataset
        return SequentialDataset(config)
    if model_type is ModelType.KNOWLEDGE:
        from .kg_dataset import KnowledgeBasedDataset
        return KnowledgeBasedDataset(config)
    if model_type not in (ModelType.GENERAL, ModelType.CONTEXT):
        raise NotImplementedError(
            f"{model_type} datasets are not ported yet (ROADMAP Queue 1)")
    return Dataset(config)


def data_preparation(config, dataset):
    """Split + wrap into (train, valid, test) loaders."""
    logger = get_logger()
    es = EvalSetting(config)
    built = dataset.build(es)
    if len(built) != 3:
        raise ValueError(f"expected 3 splits, got {len(built)}")
    train_ds, valid_ds, test_ds = built
    logger.info("split sizes: train=%d valid=%d test=%d",
                len(train_ds), len(valid_ds), len(test_ds))

    uid_f, iid_f = dataset.uid_field, dataset.iid_field
    sequential = hasattr(train_ds, "item_stream")
    # pure-feature CTR datasets (Criteo/Avazu style: USER_ID_FIELD: ~) carry no
    # user/item ids; ranking history tables degenerate to empty
    has_ui = sequential or (uid_f in train_ds.inter_feat
                            and iid_f in train_ds.inter_feat)
    splits = {}
    for phase, ds in (("train", train_ds), ("valid", valid_ds), ("test", test_ds)):
        if sequential:
            splits[phase] = (np.asarray(ds.uid), np.asarray(ds.target))
        elif has_ui:
            splits[phase] = (np.asarray(ds.inter_feat[uid_f]),
                             np.asarray(ds.inter_feat[iid_f]))
        else:
            splits[phase] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    phase_history = PhaseHistory(dataset.user_num, dataset.item_num, splits)

    if sequential:
        train_loader = SequentialTrainLoader(config, train_ds)
    else:
        train_loader = TrainLoader(config, train_ds)
    _attach(train_loader, dataset, train_ds, phase_history, "train", "train")

    if getattr(dataset, "kg_feat", None) is not None:
        # the KG stream of the knowledge family's train modes: the triples'
        # columns and each head's known tails, which negative tails exclude
        # (parity: data/utils.py:100-113)
        h, r, t = dataset.kg_arrays()
        train_loader.kg_columns = {
            config["HEAD_ENTITY_ID_FIELD"]: h,
            config["RELATION_ID_FIELD"]: r,
            config["TAIL_ENTITY_ID_FIELD"]: t,
        }
        train_loader.kg_head_history = build_history_matrix(h, t, dataset.entity_num)
        train_loader.n_entities = dataset.entity_num

    neg = es.neg_sample_args
    valid_neg = dict(neg)
    if neg["strategy"] == "full" and config["valid_full_to_uni1000"] \
            and not config["benchmark_filename"]:
        logger.info("validation protocol downgraded to uniform-1000 sampled "
                    "ranking (fork behavior; disable with "
                    "valid_full_to_uni1000: False)")
        valid_neg = {"strategy": "by", "by": 1000, "distribution": "uniform"}

    valid_loader = _make_eval_loader(config, valid_ds, dataset, valid_neg, sequential)
    _attach(valid_loader, dataset, valid_ds, phase_history, "train", "valid")
    test_loader = _make_eval_loader(config, test_ds, dataset, neg, sequential)
    _attach(test_loader, dataset, test_ds, phase_history, "valid", "test")
    return train_loader, valid_loader, test_loader


def _make_eval_loader(config, split_ds, full_ds, neg_args, sequential=False):
    if config["eval_type"] is EvaluatorType.INDIVIDUAL:
        if sequential:
            raise NotImplementedError(
                "value metrics (AUC/LogLoss/MAE/RMSE) over sequential splits are "
                "not supported: use ranking metrics (the reference has no such "
                "protocol either)")
        return RowEvalLoader(config, split_ds)
    if config["eval_use_dataset_negatives"] and not sequential:
        return DatasetNegEvalLoader(config, split_ds, full_ds.item_num)
    if sequential:
        if neg_args["strategy"] == "full":
            return SequentialEvalLoader(config, split_ds, full_ds.item_num)
        if neg_args["strategy"] == "by":
            return SequentialSampledEvalLoader(config, split_ds, full_ds.item_num,
                                               neg_args)
        raise NotImplementedError(f"eval neg strategy {neg_args['strategy']!r}")
    if neg_args["strategy"] == "full":
        return FullSortEvalLoader(config, split_ds, full_ds.item_num)
    if neg_args["strategy"] == "by":
        return SampledEvalLoader(config, split_ds, full_ds.item_num, neg_args)
    raise NotImplementedError(f"eval neg strategy {neg_args['strategy']!r}")


def _attach(loader, full_ds, split_ds, phase_history, mask_phase, sample_phase):
    """Give loaders what the steps need: vocab sizes, the split dataset,
    and phase-aware history tables (mask_phase = phases whose positives must be
    -inf'd in full-sort scores; sample_phase = phases excluded when sampling
    eval negatives — cumulative through the current phase, sampler.py:206-227)."""
    loader.full_dataset = full_ds
    loader.dataset = split_ds
    loader.phase_history = phase_history
    loader.n_users = full_ds.user_num
    loader.n_items = full_ds.item_num
    loader.mask_phase = mask_phase
    loader.sample_phase = sample_phase
