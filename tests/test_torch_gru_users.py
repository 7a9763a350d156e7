"""The GRU users GRU4RecF, RepeatNet, DIN, DIEN, GRU4RecKG and KSR, and
STAMP and SRGNN, on the port against the JAX package: ``KGSeqDataset``'s
entity remap and splits exactly, each model's ``calculate_loss``, its
gradients and its full-sort / ``score_items`` scores at rtol 2e-4 (fp32,
dropout off, DIEN's negative item sequence handed to both), DIN's and
DIEN's pair blocks with a short last block, the frozen id and user tables
carried by ``convert.py``, the preloaded entity and relation tables, KSR's
relation table through an Adam step, RepeatNet at a row whose history
covers the vocabulary, and ``run_recbole`` for each model on the CPU.
Inputs come from a numpy seed, parameters from the JAX initialisers.
STAMP's and SRGNN's cases run in ``tests/test_torch_seq_tail.py`` through
``check_case`` and ``check_run_recbole``, so that each file stays near two
minutes alone."""

import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.config.eval_setting import EvalSetting as JaxEvalSetting
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.config.eval_setting import EvalSetting
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.kg_dataset import KnowledgeBasedDataset
from recbole_tpu_torch.data.kg_seq_dataset import KGSeqDataset
from recbole_tpu_torch.data.seq_dataset import SequentialDataset
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.trainer.trainer import Trainer, fused_full_sort
from recbole_tpu_torch.utils.utils import init_seed

RTOL = 2e-4
L = 10
COLS = ["user_id", "item_id", "rating", "timestamp"]
ITEMS = {"load_col": {"inter": COLS, "item": "*"}}
USERS = {"load_col": {"inter": COLS, "item": "*", "user": "*"}}
SMALL = {"MAX_ITEM_LIST_LENGTH": L, "embedding_size": 8, "hidden_size": 12,
         "mlp_hidden_size": [16, 8], "dropout_prob": 0.0}
# (model, extra config) of each case
CASES = {
    "GRU4RecF": ("GRU4RecF", ITEMS),
    "GRU4RecF-max-2layers": ("GRU4RecF", {**ITEMS, "pooling_mode": "max", "num_layers": 2,
                                           "selected_features": ["genre"]}),
    "RepeatNet": ("RepeatNet", {}),
    "RepeatNet-joint": ("RepeatNet", {"joint_train": True}),
    "DIN": ("DIN", ITEMS),
    "DIN-weighted": ("DIN", ITEMS),
    "DIEN": ("DIEN", USERS),
    "DIEN-weighted": ("DIEN", USERS),
    "GRU4RecKG": ("GRU4RecKG", {}),
    "GRU4RecKG-trained-kg": ("GRU4RecKG", {"freeze_kg": False}),
    "KSR": ("KSR", {}),
    "KSR-frozen-BPR": ("KSR", {"freeze_kg": True, "loss_type": "BPR",
                               "training_neg_sample_num": 1}),
}
GRU_USERS = ("GRU4RecF", "RepeatNet", "DIN", "DIEN", "GRU4RecKG", "KSR")
NEW_MODELS = GRU_USERS + ("STAMP", "SRGNN")
EXTRA = {"GRU4RecF": ITEMS, "RepeatNet": {}, "DIN": ITEMS, "DIEN": USERS, "GRU4RecKG": {},
         "KSR": {}, "STAMP": {}, "SRGNN": {}}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(tmp_path, data_path, **extra):
    return {"epochs": 1, "train_batch_size": 256, "eval_batch_size": 512,
            "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
            "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
            "data_path": data_path, **SMALL, **extra}


def _jax_model(model, cfg):
    jc = JaxConfig(model, "synth", _parse_cmd_line=False, config_dict=cfg)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    return jax_get_model(model)(jc, jloaders[0].dataset)


def _pair(model, tmp_path, data_path, **extra):
    """Both packages' loaders and models, dropout off; the port loaded with
    the JAX initial weights, 1-D leaves moved off 0 and 1."""
    cfg = _cfg(tmp_path, data_path, **extra)
    jmodel = _jax_model(model, cfg)
    params = jmodel.attach_consts(jmodel.zero_pad_rows(jmodel.init_params(jax.random.key(0))))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda v: (np.asarray(v) + 0.05 * rng.randn(*v.shape)).astype(
        np.float32) if v.ndim <= 1 else np.asarray(v), params)
    pc = Config(model, "synth", config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    pmodel = get_model(model)(pc, ploaders[0].dataset)
    load_jax_params(pmodel, params)
    return jmodel, params, pmodel, ploaders


def _batch(loader, model, case, n=48):
    """The first n train rows; the pointwise CTR models get labels (and
    DIEN its negative item sequence), BPR a negative column, the weighted
    cases a _weight with zeros."""
    cols = {f: v[:n] for f, v in loader.columns().items()}
    rng = np.random.RandomState(7)
    B = len(cols["item_id"])
    if model in ("DIN", "DIEN"):
        cols["label"] = rng.randint(0, 2, B).astype(np.float32)
    if model == "DIEN":
        cols["neg_item_id_list"] = rng.randint(1, 81, cols["item_id_list"].shape)
    if "BPR" in case:
        cols["neg_item_id"] = rng.randint(1, 81, B)
    if "weighted" in case:
        cols["_weight"] = (rng.rand(B) > 0.25).astype(np.float32)
    return cols


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() if np.issubdtype(v.dtype, np.integer)
            else torch.as_tensor(v, dtype=torch.float32) for k, v in batch.items()}


def _grads_close(pmodel, jgrads, tol=RTOL, floor=1e-2):
    ref = flatten_tree(jax.tree.map(np.asarray, {k: v for k, v in jgrads.items()
                                                 if k != "_const"}))
    gscale = max(float(np.abs(v).max()) for v in ref.values())
    names = {n for n, _ in pmodel.named_parameters()}
    assert names == set(ref)
    for name, p in pmodel.named_parameters():
        got = np.zeros_like(ref[name]) if p.grad is None else p.grad.numpy()
        denom = max(float(np.abs(ref[name]).max()), floor * gscale)
        err = float(np.abs(got - ref[name]).max()) / denom
        assert err <= tol, (name, err)


def _close(got, ref, what, tol=RTOL):
    ref = np.asarray(ref)
    assert np.isfinite(ref).all() and np.isfinite(np.asarray(got)).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - ref).max()) / scale
    assert err <= tol, (what, err)


def _jax_loss(jmodel, params, jbatch):
    def loss(p):
        out = jmodel.calculate_loss(p, jbatch, jax.random.key(11))
        return sum(out) if isinstance(out, tuple) else out
    return jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))


# ------------------------------------------------------------- the registry

def test_models_and_datasets_are_registered(synth_dataset_dir, tmp_path):
    """get_model returns the eight; create_dataset builds the KG-sequential
    diamond for GRU4RecKG and KSR (the KG side first in the MRO) and the
    plain sequential dataset for the others; the full-sort route follows
    the JAX trainer's rule: the base stack (GRU4RecF, GRU4RecKG, SRGNN)
    takes the fused masked top-k, a model with its own full_sort_predict
    (RepeatNet, KSR, STAMP) the non-fused step, DIN and DIEN the chunked
    score_items."""
    for name in NEW_MODELS:
        assert get_model(name).__name__ == name
    assert KGSeqDataset.__mro__[1:3] == (KnowledgeBasedDataset, SequentialDataset)
    for name in ("GRU4RecKG", "KSR", "STAMP"):
        pc = Config(name, "synth", config_dict=_cfg(tmp_path, synth_dataset_dir),
                    _parse_cmd_line=False)
        assert type(create_dataset(pc)) is (SequentialDataset if name == "STAMP"
                                            else KGSeqDataset)
    fused = {n: fused_full_sort(get_model(n)) and not getattr(get_model(n),
                                                              "full_sort_fallback", False)
             for n in NEW_MODELS}
    assert fused == {"GRU4RecF": True, "RepeatNet": False, "DIN": False, "DIEN": False,
                     "GRU4RecKG": True, "KSR": False, "STAMP": False, "SRGNN": True}
    assert get_model("DIN").full_sort_fallback and get_model("DIEN").full_sort_fallback


def test_kg_seq_dataset_matches_jax_exactly(synth_dataset_dir, tmp_path, monkeypatch):
    """The diamond against the JAX one: the item, entity and relation
    vocabularies, the remapped triples, and the three splits (users, starts,
    lengths, targets) equal; the entity remap and the sequential build each
    run once."""
    calls = {"remap": 0, "build": 0}
    remap, build = KnowledgeBasedDataset._remap_entities, SequentialDataset.build

    def counted_remap(self):
        calls["remap"] += 1
        return remap(self)

    def counted_build(self, es):
        calls["build"] += 1
        return build(self, es)

    monkeypatch.setattr(KnowledgeBasedDataset, "_remap_entities", counted_remap)
    monkeypatch.setattr(SequentialDataset, "build", counted_build)
    cfg = _cfg(tmp_path, synth_dataset_dir)
    jc = JaxConfig("KSR", "synth", config_dict=cfg, _parse_cmd_line=False)
    pc = Config("KSR", "synth", config_dict=cfg, _parse_cmd_line=False)
    jds, pds = jax_create_dataset(jc), create_dataset(pc)
    assert type(pds) is KGSeqDataset and calls["remap"] == 1
    assert (pds.item_num, pds.entity_num, pds.relation_num) == (
        jds.item_num, jds.entity_num, jds.relation_num)
    for f in (pds.iid_field, pds.entity_field, pds.relation_field, pds.uid_field):
        assert pds.field2token_id[f] == jds.field2token_id[f], f
    for f in (pds.head_field, pds.relation_field, pds.tail_field):
        np.testing.assert_array_equal(np.asarray(pds.kg_feat[f]), np.asarray(jds.kg_feat[f]))
    jsplits, psplits = jds.build(JaxEvalSetting(jc)), pds.build(EvalSetting(pc))
    assert calls["build"] == 1
    for js, ps in zip(jsplits, psplits):
        for attr in ("uid", "start", "length", "target"):
            np.testing.assert_array_equal(np.asarray(getattr(ps, attr)),
                                          np.asarray(getattr(js, attr)), err_msg=attr)
    # the data path attaches the KG stream to the sequential train loader
    train = data_preparation(pc, pds)[0]
    assert len(train.kg_columns[pc["HEAD_ENTITY_ID_FIELD"]]) == pds.kg_num


# ------------------------------------------------------------- the models

@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_scores_match_jax(case, synth_dataset_dir, tmp_path):
    """calculate_loss and every parameter's gradient at rtol 2e-4 (of the
    leaf's largest value, or 1% of the largest gradient); then
    full_sort_predict (where the model has one) and score_items at rtol
    2e-4. DIN's and DIEN's score_items run in pair blocks of 48 over 20
    rows x 7 candidates, so that the last of three blocks is short and
    padded, and in one padded block at their own size."""
    check_case(case, *CASES[case], synth_dataset_dir, tmp_path)


def check_case(case, model, extra, synth_dataset_dir, tmp_path):
    """The body of test_loss_gradients_and_scores_match_jax for one case
    (``case`` names the batch's variant: "BPR", "weighted")."""
    jmodel, params, pmodel, ploaders = _pair(model, tmp_path, synth_dataset_dir, **extra)
    batch = _batch(ploaders[0], model, case)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = _torch_batch(batch)
    jloss, jgrads = _jax_loss(jmodel, params, jbatch)
    out = pmodel.calculate_loss(tbatch)
    loss = sum(out) if isinstance(out, tuple) else out
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    _grads_close(pmodel, jgrads)
    jparams = jax.tree.map(jnp.asarray, params)
    eval_batch = {k: v for k, v in batch.items() if k not in ("_weight", "neg_item_id_list")}
    with torch.no_grad():
        if model not in ("DIN", "DIEN"):
            _close(pmodel.full_sort_predict(_torch_batch(eval_batch)).numpy(),
                   jmodel.full_sort_predict(jparams, {k: jnp.asarray(v)
                                                      for k, v in eval_batch.items()}),
                   "full_sort_predict")
        rows = {k: v[:20] for k, v in eval_batch.items()}
        cand = np.random.RandomState(6).randint(1, pmodel.n_items, (20, 7))
        blocks = [48, pmodel.score_pair_block] if model in ("DIN", "DIEN") else [None]
        for block in blocks:
            if block:
                jmodel.score_pair_block = pmodel.score_pair_block = block
            _close(pmodel.score_items(_torch_batch(rows), torch.as_tensor(cand)).numpy(),
                   jmodel.score_items(jparams, {k: jnp.asarray(v) for k, v in rows.items()},
                                      jnp.asarray(cand)), f"score_items, block {block}")


def test_pair_blocks_pad_the_last_block_as_jax_does(synth_dataset_dir, tmp_path):
    """score_row_pairs keys pairs by sequence row, in blocks of exactly
    ``block`` pairs, the last padded with row 0 and item 0, whose rows take
    part in the batch norm: the scores of a short last block are not those
    of the same pairs scored alone (test_loss_gradients_and_scores_match_jax
    holds them to the JAX package's)."""
    from recbole_tpu_torch.models.sequential.din import score_row_pairs
    _, _, pmodel, ploaders = _pair("DIN", tmp_path, synth_dataset_dir, **ITEMS)
    cols = {k: torch.as_tensor(v[:5]).long() for k, v in ploaders[0].columns().items()}
    items = torch.as_tensor(np.random.RandomState(8).randint(1, 81, (5, 3)))
    seen = []

    def logits(sub, it):
        seen.append((sub["item_id_list"].shape[0], it.tolist()))
        return pmodel._logits(sub, it)

    fields = ("item_id_list", "item_length")
    with torch.no_grad():
        got = score_row_pairs(logits, cols, fields, items, 4)
        alone = pmodel._logits({f: cols[f][torch.tensor([4, 4, 4])] for f in fields}, items[4])
    # 15 pairs: three whole blocks, then row 4's three pairs and one of
    # padding
    assert [n for n, _ in seen] == [4, 4, 4, 4]
    assert seen[-1][1] == items[4].tolist() + [0]
    assert not torch.allclose(got[4], alone)


def test_frozen_tables_round_trip_through_convert(synth_dataset_dir, tmp_path):
    """DIN's and DIEN's frozen id tables (item, and DIEN's user side with
    its feature tables) are persistent buffers that convert.py carries to
    and from the JAX tree's _const, that the checkpoint holds and that no
    optimizer sees; GRU4RecF's feature tables likewise."""
    expect = {"DIN": {"item_embedding", "feat_genre", "feat_price"},
              "DIEN": {"item_embedding", "feat_genre", "feat_price", "user_embedding",
                       "feat_age", "feat_gender", "feat_interests"},
              "GRU4RecF": {"feat_genre", "feat_price"}}
    for model, names in expect.items():
        _, params, pmodel, _ = _pair(model, tmp_path / model, synth_dataset_dir,
                                     **(USERS if model == "DIEN" else ITEMS))
        tree = export_params(pmodel)
        assert set(tree["_const"]) == set(params["_const"]) == names
        for k, v in params["_const"].items():
            np.testing.assert_array_equal(tree["_const"][k], v)
        assert not any("embedder." in n for n, _ in pmodel.named_parameters())
        assert set(Trainer(pmodel.config, pmodel)._state_buffers()) == set(
            pmodel.const_state_map().values())


def test_repeatnet_history_covering_the_vocabulary(synth_dataset_dir, tmp_path):
    """A row whose history holds every item: the explore softmax keeps only
    the [PAD] column finite, so its explore mass lands there, nothing is
    NaN, and the distribution and the loss equal the JAX package's."""
    jmodel, params, pmodel, _ = _pair("RepeatNet", tmp_path, synth_dataset_dir)
    N = pmodel.n_items
    rng = np.random.RandomState(9)
    Ls = N + 3
    seq = np.zeros((3, Ls), np.int64)
    seq[0, :N - 1] = rng.permutation(np.arange(1, N))
    seq[1, :5] = [3, 3, 7, 1, 2]
    seq[2, :N + 2] = np.concatenate([rng.permutation(np.arange(1, N)), [4, 5, 4]])
    batch = {"item_id_list": seq, "item_length": np.array([N - 1, 5, N + 2]),
             "item_id": np.array([5, 9, 4]), "user_id": np.array([1, 2, 3])}
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        prob, gate = pmodel._distribution(_torch_batch(batch))
        loss = pmodel.calculate_loss(_torch_batch(batch))
    jprob, jgate = jmodel._distribution(jparams, jbatch)
    _close(prob.numpy(), jprob, "distribution")
    np.testing.assert_allclose(loss.item(), float(jmodel.calculate_loss(jparams, jbatch)),
                               rtol=RTOL)
    for r in (0, 2):
        np.testing.assert_allclose(prob[r, 0].item(), gate[r, 1].item(), rtol=1e-6)
    np.testing.assert_allclose(prob.sum(1).numpy(), 1.0, rtol=1e-5)


def _write_preload(ds_dir, dim, seed=0):
    """synth.ent (an entity vector a row, the link file's entities and the
    KG-only ones) and synth.rel (a relation vector a row), as
    tests/test_sequential.py:84-111 writes the first."""
    rng = np.random.RandomState(seed)
    with open(f"{ds_dir}/synth.ent", "w") as fh:
        fh.write("ent_id:token\tent_vec:float_seq\n")
        for i in range(1, 101):
            fh.write(f"e{i}\t" + " ".join(f"{v:.4f}" for v in rng.randn(dim)) + "\n")
    with open(f"{ds_dir}/synth.rel", "w") as fh:
        fh.write("rel_id:token\trel_vec:float_seq\n")
        for i in (1, 2, 3, 4):
            fh.write(f"r{i}\t" + " ".join(f"{v:.4f}" for v in rng.randn(dim)) + "\n")


PRELOAD = {"additional_feat_suffix": ["ent", "rel"],
           "preload_weight": {"ent_id": "ent_vec", "rel_id": "rel_vec"},
           "load_col": {"inter": COLS, "ent": ["ent_id", "ent_vec"],
                        "rel": ["rel_id", "rel_vec"]}}


@pytest.mark.parametrize("model", ["GRU4RecKG", "KSR"])
def test_preloaded_kg_tables_match_jax(model, tmp_path):
    """With preload_weight the entity table (and KSR's relation table) is
    the JAX model's initial one exactly (its first rows of the preloaded
    matrix, [PAD] zeroed), and the loss and gradients match; without, a
    warning and a random table of the same shape."""
    from tests.synth_data import make_synthetic_dataset
    root = str(tmp_path / "data")
    ds_dir = make_synthetic_dataset(root, name="synth")
    _write_preload(ds_dir, SMALL["embedding_size"])
    jmodel, params, pmodel, ploaders = _pair(model, tmp_path, root, **PRELOAD)
    state = pmodel.state_dict()
    jinit = jmodel.zero_pad_rows(jmodel.init_params(jax.random.key(0)))
    keys = ["entity_embedding"] + (["relation_embedding"] if model == "KSR" else [])
    for k in keys:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jinit[k]))
    ent = np.asarray(jinit["entity_embedding"])
    assert not np.any(ent[0]) and np.any(ent[1:])
    batch = _batch(ploaders[0], model, model)
    jloss, jgrads = _jax_loss(jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = pmodel.calculate_loss(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    _grads_close(pmodel, jgrads)
    # without the files' weights: random tables and a warning; the level
    # is set here, since a run_recbole earlier in the process leaves the
    # port logger at its config's state
    logger = logging.getLogger("recbole_tpu_torch")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        plain = get_model(model)(pmodel.config, _plain_dataset(model, tmp_path, root))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert any("no preloaded ent_id" in r.getMessage() for r in records)
    assert plain.entity_embedding.shape == pmodel.entity_embedding.shape
    assert not torch.equal(plain.entity_embedding, pmodel.entity_embedding)


def _plain_dataset(model, tmp_path, root):
    pc = Config(model, "synth", config_dict=_cfg(tmp_path / "plain", root),
                _parse_cmd_line=False)
    return data_preparation(pc, create_dataset(pc))[0].dataset


def test_ksr_relation_table_never_trains(synth_dataset_dir, tmp_path):
    """An epoch of Adam steps leaves KSR's relation table bit for bit and
    moves its entity table; with freeze_kg the entity table stays too."""
    for freeze in (False, True):
        cfg = _cfg(tmp_path / str(freeze), synth_dataset_dir, freeze_kg=freeze)
        pc = Config("KSR", "synth", config_dict=cfg, _parse_cmd_line=False)
        init_seed(pc["seed"])
        train = data_preparation(pc, create_dataset(pc))[0]
        model = get_model("KSR")(pc, train.dataset)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        trainer = Trainer(pc, model)
        trainer.prepare(train)
        trainer._train_epoch(train, 0)
        after = dict(model.named_parameters())
        assert torch.equal(after["relation_embedding"], before["relation_embedding"])
        assert torch.equal(after["entity_embedding"], before["entity_embedding"]) is freeze
        assert not torch.equal(after["item_embedding"], before["item_embedding"])
        assert not torch.any(after["item_embedding"][0])


def test_ctr_models_train_on_pointwise_rows_with_labels(synth_dataset_dir, tmp_path):
    """DIN's train augment: the batch's rows labelled 1, then a sampled
    negative a row labelled 0, every other column repeated; DIEN's loss
    reports its two parts and draws its negative sequence from the
    generator, in [1, n_items)."""
    cfg = _cfg(tmp_path, synth_dataset_dir, **USERS)
    for model in ("DIN", "DIEN"):
        pc = Config(model, "synth", config_dict=cfg, _parse_cmd_line=False)
        init_seed(pc["seed"])
        train = data_preparation(pc, create_dataset(pc))[0]
        net = get_model(model)(pc, train.dataset)
        trainer = Trainer(pc, net)
        augment, consts = trainer._make_rec_augment(train)
        batch = {k: torch.as_tensor(v[:16]) for k, v in train.columns().items()}
        out = augment(batch, torch.Generator().manual_seed(0), consts)
        assert out["label"].tolist() == [1.0] * 16 + [0.0] * 16
        assert torch.equal(out["item_id"][:16], batch["item_id"])
        assert torch.equal(out["item_id_list"][16:], batch["item_id_list"])
        parts = net.calculate_loss(out, generator=torch.Generator().manual_seed(1))
        assert isinstance(parts, tuple) == (model == "DIEN")
    neg = net.negative_sequence(out["item_id_list"], torch.Generator().manual_seed(2))
    assert neg.shape == out["item_id_list"].shape
    assert int(neg.min()) >= 1 and int(neg.max()) < net.n_items


# ------------------------------------------------------------- end to end

@pytest.mark.parametrize("model", GRU_USERS)
def test_run_recbole_on_cpu(model, synth_dataset_dir, tmp_path):
    """run_recbole with each model's default dropout on the synthetic set."""
    check_run_recbole(model, synth_dataset_dir, tmp_path)


def check_run_recbole(model, synth_dataset_dir, tmp_path):
    result = run_recbole(model=model, dataset="synth", saved=True, config_dict=_cfg(
        tmp_path, synth_dataset_dir, epochs=2, dropout_prob=get_model(model).default_config.get(
            "dropout_prob", 0.0), **EXTRA[model]))
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert os.listdir(tmp_path / "saved")


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H", [(4096, 50, 40), (4096, 50, 30), (7, 13, 40)])
def test_fp32_gru_at_dien_width_matches_plain_on_card(B, L, H):
    """DIEN's extractor GRU runs the fp32 instance at H = fields x
    embedding size: 40 on the ml-1m item file (4 fields x 10), 30 on a
    3-field file (padded to 32 around the kernels). Forward and backward
    through the dispatcher against the plain version on the same inputs,
    within 1e-4 of each tensor's largest value; one launch each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from recbole_tpu_torch.ops import fused_gru as port_gru
    rng = np.random.RandomState(B + L + H)
    dev = torch.device("cuda")

    def t(a):
        return torch.tensor(a.astype(np.float32), device=dev, requires_grad=True)

    lim = np.sqrt(6.0 / (4 * H))
    leaves = [t(rng.randn(B, L, 3 * H)), t(0.5 * rng.randn(B, H)),
              t(rng.uniform(-lim, lim, (H, 3 * H))), t(0.1 * rng.randn(3 * H))]
    dout = torch.tensor(rng.randn(B, L, H).astype(np.float32), device=dev)
    fwd, bwd = port_gru.fused_gru_fwd_cuda, port_gru.fused_gru_bwd_cuda
    before = (fwd.launches, bwd.launches)
    out = port_gru.fused_gru(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_out = port_gru.fused_gru_torch(*leaves)
    ref = torch.autograd.grad(ref_out, leaves, dout)
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), (out, *got), (ref_out, *ref)):
        a, b = a.detach(), b.detach()
        assert torch.isfinite(a).all(), name
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= 1e-4, (name, err)
