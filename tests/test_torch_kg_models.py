"""The port's six knowledge models beside RippleNet (CKE, CFKG, KTUP, KGCN,
KGNNLS, MKR) and MKRTrainer against the JAX package's, from the same
weights (``load_jax_params``), the same batches, negatives and KG rows, and
the same Gumbel noise (injected into both): loss parts and gradients, the
KG losses, full-sort and candidate scores, five train steps of each of a
model's modes with the fused Adam, full-sort metrics through each model's
eval path, KGCN's and KGNN-LS's numpy tables (exact), the KTUP and MKR
mode schedules, a resume, the weight carrier and ``run_recbole`` end to
end on the CPU. Tolerances: fp32 rtol 2e-4 of a tensor's largest value,
metrics within 1e-6, tables exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.models.knowledge import kgcn as jax_kgcn
from recbole_tpu.models.knowledge import kgnnls as jax_kgnnls
from recbole_tpu.trainer import trainer as jax_trainer_mod
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.models.base import AbstractRecommender
from recbole_tpu_torch.models.knowledge import kgcn as port_kgcn
from recbole_tpu_torch.models.knowledge import kgnnls as port_kgnnls
from recbole_tpu_torch.trainer import trainer as trainer_mod
from recbole_tpu_torch.trainer.trainer import KGTrainer, MKRTrainer, get_trainer
from recbole_tpu_torch.utils.enums import ModelType
from recbole_tpu_torch.utils.utils import init_seed

RTOL = 2e-4

# (model, config) variants: each model at its defaults and its other
# branches (loss function, Gumbel off, L1, deeper and other aggregators,
# MKR's MLP head and deeper stacks)
VARIANTS = {
    "CKE": ("CKE", {"kg_embedding_size": 8}),
    "CFKG": ("CFKG", {}),
    "CFKG-transe": ("CFKG", {"loss_function": "transe"}),
    "KTUP": ("KTUP", {}),
    "KTUP-soft": ("KTUP", {"use_st_gumbel": False}),
    "KTUP-L1": ("KTUP", {"L1_flag": True}),
    "KGCN": ("KGCN", {}),
    "KGCN-2hop": ("KGCN", {"n_iter": 2}),
    "KGCN-concat": ("KGCN", {"n_iter": 2, "aggregator": "concat"}),
    "KGCN-neighbor": ("KGCN", {"aggregator": "neighbor"}),
    "KGNNLS": ("KGNNLS", {}),
    "KGNNLS-2hop": ("KGNNLS", {"n_iter": 2}),
    "MKR": ("MKR", {}),
    "MKR-mlp": ("MKR", {"use_inner_product": False, "low_layers_num": 2,
                        "high_layers_num": 2}),
}
PAIRWISE = ("CKE", "CFKG", "KTUP")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, ref, what, tol=RTOL, atol=0.0):
    """Within ``tol`` of the tensor's largest |value|, plus ``atol``."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale + atol, (what, err, scale)


def _cfg(tmp_path, data_path, **extra):
    return {"epochs": 2, "train_batch_size": 256, "eval_batch_size": 512,
            "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
            "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
            "embedding_size": 16, "metric_decimal_place": 12, **extra,
            **({"data_path": data_path} if data_path else {})}


def _port(model, tmp_path, data_path, **extra):
    pc = Config(model, "synth", config_dict=_cfg(tmp_path, data_path, **extra),
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    return pc, ploaders, get_model(model)(pc, ploaders[0].dataset)


def _pair(variant, tmp_path, data_path, **more):
    model, extra = VARIANTS[variant]
    extra = {**extra, **more}
    jc = JaxConfig(model, "synth", config_dict=_cfg(tmp_path, data_path, **extra),
                   _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model(model)(jc, jloaders[0].dataset)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    pc, ploaders, pmodel = _port(model, tmp_path, data_path, **extra)
    load_jax_params(pmodel, params)
    return jc, pc, jloaders, ploaders, jmodel, params, pmodel


def _batch(pmodel, loader, seed, n=96):
    """Rec rows with injected negatives (pairwise: a negative item column;
    pointwise: the rows labelled 1, then a negative each labelled 0) and KG
    rows with injected negative tails, as numpy columns."""
    rng = np.random.RandomState(seed)
    cols = loader.columns()
    rows = rng.randint(0, len(cols["user_id"]), n)
    users, items = cols["user_id"][rows], cols["item_id"][rows]
    negs = rng.randint(1, pmodel.n_items, n)
    if pmodel.model_name in PAIRWISE:
        batch = {"user_id": users, "item_id": items, "neg_item_id": negs}
    else:
        batch = {"user_id": np.concatenate([users, users]),
                 "item_id": np.concatenate([items, negs]),
                 "label": np.concatenate([np.ones(n), np.zeros(n)]).astype(np.float32)}
    kg = rng.randint(0, len(loader.kg_columns["head_id"]), n)
    for f, v in loader.kg_columns.items():
        batch[f] = np.asarray(v)[kg]
    batch["neg_tail_id"] = rng.randint(1, pmodel.n_entities, n)
    return {k: (v.astype(np.int64) if k != "label" else v) for k, v in batch.items()}


def _kg_batch(batch):
    return {k: batch[k] for k in ("head_id", "relation_id", "tail_id", "neg_tail_id")}


class _Noise:
    """The Gumbel noise's uniform draws, injected into both packages in
    the order the losses take them (the positives' before the negatives')."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.draws = []

    def jax_uniform(self, key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = self.rng.uniform(1e-10, 1.0, shape).astype(np.float32)
        self.draws.append(u)
        return jnp.asarray(u)

    def port_uniform(self, shape, generator):
        assert generator is not None
        return torch.as_tensor(self.draws.pop(0))


def _loss_methods(model):
    return {"KTUP": ("calculate_loss", "calculate_kg_loss"),
            "MKR": ("calculate_rs_loss", "calculate_kg_loss")}.get(model, ("calculate_loss",))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_parts_and_gradients_match_jax(variant, synth_dataset_dir, tmp_path, monkeypatch):
    """Every loss method's parts at rtol 2e-4 and the gradient of their sum
    for every leaf within 2e-4 of its largest value (plus 1e-10), from the
    same weights and batch (KTUP's noise injected), and predict."""
    _, _, _, ploaders, jmodel, params, pmodel = _pair(variant, tmp_path, synth_dataset_dir)
    batch = _batch(pmodel, ploaders[0], 0)
    noise = _Noise(1)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)
    monkeypatch.setattr(pmodel, "_uniform", noise.port_uniform, raising=False)
    gen = torch.Generator().manual_seed(0)
    for method in _loss_methods(pmodel.model_name):
        b = _kg_batch(batch) if method == "calculate_kg_loss" else batch
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}

        def jloss(p):
            out = getattr(jmodel, method)(p, jbatch, jax.random.key(3))
            parts = out if isinstance(out, tuple) else (out,)
            return sum(parts), parts

        (_, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
        pmodel.zero_grad(set_to_none=True)
        out = getattr(pmodel, method)({k: torch.as_tensor(v) for k, v in b.items()},
                                      generator=gen)
        parts = out if isinstance(out, tuple) else (out,)
        assert len(parts) == len(jparts)
        sum(parts).backward()
        for got, ref in zip(parts, jparts):
            np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL, atol=1e-7)
        ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
        assert set(ref) == set(dict(pmodel.named_parameters()))
        for name, p in pmodel.named_parameters():
            got = np.zeros(ref[name].shape, np.float32) if p.grad is None else p.grad.numpy()
            # atol 1e-10: a leaf whose gradient is zero but for rounding
            # (KGCN's relations when an entity's neighbours share one
            # relation: a softmax over equal scores) holds only noise
            _close(got, ref[name], (method, name), atol=1e-10)
    assert not noise.draws
    rec = {k: batch[k] for k in ("user_id", "item_id")}
    with torch.no_grad():
        got = pmodel.predict({k: torch.as_tensor(v) for k, v in rec.items()})
    _close(got.numpy(), jmodel.predict(params, {k: jnp.asarray(v) for k, v in rec.items()}),
           "predict")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_scores_match_jax(variant, synth_dataset_dir, tmp_path):
    """full_sort_predict where the model has it, and score_items (KGCN's
    and KGNN-LS's pair blocks) on (B, C) candidates, at rtol 2e-4; KGCN's
    dense single-hop full sort and its pair blocks give the same scores."""
    _, _, _, _, jmodel, params, pmodel = _pair(variant, tmp_path, synth_dataset_dir)
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.RandomState(4)
    users = rng.randint(1, pmodel.n_users, 23).astype(np.int64)
    items = rng.randint(1, pmodel.n_items, (23, 37)).astype(np.int64)
    jb, pb = {"user_id": jnp.asarray(users)}, {"user_id": torch.as_tensor(users)}
    if getattr(pmodel, "score_pair_block", None):
        pmodel.score_pair_block = jmodel.score_pair_block = 100
    with torch.no_grad():
        got = pmodel.score_items(pb, torch.as_tensor(items))
        _close(got.numpy(), jmodel.score_items(params, jb, jnp.asarray(items)), "score_items")
        if type(pmodel).full_sort_predict is not AbstractRecommender.full_sort_predict:
            full = pmodel.full_sort_predict(pb)
            _close(full.numpy(), jmodel.full_sort_predict(params, jb), "full_sort_predict")
            assert full.shape == (23, pmodel.n_items)
            if pmodel.model_name in ("KGCN", "KGNNLS") and pmodel.n_iter == 1:
                _close(np.take_along_axis(full.numpy(), items, 1), got.numpy(), "dense vs pairs")


@pytest.mark.parametrize("variant", ["CKE", "CFKG", "CFKG-transe", "KTUP", "KGCN", "KGCN-2hop",
                                     "KGNNLS", "KGNNLS-2hop", "MKR"])
def test_full_sort_metrics_match_jax(variant, synth_dataset_dir, tmp_path):
    """Valid and test metrics from the same weights through each model's
    eval path (CKE, CFKG, KGCN and KGNN-LS at one hop: full_sort_predict;
    KGCN and KGNN-LS at two hops: full_sort_fallback, the chunked
    score_items in pair blocks; KTUP, MKR: the chunked score_items), within
    1e-6 of the JAX trainer's."""
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(variant, tmp_path,
                                                               synth_dataset_dir)
    model = pmodel.model_name
    jcls = jax_trainer_mod.MKRTrainer if model == "MKR" else jax_trainer_mod.KGTrainer
    jtrainer = jcls(jc, jmodel)
    jtrainer.params = jmodel.attach_consts(jax.tree.map(jnp.asarray, params))
    ptrainer = get_trainer(pc["MODEL_TYPE"], model)(pc, pmodel)
    calls = []
    for name in ("full_sort_predict", "score_items"):
        real = getattr(pmodel, name)
        setattr(pmodel, name, (lambda n, f: lambda *a: calls.append(n) or f(*a))(name, real))
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])
    dense = model in ("CKE", "CFKG") or (model in ("KGCN", "KGNNLS") and pmodel.n_iter == 1)
    assert set(calls) == {"full_sort_predict" if dense else "score_items"}
    assert getattr(pmodel, "full_sort_fallback", False) is (model in ("KGCN", "KGNNLS")
                                                            and pmodel.n_iter != 1)


def _modes(model):
    return {"KTUP": ("rs", "kg"), "MKR": ("rs_only_loss", "kg")}.get(model, ("rskg",))


@pytest.mark.parametrize("variant", ["CKE", "CFKG", "CFKG-transe", "KTUP", "KGCN", "KGCN-2hop",
                                     "KGNNLS", "MKR", "MKR-mlp"])
def test_five_steps_of_each_mode_match_jax(variant, synth_dataset_dir, tmp_path, monkeypatch):
    """Five steps of each of the model's train modes in turn (rskg for
    CKE, CFKG, KGCN and KGNN-LS; rs then kg for KTUP; rs_only_loss then kg
    for MKR), on the same batches with injected negatives, KG rows and
    noise, the JAX step core with its fused Adam against the port's: the
    loss at each step and the parameters after each mode at rtol 2e-4 /
    atol 1e-5."""
    jc, pc, _, ploaders, jmodel, params, pmodel = _pair(variant, tmp_path, synth_dataset_dir)
    model = pmodel.model_name
    noise = _Noise(2)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)
    monkeypatch.setattr(pmodel, "_uniform", noise.port_uniform, raising=False)
    jtrainer = jax_trainer_mod.Trainer(jc, jmodel)
    jtrainer._fused_adam = True
    opt_state = jtrainer._fused_adam_init(params)
    ptrainer = trainer_mod.Trainer(pc, pmodel)
    ptrainer.opt_state = ptrainer._fused_adam_init()
    key = jax.random.key(1)
    for m, mode in enumerate(_modes(model)):
        method = {"kg": "calculate_kg_loss", "rs_only_loss": "calculate_rs_loss"}.get(
            mode, "calculate_loss")
        jstep = jtrainer._make_step_core(lambda batch, rng, consts: batch,
                                         getattr(jmodel, method))
        pstep = ptrainer._make_step_core(lambda batch, gen, consts: batch,
                                         getattr(pmodel, method))
        for step in range(5):
            batch = _batch(pmodel, ploaders[0], 10 * m + step)
            if mode == "kg":
                batch = _kg_batch(batch)
            params, opt_state, key, jloss, _ = jstep(
                params, opt_state, key, {k: jnp.asarray(v) for k, v in batch.items()}, {})
            ploss = pstep({k: torch.as_tensor(v) for k, v in batch.items()}, {})
            np.testing.assert_allclose(float(ploss.sum()), float(jloss), rtol=RTOL)
        got = flatten_tree(export_params(pmodel))
        for name, ref in flatten_tree(jax.tree.map(np.asarray, params)).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=1e-5, err_msg=name)
    assert ptrainer.opt_state["count"] == int(opt_state["count"]) == 5 * len(_modes(model))
    assert not noise.draws


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("dataset", ["synth", "ml-100k"])
def test_neighbor_and_label_tables_equal_jax(dataset, synth_dataset_dir, tmp_path):
    """KGCN's sampled neighbour tables and KGNN-LS's negative-label table
    from the same seeds: the same arrays and dtypes; and as the models'
    non-persistent buffers."""
    data_path = synth_dataset_dir if dataset == "synth" else None
    pc = Config("KGNNLS", dataset, config_dict=_cfg(tmp_path, data_path),
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    train = data_preparation(pc, create_dataset(pc))[0].dataset
    h, r, t = train.kg_arrays()
    for S in (4, 8):
        ref = jax_kgcn.build_neighbor_tables(h, r, t, train.entity_num, S, 2020)
        got = port_kgcn.build_neighbor_tables(h, r, t, train.entity_num, S, 2020)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int32
    users = train.inter_feat[train.uid_field]
    items = train.inter_feat[train.iid_field]
    ref = jax_kgnnls.sample_neg_label_table(users, items, train.user_num, train.item_num, 2020)
    got = port_kgnnls.sample_neg_label_table(users, items, train.user_num, train.item_num, 2020)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    model = get_model("KGNNLS")(pc, train)
    ent, rel = jax_kgcn.build_neighbor_tables(h, r, t, train.entity_num, 4, pc["seed"])
    np.testing.assert_array_equal(model.adj_ent.numpy(), ent)
    np.testing.assert_array_equal(model.adj_rel.numpy(), rel)
    np.testing.assert_array_equal(model.neg_hist.numpy(), ref[0])
    assert not {n for n, _ in model.named_buffers()} & set(model.state_dict())


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("steps", [None, (1, 1), (2, 3)])
def test_ktup_mode_schedule_matches_jax(steps, synth_dataset_dir, tmp_path, monkeypatch):
    """KTUP under KGTrainer: the mode of epochs 0-19 at its defaults (5
    rs, 5 kg) and at (train_rec_step, train_kg_step) (1, 1) and (2, 3), as
    the JAX KGTrainer picks them and as the port's epochs run them."""
    extra = {} if steps is None else {"train_rec_step": steps[0], "train_kg_step": steps[1]}
    jc, pc, jloaders, ploaders, jmodel, _, pmodel = _pair("KTUP", tmp_path, synth_dataset_dir,
                                                          **extra)
    seen, ran = [], []
    monkeypatch.setattr(jax_trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode="rs": seen.append(mode))
    monkeypatch.setattr(trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode=None: ran.append(mode) or 0.0)
    jtrainer = jax_trainer_mod.KGTrainer(jc, jmodel)
    ptrainer = get_trainer(pc["MODEL_TYPE"], "KTUP")(pc, pmodel)
    assert type(ptrainer) is KGTrainer
    for epoch in range(20):
        jtrainer._train_epoch(jloaders[0], epoch)
        ptrainer._train_epoch(ploaders[0], epoch)
    assert ran == seen == [ptrainer.epoch_mode(e) for e in range(20)]
    assert ptrainer.default_train_mode == jtrainer.default_train_mode == "rs"
    if steps is None:
        assert seen[:10] == ["rs"] * 5 + ["kg"] * 5


@pytest.mark.parametrize("interval", [None, 2])
def test_mkr_mode_schedule_matches_jax(interval, synth_dataset_dir, tmp_path, monkeypatch):
    """MKRTrainer: rs_only_loss every epoch and kg every kge_interval-th
    (3 by default), epochs 0-9, as the JAX MKRTrainer runs them; the epoch
    reports both parts."""
    extra = {} if interval is None else {"kge_interval": interval}
    jc, pc, jloaders, ploaders, jmodel, _, pmodel = _pair("MKR", tmp_path, synth_dataset_dir,
                                                          **extra)
    seen, ran = [], []
    monkeypatch.setattr(jax_trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode="rs": seen.append((epoch, mode)) or 1.0)
    monkeypatch.setattr(trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode=None: ran.append((epoch, mode)) or 1.0)
    jtrainer = jax_trainer_mod.MKRTrainer(jc, jmodel)
    ptrainer = get_trainer(pc["MODEL_TYPE"], "MKR")(pc, pmodel)
    assert type(ptrainer) is MKRTrainer and ptrainer.kge_interval == (interval or 3)
    for epoch in range(10):
        assert ptrainer._train_epoch(ploaders[0], epoch) == jtrainer._train_epoch(
            jloaders[0], epoch)
    assert ran == seen
    assert [m for e, m in seen if e == 0] == ["rs_only_loss", "kg"]
    assert [m for e, m in seen if e == 1] == ["rs_only_loss"]


@pytest.mark.parametrize("model, extra", [("KTUP", {"train_rec_step": 1, "train_kg_step": 1}),
                                          ("MKR", {"kge_interval": 2})])
def test_resume_keeps_the_mode_schedule(model, extra, synth_dataset_dir, tmp_path):
    """Two epochs, a checkpoint, a resumed trainer for two more: the same
    parameters, moments and loss curve as four epochs straight, both modes
    run on each side of the resume."""
    def trainer(sub, epochs):
        pc, ploaders, pmodel = _port(model, tmp_path / sub, synth_dataset_dir, epochs=epochs,
                                     **extra)
        return get_trainer(pc["MODEL_TYPE"], model)(pc, pmodel), pmodel, ploaders[0]

    straight, smodel, strain = trainer("a", 4)
    straight.fit(strain, None, saved=False, verbose=False)
    first, _, ftrain = trainer("b", 2)
    first.fit(ftrain, None, saved=True, verbose=False)
    resumed, rmodel, rtrain = trainer("c", 4)
    resumed.resume_checkpoint(first.saved_model_file)
    assert resumed.start_epoch == 2
    resumed.fit(rtrain, None, saved=False, verbose=False)
    for name, p in smodel.named_parameters():
        assert torch.equal(p, dict(rmodel.named_parameters())[name]), name
        assert torch.equal(straight.opt_state["mu"][name], resumed.opt_state["mu"][name])
    assert straight.opt_state["count"] == resumed.opt_state["count"]
    assert straight.train_loss_dict == resumed.train_loss_dict
    assert set(straight._modes) == set(resumed._modes) == set(_modes(model))


# --------------------------------------------------------- weights, registry

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_weight_carrier_round_trip_and_init(variant, synth_dataset_dir, tmp_path):
    """convert carries each model's JAX tree across and back (MLP layers,
    KGCN's aggregator lists, MKR's units); the port's own initialiser gives
    the JAX tree's names and shapes (CKE's trans_w at the xavier scale of
    its 2-D (NR, D Dk) shape)."""
    model, extra = VARIANTS[variant]
    _, pc, _, ploaders, _, params, pmodel = _pair(variant, tmp_path, synth_dataset_dir)
    back = flatten_tree(export_params(pmodel))
    ref = flatten_tree(params)
    assert set(back) == set(ref)
    for k in back:
        np.testing.assert_array_equal(back[k], ref[k])
    fresh = get_model(model)(pc, ploaders[0].dataset)
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == {
        k: v.shape for k, v in ref.items()}
    if model == "CKE":
        std = np.sqrt(2.0 / (fresh.n_relations + 16 * 8))
        assert abs(float(fresh.trans_w.detach().std()) - std) < 0.2 * std
    if model == "CFKG":
        assert fresh.relation_embedding.shape[0] == fresh.n_relations + 1
    if model == "MKR":
        assert fresh.item_embedding.shape[0] == fresh.n_entities


@pytest.mark.parametrize("model, cls", [("CKE", KGTrainer), ("CFKG", KGTrainer),
                                        ("KTUP", KGTrainer), ("KGCN", KGTrainer),
                                        ("KGNNLS", KGTrainer), ("MKR", MKRTrainer)])
def test_registry_builds_the_model_and_its_trainer(model, cls):
    assert get_model(model).model_name == model
    assert get_trainer(ModelType.KNOWLEDGE, model) is cls


@pytest.mark.parametrize("model", ["CKE", "CFKG", "KTUP", "KGCN", "KGNNLS", "MKR"])
def test_end_to_end_on_cpu(model, synth_dataset_dir, tmp_path):
    """run_recbole on the synthetic set: the model's trainer and modes, the
    full-sort eval, metrics in [0, 1]; KTUP with train_rec_step and
    train_kg_step 1 so that both modes run in two epochs."""
    extra = {"train_rec_step": 1, "train_kg_step": 1} if model == "KTUP" else {}
    result = run_recbole(model=model, dataset="synth", config_dict=_cfg(
        tmp_path, synth_dataset_dir, **extra), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert set(result["best_valid_result"]) == set(tr)
