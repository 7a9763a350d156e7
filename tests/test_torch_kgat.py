"""KGAT and KGATTrainer of the port against the JAX package's, and the
sorted-edge propagation of ops/edge_prop.py: from the same weights
(``load_jax_params``, the attention carried as a buffer) and the same
batches and negatives, on the dense single-layer path and on the ELL path
of more layers, for the bi, gcn and graphsage aggregators, mess dropout 0:
the attention update, the propagation, both losses and their gradients,
the full sort, five train steps of each mode with the fused Adam, the
full-sort metrics, KGATTrainer's mode order, the checkpoint's attention and
``run_recbole`` end to end on the CPU. Tolerances: fp32 rtol 2e-4 of a
tensor's largest value (the attention's softmax and the propagation's sums
run in another order), metrics within 1e-6; the sorted-edge propagation's
forward at rtol 1e-6 and its gradients at 1e-5 of their largest value (its
``d_x`` is a difference of running sums, which the JAX docstring puts at
about 1e-5 relative)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.ops import edge_prop as jax_edge_prop
from recbole_tpu.trainer import trainer as jax_trainer_mod
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import (export_params, flatten_tree, load_jax_params,
                                       unflatten_tree)
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.ops import edge_prop
from recbole_tpu_torch.trainer import trainer as trainer_mod
from recbole_tpu_torch.trainer.trainer import KGATTrainer, get_trainer
from recbole_tpu_torch.utils.utils import init_seed

RTOL = 2e-4

# the dense single-layer path (the default's one layer) and the ELL path
PATHS = {"dense": [16], "ell": [16, 8]}


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
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    assert err <= tol * scale + atol, (what, err, scale)


# ------------------------------------------------------- sorted-edge prop

def _graph(kind, seed=0):
    """(heads, tails, n_nodes): uniform edges, or power-law heads and tails
    with nodes of no edge and parallel edges."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        n, e = 37, 300
        return rng.randint(0, n, e), rng.randint(0, n, e), n
    n, e = 61, 900
    p = 1.0 / np.arange(1, n + 1) ** 1.2
    p[[5, 17, 40]] = 0.0
    p /= p.sum()
    return rng.choice(n, e, p=p), rng.choice(n, e, p=p[::-1] / p.sum()), n


@pytest.mark.parametrize("kind", ["uniform", "powerlaw"])
def test_sorted_edge_propagate_matches_jax_and_autodiff(kind):
    """Forward, d_x and d_att of the scatter-free op against the JAX
    custom VJP and against autodiff of the plain gather + index_add_ on the
    same head-sorted edges; the tables equal the JAX package's."""
    heads, tails, n = _graph(kind)
    order, consts = edge_prop.build_sorted_edge_consts(heads, tails, n)
    jorder, jconsts = jax_edge_prop.build_sorted_edge_consts(heads, tails, n)
    np.testing.assert_array_equal(order, jorder)
    assert set(consts) == set(jconsts)
    for k in consts:
        np.testing.assert_array_equal(consts[k], jconsts[k], err_msg=k)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    att = rng.uniform(0.1, 1.0, len(heads)).astype(np.float32)
    d_out = rng.standard_normal((n, 8)).astype(np.float32)
    names = ("ep_heads", "ep_tails", "ep_tail_perm", "ep_tstarts", "ep_tends", "ep_hstarts",
             "ep_hends")

    def jf(x, att):
        out = jax_edge_prop.sorted_edge_propagate(x, att, *(jnp.asarray(jconsts[k])
                                                             for k in names))
        return jnp.sum(out * d_out), out

    (_, jout), (jdx, jdatt) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(att))
    tx = torch.tensor(x, requires_grad=True)
    tatt = torch.tensor(att, requires_grad=True)
    out = edge_prop.sorted_edge_propagate(tx, tatt, *(torch.as_tensor(consts[k]) for k in names))
    out.backward(torch.as_tensor(d_out))
    px = torch.tensor(x, requires_grad=True)
    patt = torch.tensor(att, requires_grad=True)
    h, t = torch.as_tensor(consts["ep_heads"]), torch.as_tensor(consts["ep_tails"])
    plain = torch.zeros(n, 8).index_add_(0, h, px[t] * patt[:, None])
    plain.backward(torch.as_tensor(d_out))
    for ref in (np.asarray(jout), plain.detach().numpy()):
        _close(out.detach().numpy(), ref, "forward", tol=1e-6)
    for got, refs, what in ((tx.grad, (jdx, px.grad), "d_x"),
                            (tatt.grad, (jdatt, patt.grad), "d_att")):
        for ref in refs:
            _close(got.numpy(), np.asarray(ref), what, tol=1e-5)
    if kind == "powerlaw":
        # nodes that head no edge, and nodes that tail none
        assert not out[[5, 17, 40]].any() and not tx.grad[[55, 43, 20]].any()


# -------------------------------------------------------------- the model

def _cfg(tmp_path, data_path, **extra):
    return {"epochs": 2, "train_batch_size": 256, "eval_batch_size": 512,
            "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
            "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
            "embedding_size": 16, "kg_embedding_size": 8, "mess_dropout": 0.0,
            "metric_decimal_place": 12, "data_path": data_path, **extra}


def _port(tmp_path, data_path, **extra):
    pc = Config("KGAT", "synth", config_dict=_cfg(tmp_path, data_path, **extra),
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    return pc, ploaders, get_model("KGAT")(pc, ploaders[0].dataset)


def _pair(tmp_path, data_path, path="dense", agg="bi", **extra):
    extra = {"layers": PATHS[path], "aggregator_type": agg, **extra}
    jc = JaxConfig("KGAT", "synth", config_dict=_cfg(tmp_path, data_path, **extra),
                   _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model("KGAT")(jc, jloaders[0].dataset)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    pc, ploaders, pmodel = _port(tmp_path, data_path, **extra)
    assert pmodel.dense_path is jmodel.dense_path is (path == "dense")
    load_jax_params(pmodel, params)
    return jc, pc, jloaders, ploaders, jmodel, params, pmodel


def _jax_update(jmodel, params):
    """The JAX model's attention update on ``params`` (numpy leaves):
    the new params tree, with its dense blocks under ``_const``."""
    full = jmodel.attach_consts(jax.tree.map(jnp.asarray, params))
    with jmodel.bind_consts(jmodel.consts_of(full)):
        return jmodel.update_attentive_A(full)


def _batch(pmodel, loader, seed, n=96):
    """Rec rows with a negative item each, and KG rows with a negative tail
    each, as numpy columns."""
    rng = np.random.RandomState(seed)
    cols = loader.columns()
    rows = rng.randint(0, len(cols["user_id"]), n)
    kg = rng.randint(0, len(loader.kg_columns["head_id"]), n)
    rec = {"user_id": cols["user_id"][rows], "item_id": cols["item_id"][rows],
           "neg_item_id": rng.randint(1, pmodel.n_items, n)}
    kgb = {f: np.asarray(v)[kg] for f, v in loader.kg_columns.items()}
    kgb["neg_tail_id"] = rng.randint(1, pmodel.n_entities, n)
    return ({k: v.astype(np.int64) for k, v in rec.items()},
            {k: v.astype(np.int64) for k, v in kgb.items()})


@pytest.mark.parametrize("agg", ["bi", "gcn", "graphsage"])
@pytest.mark.parametrize("path", ["dense", "ell"])
def test_kgat_matches_jax(path, agg, synth_dataset_dir, tmp_path):
    """From the same weights: update_attentive_A (the attention on every
    unique pair, and the dense blocks), then with that attention the
    propagation, calculate_loss and calculate_kg_loss with the gradient of
    every parameter, predict and full_sort_predict, at rtol 2e-4."""
    _, _, _, ploaders, jmodel, params, pmodel = _pair(tmp_path, synth_dataset_dir, path, agg)
    _close(pmodel.edge_attention.numpy(), params["edge_attention"], "initial attention",
           tol=1e-6)
    jfull = _jax_update(jmodel, params)
    pmodel.update_attentive_A()
    _close(pmodel.edge_attention.numpy(), jfull["edge_attention"], "attention")
    if path == "dense":
        for name in ("att_ui_dense", "att_iu_dense"):
            _close(getattr(pmodel, name).numpy(), jfull["_const"][name], name)
    consts = jmodel.consts_of(jfull)
    jparams = {k: v for k, v in jfull.items() if k != "_const"}
    rec, kg = _batch(pmodel, ploaders[0], 0)
    with torch.no_grad():
        ue, ie = pmodel.propagate()
    with jmodel.bind_consts(consts):
        jue, jie = jmodel.propagate(jparams)
    _close(ue.numpy(), jue, "user rows")
    _close(ie.numpy(), jie, "item rows")
    for method, b in (("calculate_loss", rec), ("calculate_kg_loss", kg)):
        jb = {k: jnp.asarray(v) for k, v in b.items()}

        def jloss(p):
            with jmodel.bind_consts(consts):
                return getattr(jmodel, method)(p, jb, None)

        jl, jgrads = jax.value_and_grad(jloss)(jparams)
        pmodel.zero_grad(set_to_none=True)
        loss = getattr(pmodel, method)({k: torch.as_tensor(v) for k, v in b.items()})
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
        ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
        assert not ref.pop("edge_attention").any()
        for name, p in pmodel.named_parameters():
            got = np.zeros(ref[name].shape, np.float32) if p.grad is None else p.grad.numpy()
            _close(got, ref[name], (method, name), atol=1e-10)
    users = np.random.RandomState(3).randint(1, pmodel.n_users, 23).astype(np.int64)
    with torch.no_grad(), jmodel.bind_consts(consts):
        full = pmodel.full_sort_predict({"user_id": torch.as_tensor(users)})
        _close(full.numpy(), jmodel.full_sort_predict(jparams, {"user_id": jnp.asarray(users)}),
               "full_sort_predict")
        got = pmodel.predict({k: torch.as_tensor(rec[k]) for k in ("user_id", "item_id")})
        _close(got.numpy(), jmodel.predict(jparams, {k: jnp.asarray(rec[k])
                                                    for k in ("user_id", "item_id")}), "predict")


@pytest.mark.parametrize("path", ["dense", "ell"])
def test_five_steps_of_each_mode_and_the_update_match_jax(path, synth_dataset_dir, tmp_path):
    """Five rs steps, five kg steps, then the attention update, twice over,
    on the same batches: the JAX step core with its fused Adam against the
    port's, the losses at each step and every parameter and the attention
    after each round at rtol 2e-4 / atol 1e-5."""
    jc, pc, _, ploaders, jmodel, params, pmodel = _pair(tmp_path, synth_dataset_dir, path)
    jtrainer = jax_trainer_mod.Trainer(jc, jmodel)
    jtrainer._fused_adam = True
    full = jmodel.attach_consts(jax.tree.map(jnp.asarray, params))
    opt_state = jtrainer._fused_adam_init(full)
    ptrainer = trainer_mod.Trainer(pc, pmodel)
    ptrainer.opt_state = ptrainer._fused_adam_init()
    key = jax.random.key(1)
    for rnd in range(2):
        for m, method in enumerate(("calculate_loss", "calculate_kg_loss")):
            jstep = jtrainer._make_step_core(lambda batch, rng, consts: batch,
                                             getattr(jmodel, method))
            pstep = ptrainer._make_step_core(lambda batch, gen, consts: batch,
                                             getattr(pmodel, method))
            for step in range(5):
                b = _batch(pmodel, ploaders[0], 100 * rnd + 10 * m + step)[m]
                full, opt_state, key, jloss, _ = jstep(
                    full, opt_state, key, {k: jnp.asarray(v) for k, v in b.items()}, {})
                ploss = pstep({k: torch.as_tensor(v) for k, v in b.items()}, {})
                np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL)
        with jmodel.bind_consts(jmodel.consts_of(full)):
            full = jmodel.update_attentive_A(full)
        pmodel.update_attentive_A()
        got = flatten_tree(export_params(pmodel))
        for name, ref in flatten_tree(jax.tree.map(
                np.asarray, {k: v for k, v in full.items() if k != "_const"})).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=1e-5, err_msg=name)
    assert ptrainer.opt_state["count"] == int(opt_state["count"]) == 20


def test_full_sort_metrics_match_jax(synth_dataset_dir, tmp_path):
    """Valid and test metrics through the non-fused full-sort step
    (full_sort_predict; KGAT defines no full_sort_query) from the same
    weights and attention, within 1e-6 of the JAX trainer's."""
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(tmp_path, synth_dataset_dir)
    jtrainer = jax_trainer_mod.KGATTrainer(jc, jmodel)
    jtrainer.params = _jax_update(jmodel, params)
    pmodel.update_attentive_A()
    ptrainer = get_trainer(pc["MODEL_TYPE"], "KGAT")(pc, pmodel)
    assert not trainer_mod.fused_full_sort(type(pmodel))
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])


def test_kgat_trainer_mode_order_matches_jax(synth_dataset_dir, tmp_path, monkeypatch):
    """KGATTrainer: every epoch an rs pass, a kg pass, then the attention
    update, as the JAX KGATTrainer runs them; the epoch reports both
    losses."""
    jc, pc, jloaders, ploaders, jmodel, _, pmodel = _pair(tmp_path, synth_dataset_dir)
    seen, ran = [], []
    monkeypatch.setattr(jax_trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode="rs": seen.append((epoch, mode)) or 1.0)
    monkeypatch.setattr(trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode=None: ran.append((epoch, mode)) or 1.0)
    monkeypatch.setattr(pmodel, "update_attentive_A", lambda: ran.append("update"))
    jtrainer = jax_trainer_mod.KGATTrainer(jc, jmodel)
    jtrainer._att_update = lambda p: seen.append("update") or p
    ptrainer = get_trainer(pc["MODEL_TYPE"], "KGAT")(pc, pmodel)
    assert type(ptrainer) is KGATTrainer and ptrainer.default_train_mode == "rs"
    for epoch in range(3):
        assert ptrainer._train_epoch(ploaders[0], epoch) == jtrainer._train_epoch(
            jloaders[0], epoch) == (1.0, 1.0)
    assert ran == seen == [x for e in range(3) for x in ((e, "rs"), (e, "kg"), "update")]


def test_best_checkpoint_carries_the_attention(synth_dataset_dir, tmp_path, monkeypatch):
    """The checkpoint holds the attention beside the parameters, and not
    the dense blocks derived from it: after fit,
    evaluate(load_best_model=True) scores with the best epoch's attention
    and dense blocks, not the last epoch's, and gives what that epoch's
    state gives; a resumed trainer takes them back."""
    pc, ploaders, pmodel = _port(tmp_path, synth_dataset_dir, epochs=3, layers=[16])
    trainer = get_trainer(pc["MODEL_TYPE"], "KGAT")(pc, pmodel)
    saved = []
    real_save = trainer_mod.Trainer._save_checkpoint

    def every_tensor(model):
        return {n: t.detach().clone()
                for n, t in [*model.named_parameters(), *model.named_buffers()]}

    def save(self, epoch):
        saved.append(every_tensor(self.model))
        real_save(self, epoch)

    monkeypatch.setattr(trainer_mod.Trainer, "_save_checkpoint", save)
    # the best epoch is the first: later validations score lower
    scores = iter([0.9, 0.5, 0.4])
    monkeypatch.setattr(trainer_mod, "calculate_valid_score", lambda result, metric: next(scores))
    trainer.fit(ploaders[0], ploaders[1], saved=True, verbose=False)
    assert len(saved) == 1
    state = torch.load(trainer.saved_model_file, map_location="cpu", weights_only=False)
    assert set(state["buffers"]) == {"edge_attention"}
    for name in ("edge_attention", "att_ui_dense", "att_iu_dense"):
        assert not torch.equal(getattr(pmodel, name), saved[0][name]), name
    best = trainer.evaluate(ploaders[2], load_best_model=True)
    for name, t in every_tensor(pmodel).items():
        assert torch.equal(t, saved[0][name]), name
    pc2, ploaders2, fresh = _port(tmp_path / "b", synth_dataset_dir, epochs=3, layers=[16])
    other = get_trainer(pc2["MODEL_TYPE"], "KGAT")(pc2, fresh)
    assert not torch.equal(fresh.edge_attention, saved[0]["edge_attention"])
    other.resume_checkpoint(trainer.saved_model_file)
    for name, t in every_tensor(fresh).items():
        assert torch.equal(t, saved[0][name]), name
    assert other.evaluate(ploaders2[2], load_best_model=False) == best


@pytest.mark.parametrize("path", ["dense", "ell"])
def test_weight_carrier_round_trip_and_init(path, synth_dataset_dir, tmp_path):
    """convert carries KGAT's tree across and back (``agg.<i>.w1`` ...
    ``b2``, and ``edge_attention`` as a buffer); the port's initialiser gives
    the JAX tree's names and shapes, the same initial attention, and
    trans_w at the xavier scale of its 2-D (NR, D Dk) shape."""
    _, pc, _, ploaders, _, params, pmodel = _pair(tmp_path, synth_dataset_dir, path)
    back = flatten_tree(export_params(pmodel))
    ref = flatten_tree(params)
    assert set(back) == set(ref)
    for k in back:
        np.testing.assert_array_equal(back[k], ref[k])
    fresh = get_model("KGAT")(pc, ploaders[0].dataset)
    shapes = {n: tuple(p.shape) for n, p in fresh.named_parameters()}
    shapes["edge_attention"] = tuple(fresh.edge_attention.shape)
    assert shapes == {k: v.shape for k, v in ref.items()}
    _close(fresh.edge_attention.numpy(), params["edge_attention"], "initial attention", tol=1e-6)
    std = np.sqrt(2.0 / (fresh.n_relations + 16 * 8))
    assert abs(float(fresh.trans_w.detach().std()) - std) < 0.2 * std
    assert "edge_attention" not in dict(fresh.named_parameters())
    # the dense blocks are not carried: loading a tree rebuilds them from
    # the attention it holds
    assert set(fresh.state_dict()) == set(ref)
    if path == "dense":
        moved = dict(ref, edge_attention=ref["edge_attention"] * 2.0 + 1.0)
        load_jax_params(fresh, unflatten_tree(moved))
        att = torch.as_tensor(moved["edge_attention"])
        expect = torch.zeros_like(fresh.att_ui_dense)
        expect[fresh.ui_rows, fresh.ui_cols] = att[fresh.ui_sel]
        assert torch.equal(fresh.att_ui_dense, expect)
        expect = torch.zeros_like(fresh.att_iu_dense)
        expect[fresh.iu_rows, fresh.iu_cols] = att[fresh.iu_sel]
        assert torch.equal(fresh.att_iu_dense, expect)


@pytest.mark.parametrize("layers", [[16], [16, 8]])
def test_end_to_end_on_cpu(layers, synth_dataset_dir, tmp_path):
    """run_recbole on the synthetic set under KGATTrainer, both paths: the
    epoch log's two losses, the full-sort eval, metrics in [0, 1]."""
    result = run_recbole(model="KGAT", dataset="synth", config_dict=_cfg(
        tmp_path, synth_dataset_dir, layers=layers, mess_dropout=0.1), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert set(result["best_valid_result"]) == set(tr)
