"""The port's knowledge slice against the JAX package's: KnowledgeBasedDataset
and the train loader's KG columns, RippleNet's ripple sets, the relation
apply's plain version against RippleNet's XLA relation loop (and its one-hot
branch) with ``jax.vjp``, RippleNet's three loss parts and gradients, the
pointwise and KG augments, KGTrainer's mode schedule, full-sort metrics
through the chunked ``score_items`` step, the weight carrier, and
``run_recbole`` end to end on the CPU. Inputs come from a numpy seed,
parameters from the JAX initialiser through ``convert``, negatives are
injected into both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.models.knowledge import ripplenet as jax_ripplenet
from recbole_tpu.ops.rel_apply import rel_apply as jax_rel_apply
from recbole_tpu.trainer import trainer as jax_trainer_mod
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.models.knowledge import ripplenet as port_ripplenet
from recbole_tpu_torch.ops import rel_apply as port_rel
from recbole_tpu_torch.trainer import trainer as trainer_mod
from recbole_tpu_torch.trainer.trainer import KGATTrainer, KGTrainer, Trainer, get_trainer
from recbole_tpu_torch.utils.enums import ModelType
from recbole_tpu_torch.utils.utils import init_seed
from tests.synth_data import make_synthetic_dataset

# the bf16 instance against the fp32 loop: largest |difference| over the
# tensor's largest |value|, the bound the JAX kernel's own TPU test holds
# (tests/test_round5_fixes.py:163-195)
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def wide_dataset_dir(tmp_path_factory):
    """A synthetic set with 300 items: more than one 128-item eval chunk."""
    root = tmp_path_factory.mktemp("kgdata")
    make_synthetic_dataset(str(root), name="synth300", n_users=40, n_items=300, n_inter=2000,
                           seed=11)
    return str(root)


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32)).max()) / scale
    assert err <= tol, (what, err)


def _cfg(tmp_path, data_path=None, **extra):
    cfg = {"epochs": 2, "train_batch_size": 256, "eval_batch_size": 512,
           "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
           "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
           "embedding_size": 16, **extra}
    if data_path:
        cfg["data_path"] = data_path
    return cfg


def _both(tmp_path, dataset, data_path, **extra):
    cfg = _cfg(tmp_path, data_path, **extra)
    jc = JaxConfig("RippleNet", dataset, config_dict=cfg, _parse_cmd_line=False)
    pc = Config("RippleNet", dataset, config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    return jc, pc, jloaders, ploaders


def _pair(tmp_path, dataset, data_path, **extra):
    jc, pc, jloaders, ploaders = _both(tmp_path, dataset, data_path, **extra)
    jmodel = jax_get_model("RippleNet")(jc, jloaders[0].dataset)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    pmodel = get_model("RippleNet")(pc, ploaders[0].dataset)
    load_jax_params(pmodel, params)
    return jc, pc, jloaders, ploaders, jmodel, params, pmodel


# ------------------------------------------------------------------ the data

@pytest.mark.parametrize("dataset", ["synth", "ml-100k"])
def test_kg_dataset_and_loader_columns_match_jax(dataset, synth_dataset_dir, tmp_path):
    """Entity and relation ids, kg_arrays, ckg_arrays, entity_num and
    relation_num, and the train loader's KG columns and per-head tails,
    exact."""
    data_path = synth_dataset_dir if dataset == "synth" else None
    _, _, jloaders, ploaders = _both(tmp_path, dataset, data_path)
    jds, pds = jloaders[0].full_dataset, ploaders[0].full_dataset
    assert type(pds).__name__ == "KnowledgeBasedDataset"
    assert (pds.entity_num, pds.relation_num, pds.kg_num) == \
        (jds.entity_num, jds.relation_num, jds.kg_num)
    for f in (pds.entity_field, pds.relation_field, pds.iid_field):
        np.testing.assert_array_equal(pds.field2id_token[f], jds.field2id_token[f])
        assert pds.field2token_id[f] == jds.field2token_id[f]
    assert pds.field2id_token[pds.relation_field][-1] == "[UI-Relation]"
    for a, b in zip(pds.kg_arrays(), jds.kg_arrays()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    for a, b in zip(pds.ckg_arrays(), jds.ckg_arrays()):
        np.testing.assert_array_equal(a, b)
    assert (pds.kg_graph(form="csr") != jds.kg_graph(form="csr")).nnz == 0
    pt, jt = ploaders[0], jloaders[0]
    assert set(pt.kg_columns) == set(jt.kg_columns) and pt.n_entities == jt.n_entities
    for f in jt.kg_columns:
        np.testing.assert_array_equal(pt.kg_columns[f], jt.kg_columns[f])
    for a, b in zip(pt.kg_head_history, jt.kg_head_history):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["synth", "ml-100k"])
def test_build_ripple_sets_matches_jax(dataset, synth_dataset_dir, tmp_path):
    """The same arrays from the same RandomState draws, on the train split;
    and as the model's non-persistent buffers."""
    data_path = synth_dataset_dir if dataset == "synth" else None
    _, pc, _, ploaders = _both(tmp_path, dataset, data_path)
    train = ploaders[0].dataset
    hist, hlen = train.history_item_matrix()
    args = (hist, hlen, *train.kg_arrays(), train.user_num, 2, 16, 2020)
    ref = jax_ripplenet.build_ripple_sets(*args)
    got = port_ripplenet.build_ripple_sets(*args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    model = get_model("RippleNet")(pc, train)
    for name, arr in zip(("rip_h", "rip_r", "rip_t"), ref):
        np.testing.assert_array_equal(getattr(model, name).numpy(), arr)
    assert not {n for n, _ in model.named_buffers()} & set(model.state_dict())


# --------------------------------------------------------- the relation apply

def _loop_model(NR, D):
    """A bare JAX RippleNet whose _rel_apply runs off a TPU: the fp32
    relation loop for NR <= 128, the one-hot product above."""
    m = jax_ripplenet.RippleNet.__new__(jax_ripplenet.RippleNet)
    m.n_relations, m.embedding_size = NR, D
    return m


@pytest.mark.parametrize("NR", [6, 53, 200])
def test_rel_apply_plain_matches_jax_relation_loop(NR):
    """fp32: y, dv and dR of the plain version against RippleNet's XLA
    relation loop (NR <= 128) or one-hot product (NR 200) and its jax.vjp,
    at rtol 2e-4 of each tensor's largest value; the bf16 instance within
    BF16_TOL; rows of relation 0 ([PAD]) included, one relation with no
    rows."""
    rng = np.random.RandomState(NR)
    B, M, D = 12, 32, 16
    rels = rng.randint(0, NR, (B, M)).astype(np.int32)
    rels[rels == 3] = 4
    vecs = rng.randn(B, M, D).astype(np.float32)
    R = (rng.randn(NR, D, D) / np.sqrt(D)).astype(np.float32)
    dy = rng.randn(B, M, D).astype(np.float32)
    jm = _loop_model(NR, D)
    y, vjp = jax.vjp(lambda v, R: jm._rel_apply({"relation_embedding": R}, jnp.asarray(rels), v),
                     jnp.asarray(vecs), jnp.asarray(R))
    dv, dR = vjp(jnp.asarray(dy))
    for bf16, tol in ((False, 2e-4), (True, BF16_TOL)):
        tv = torch.tensor(vecs.reshape(B * M, D), requires_grad=True)
        tR = torch.tensor(R, requires_grad=True)
        out = port_rel.rel_apply(tv, torch.tensor(rels.reshape(-1)), tR, bf16=bf16)
        (out * torch.tensor(dy.reshape(B * M, D))).sum().backward()
        _close(out.detach().numpy().reshape(B, M, D), np.asarray(y), tol, ("y", bf16))
        _close(tv.grad.numpy().reshape(B, M, D), np.asarray(dv), tol, ("dv", bf16))
        _close(tR.grad.numpy(), np.asarray(dR), tol, ("dR", bf16))
        assert float(tR.grad[3].abs().max()) == 0.0
    got_y = port_rel.rel_apply_torch(torch.tensor(vecs.reshape(B * M, D)),
                                     torch.tensor(rels.reshape(-1)), torch.tensor(R))
    ref_dv, ref_dR = port_rel.rel_apply_torch_bwd(
        torch.tensor(vecs.reshape(B * M, D)), torch.tensor(rels.reshape(-1)), torch.tensor(R),
        torch.tensor(dy.reshape(B * M, D)))
    _close(got_y.numpy().reshape(B, M, D), np.asarray(y), 2e-4, "plain y")
    _close(ref_dv.numpy().reshape(B, M, D), np.asarray(dv), 2e-4, "plain dv")
    _close(ref_dR.numpy(), np.asarray(dR), 2e-4, "plain dR")


def test_rel_apply_bf16_plain_matches_pallas_interpret():
    """The bf16 instance's plain version (the kernels' rounding points)
    against the JAX package's Pallas kernel and its custom VJP in interpret
    mode: D 64, NR 53, N 600 (not a multiple of the kernel's 256-row blocks,
    so it pads), relation 9 with no rows. dR (fp32 sums, no final rounding)
    within 1e-5 of its largest value. y and dv round an fp32 sum to bf16 at
    the same point in both, but the sums run in another order, so an element
    whose sum lies next to a rounding boundary can land one bf16 step away
    (1-3 of 38,400 in the draws tried): every element equal or one bf16
    step apart, at most 0.1% of them apart."""
    rng = np.random.RandomState(19)
    N, D, NR = 600, 64, 53
    rels = rng.randint(0, NR, N).astype(np.int32)
    rels[rels == 9] = 10
    vecs = rng.randn(N, D).astype(np.float32)
    R = (rng.randn(NR, D, D) / np.sqrt(D)).astype(np.float32)
    dy = rng.randn(N, D).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda v, R: jax_rel_apply(v, jnp.asarray(rels), R),
                         jnp.asarray(vecs), jnp.asarray(R))
        dv, dR = vjp(jnp.asarray(dy))
    tv, trel, tR = torch.tensor(vecs), torch.tensor(rels), torch.tensor(R)
    got_y = port_rel.rel_apply_torch(tv, trel, tR, bf16=True)
    got_dv, got_dR = port_rel.rel_apply_torch_bwd(tv, trel, tR, torch.tensor(dy), bf16=True)
    for what, got, ref in (("y", got_y.numpy(), np.asarray(y)),
                           ("dv", got_dv.numpy(), np.asarray(dv))):
        step = np.spacing(np.maximum(np.abs(got), np.abs(ref))) * 2.0 ** 16  # bf16's step
        apart = got != ref
        assert np.all(np.abs(got - ref) <= step), what
        assert apart.sum() <= apart.size // 1000, (what, int(apart.sum()))
    _close(got_dR.numpy(), np.asarray(dR), 1e-5, "dR")
    assert float(got_dR[9].abs().max()) == 0.0 and float(np.abs(np.asarray(dR)[9]).max()) == 0.0


def test_rel_apply_dispatch_stays_plain_on_cpu_and_launchers_refuse_it():
    rng = np.random.RandomState(2)
    v = torch.tensor(rng.randn(20, 8).astype(np.float32), requires_grad=True)
    rel = torch.tensor(rng.randint(0, 4, 20))
    R = torch.tensor(rng.randn(3, 8, 8).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        port_rel.rel_apply_fwd_cuda(v.detach(), rel.int(), R)
    with pytest.raises(ValueError, match="CUDA"):
        port_rel.rel_apply_bwd_cuda(v.detach(), rel.int(), R, v.detach())
    before = (port_rel.rel_apply_fwd_cuda.launches, port_rel.rel_apply_bwd_cuda.launches)
    y = port_rel.rel_apply(v, rel, R, bf16=False)
    y.sum().backward()
    y = y.detach()
    assert (port_rel.rel_apply_fwd_cuda.launches,
            port_rel.rel_apply_bwd_cuda.launches) == before
    # relation 3 lies outside [0, NR): zero, as the JAX kernel's pad rows
    out = (rel == 3)
    assert float(y[out].abs().max()) == 0.0 and float(v.grad[out].abs().max()) == 0.0
    assert torch.equal(y, port_rel.rel_apply_torch(v.detach(), rel, R))


# ----------------------------------------------------------------- the model

def _loss_batch(ploader, n_items, rows, seed):
    """A pointwise batch with injected negatives: the rows' positives
    (label 1), then one negative each (label 0)."""
    cols = ploader.columns()
    rng = np.random.RandomState(seed)
    users = cols["user_id"][rows]
    items = np.concatenate([cols["item_id"][rows], rng.randint(1, n_items, len(rows))])
    return {"user_id": np.concatenate([users, users]).astype(np.int64),
            "item_id": items.astype(np.int64),
            "label": np.concatenate([np.ones(len(rows)), np.zeros(len(rows))]).astype(
                np.float32)}


def test_loss_parts_and_gradients_match_jax(synth_dataset_dir, tmp_path):
    """calculate_loss's three parts (BCE, the KG term, the L2 term) at rtol
    2e-4, the gradient of their sum for every leaf at rtol 2e-4 of its
    largest value, and predict, from the same weights and batch."""
    _, _, _, ploaders, jmodel, params, pmodel = _pair(tmp_path, "synth", synth_dataset_dir)
    assert pmodel.compute_dtype == torch.float32 and not pmodel.bf16
    batch = _loss_batch(ploaders[0], pmodel.n_items, np.arange(96), 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        parts = jmodel.calculate_loss(p, jbatch)
        return sum(parts), parts

    (_, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    parts = pmodel.calculate_loss(tbatch)
    assert len(parts) == 3
    sum(parts).backward()
    for got, ref in zip(parts, jparts):
        np.testing.assert_allclose(got.item(), float(ref), rtol=2e-4)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert set(ref) == set(dict(pmodel.named_parameters()))
    for name, p in pmodel.named_parameters():
        _close(p.grad.numpy(), ref[name], 2e-4, name)
    with torch.no_grad():
        _close(pmodel.predict(tbatch).numpy(), np.asarray(jmodel.predict(params, jbatch)),
               2e-4, "predict")


def test_weight_carrier_round_trip_and_init(synth_dataset_dir, tmp_path):
    """convert carries the JAX tree across and back, the 3-D relation
    matrices included; the port's own initialiser gives the JAX tree's
    names and shapes with the xavier scale of the 2-D (NR, D D) shape."""
    _, pc, _, ploaders, _, params, pmodel = _pair(tmp_path, "synth", synth_dataset_dir)
    back = export_params(pmodel)
    assert set(back) == {"entity_embedding", "relation_embedding", "transform"}
    for k in back:
        np.testing.assert_array_equal(back[k], params[k])
    assert back["relation_embedding"].shape == (pmodel.n_relations, 16, 16)
    fresh = get_model("RippleNet")(pc, ploaders[0].dataset)
    rel = fresh.relation_embedding.detach()
    std = np.sqrt(2.0 / (pmodel.n_relations + 256))
    assert abs(float(rel.std()) - std) < 0.2 * std
    assert {n for n, _ in fresh.named_parameters()} == set(back)


def test_unported_knowledge_models_and_trainers_raise():
    """No knowledge model is left: KGAT, the last, resolves (either case)
    with its own trainer, KGATTrainer, as the JAX package's registry gives
    them."""
    for name in ("KGAT", "kgat"):
        assert get_model(name).model_name == "KGAT"
    assert get_trainer(ModelType.KNOWLEDGE, "KGAT") is KGATTrainer
    assert jax_trainer_mod.get_trainer(ModelType.KNOWLEDGE, "KGAT").__name__ == "KGATTrainer"
    for name in ("CKE", "CFKG", "KTUP", "KGCN", "KGNNLS", "MKR"):
        assert get_model(name).model_name == name
    assert get_trainer(ModelType.KNOWLEDGE, "RippleNet") is KGTrainer
    assert get_trainer(ModelType.GENERAL, "BPR") is Trainer


# ------------------------------------------------------------ the augments

def test_pointwise_augment_matches_jax(synth_dataset_dir, tmp_path, monkeypatch):
    """The POINTWISE branch with the same negatives injected into both
    packages: originals with label 1, then k rows of negatives labelled 0,
    every other column repeated; exact."""
    jc, pc, jloaders, ploaders = _both(tmp_path, "synth", synth_dataset_dir,
                                       training_neg_sample_num=2)
    jmodel = jax_get_model("RippleNet")(jc, jloaders[0].dataset)
    pmodel = get_model("RippleNet")(pc, ploaders[0].dataset)
    cols = ploaders[0].columns()
    rows = np.arange(40)
    batch = {f: v[rows] for f, v in cols.items()}
    negs = np.random.RandomState(5).randint(1, pmodel.n_items, (40, 2))
    monkeypatch.setattr(jax_trainer_mod, "sample_negatives",
                        lambda *a, **k: jnp.asarray(negs, jnp.int32))
    monkeypatch.setattr(trainer_mod, "sample_negatives",
                        lambda *a, **k: torch.as_tensor(negs))
    jaug, jconsts = jax_trainer_mod.Trainer(jc, jmodel)._make_rec_augment(jloaders[0])
    paug, pconsts = Trainer(pc, pmodel)._make_rec_augment(ploaders[0])
    jout = jaug({k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0), jconsts)
    pout = paug({k: torch.as_tensor(v) for k, v in batch.items()}, None, pconsts)
    assert set(jout) == set(pout) and "label" in pout
    for k in jout:
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))
    np.testing.assert_array_equal(pout["label"].numpy()[:40], 1.0)
    np.testing.assert_array_equal(pout["item_id"].numpy()[40:], negs.T.reshape(-1))


def test_kg_augment_draws_real_triples_and_excludes_known_tails(synth_dataset_dir, tmp_path):
    """rskg: every added (head, relation, tail) row is a triple of the KG,
    and no negative tail is among its head's known tails; kg: the negative
    tails of the triple batch exclude them too."""
    _, pc, _, ploaders = _both(tmp_path, "synth", synth_dataset_dir)
    pmodel = get_model("RippleNet")(pc, ploaders[0].dataset)
    trainer = Trainer(pc, pmodel)
    train = ploaders[0]
    h, r, t = (train.kg_columns[f] for f in ("head_id", "relation_id", "tail_id"))
    triples = set(zip(h.tolist(), r.tolist(), t.tolist()))
    known = {}
    for hh, tt in zip(h.tolist(), t.tolist()):
        known.setdefault(hh, set()).add(tt)
    gen = torch.Generator().manual_seed(3)
    for include_rec in (True, False):
        aug, consts = trainer._make_kg_augment(train, include_rec)
        if include_rec:
            batch = {"user_id": torch.arange(1, 201), "item_id": torch.ones(200, dtype=torch.long)}
        else:
            batch = {f: torch.as_tensor(np.asarray(v, np.int64)) for f, v in
                     train.kg_columns.items()}
        out = aug(batch, gen, consts)
        rows = list(zip(out["head_id"].tolist(), out["relation_id"].tolist(),
                        out["tail_id"].tolist()))
        assert all(row in triples for row in rows)
        for hh, neg in zip(out["head_id"].tolist(), out["neg_tail_id"].tolist()):
            assert 1 <= neg < train.n_entities and neg not in known[hh]
        if include_rec:
            assert len(rows) == 200 and torch.equal(out["user_id"], batch["user_id"])


@pytest.mark.parametrize("steps", [(None, None), (2, 1), (1, 3)])
def test_kg_trainer_mode_schedule_matches_jax(synth_dataset_dir, tmp_path, monkeypatch, steps):
    """The train mode of epochs 0-9 for unset, (2, 1) and (1, 3)
    (train_rec_step, train_kg_step), exact, and the default mode."""
    extra = {} if steps[0] is None else {"train_rec_step": steps[0], "train_kg_step": steps[1]}
    jc, pc, jloaders, ploaders = _both(tmp_path, "synth", synth_dataset_dir, **extra)
    jmodel = jax_get_model("RippleNet")(jc, jloaders[0].dataset)
    pmodel = get_model("RippleNet")(pc, ploaders[0].dataset)
    seen = []
    monkeypatch.setattr(jax_trainer_mod.Trainer, "_train_epoch",
                        lambda self, data, epoch, mode="rs": seen.append(mode))
    jtrainer = jax_trainer_mod.KGTrainer(jc, jmodel)
    for epoch in range(10):
        jtrainer._train_epoch(jloaders[0], epoch)
    ptrainer = KGTrainer(pc, pmodel)
    assert [ptrainer.epoch_mode(e) for e in range(10)] == seen
    assert ptrainer.default_train_mode == jtrainer.default_train_mode


def test_kg_and_rs_only_modes_build_their_loaders(synth_dataset_dir, tmp_path):
    """The kg mode steps over the KG triples (calculate_kg_loss) and the
    rs_only_loss mode over the rec rows (calculate_rs_loss); a model with
    neither method says so when the mode is built."""
    _, pc, _, ploaders = _both(tmp_path, "synth", synth_dataset_dir)
    pmodel = get_model("RippleNet")(pc, ploaders[0].dataset)
    trainer = Trainer(pc, pmodel)
    trainer.opt_state = trainer._fused_adam_init()
    with pytest.raises(AttributeError, match="calculate_kg_loss"):
        trainer._build_mode(ploaders[0], "kg")
    with pytest.raises(AttributeError, match="calculate_rs_loss"):
        trainer._build_mode(ploaders[0], "rs_only_loss")
    with pytest.raises(ValueError, match="unknown train mode"):
        trainer._build_mode(ploaders[0], "rk")
    calls = []
    pmodel.calculate_kg_loss = lambda batch, generator=None: calls.append(batch) or sum(
        p.sum() for p in pmodel.parameters()) * 0.0
    trainer._modes = {}
    total = trainer._train_epoch(ploaders[0], 0, "kg")
    n_kg = len(ploaders[0].kg_columns["head_id"])
    assert total == 0.0 and sum(b["head_id"].shape[0] for b in calls) == n_kg
    assert all("neg_tail_id" in b and "user_id" not in b for b in calls)


# --------------------------------------------------------------- evaluation

def test_chunked_full_sort_metrics_match_jax(wide_dataset_dir, tmp_path):
    """RippleNet has neither full_sort_query nor full_sort_predict: both
    trainers score it by score_items over chunks of the item axis. With
    eval_pair_bytes set so that a chunk is 128 of the 299 items (three
    chunks, the last wrapping to item 0), valid and test metrics from the
    same weights agree within 1e-6 (the masks and hits exact; NDCG's and
    MRR's fp32 running sums in another order)."""
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(tmp_path, "synth300",
                                                               wide_dataset_dir)
    assert 256 < pmodel.n_items < 384
    for m in (jmodel, pmodel):
        m.eval_pair_bytes = 1 << 40
    jtrainer = jax_trainer_mod.KGTrainer(jc, jmodel)
    jtrainer.params = jmodel.attach_consts(jax.tree.map(jnp.asarray, params))
    ptrainer = KGTrainer(pc, pmodel)
    calls = []
    real = pmodel.score_items
    pmodel.score_items = lambda batch, items: calls.append(items.shape) or real(batch, items)
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])
    assert calls and all(shape[1] == 128 for shape in calls)
    assert len(calls) % 3 == 0


def test_ripplenet_end_to_end_on_cpu(synth_dataset_dir, tmp_path):
    """run_recbole(model="RippleNet") on the synthetic set: KGTrainer, the
    rskg mode every epoch (three loss parts), chunked full-sort eval."""
    result = run_recbole(model="RippleNet", dataset="synth", config_dict=_cfg(
        tmp_path, synth_dataset_dir), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert set(result["best_valid_result"]) == set(tr)


def test_fit_reports_loss_parts(synth_dataset_dir, tmp_path):
    """A tuple loss: each epoch reports the three parts' totals, the loss
    dict keeps their sum, and a second run from the same seed gives the
    same curve."""
    def run():
        _, pc, _, ploaders = _both(tmp_path, "synth", synth_dataset_dir)
        model = get_model("RippleNet")(pc, ploaders[0].dataset)
        trainer = get_trainer(pc["MODEL_TYPE"], "RippleNet")(pc, model)
        trainer.prepare(ploaders[0])
        parts = trainer._train_epoch(ploaders[0], 0)
        trainer.fit(ploaders[0], None, saved=False, verbose=False)
        return parts, trainer.train_loss_dict

    parts, losses = run()
    assert isinstance(parts, tuple) and len(parts) == 3 and parts[1] < 0.0
    assert set(losses) == {0, 1} and all(np.isfinite(v) for v in losses.values())
    assert run() == (parts, losses)
