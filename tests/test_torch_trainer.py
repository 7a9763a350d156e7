"""The port's trainer against the JAX package's: a five-step train
trajectory from the same weights, batches and negatives, full-sort and
value metrics from the same weights, end-to-end smoke runs (BPR, DeepFM),
and checkpoint resume."""

import gc
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.trainer.trainer import Trainer as JaxTrainer
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.trainer.trainer import Trainer, get_trainer, invalid_item_mask
from recbole_tpu_torch.utils.utils import init_seed


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(data_dir, tmp_path, **extra):
    return {"data_path": data_dir, "epochs": 2, "train_batch_size": 256,
            "eval_batch_size": 512, "checkpoint_dir": str(tmp_path / "saved"),
            "log_dir": str(tmp_path / "log"), "state": "ERROR",
            "valid_full_to_uni1000": False, "device": "cpu", **extra}


def _port_pipeline(cfg, model_name="BPR"):
    pc = Config(model_name, "synth", config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    train, valid, test = data_preparation(pc, create_dataset(pc))
    model = get_model(model_name)(pc, train.dataset)
    return Trainer(pc, model), model, train, valid, test


# the CTR protocol on the synthetic dataset (tests/test_context.py:7-19), with
# a token_seq field on each side
CTR = {"threshold": {"rating": 4}, "normalize_all": True,
       "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"],
                    "user": ["user_id", "age", "gender", "interests"],
                    "item": ["item_id", "genre", "price"]}}


def test_five_steps_and_full_sort_metrics_match_jax(synth_dataset_dir, tmp_path):
    """Five steps on identical batches and injected negatives, the JAX step
    core with its fused Adam against the port's: params at rtol 2e-4 /
    atol 1e-5. Then full-sort metrics on the valid and test splits from the
    same (JAX-trained) weights agree within 1e-6."""
    cfg = _cfg(synth_dataset_dir, tmp_path)
    jc = JaxConfig("BPR", "synth", config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jtrain, jvalid, jtest = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model("BPR")(jc, jtrain.dataset)
    jtrainer = JaxTrainer(jc, jmodel)
    params = jmodel.init_params(jax.random.key(0))

    ptrainer, pmodel, ptrain, pvalid, ptest = _port_pipeline(cfg)
    load_jax_params(pmodel, {k: np.asarray(v) for k, v in params.items()})

    jtrainer._fused_adam = True
    opt_state = jtrainer._fused_adam_init(params)
    jstep = jtrainer._make_step_core(lambda batch, rng, consts: batch,
                                     jmodel.calculate_loss)
    ptrainer.opt_state = ptrainer._fused_adam_init()
    pstep = ptrainer._make_step_core(lambda batch, gen, consts: batch,
                                     pmodel.calculate_loss)

    cols = ptrain.columns()
    rng = np.random.RandomState(0)
    key = jax.random.key(1)
    for _ in range(5):
        idx = rng.randint(0, ptrain.n, 256)
        batch = {"user_id": cols["user_id"][idx], "item_id": cols["item_id"][idx],
                 "neg_item_id": rng.randint(1, ptrain.n_items, 256)}
        params, opt_state, key, jloss, _ = jstep(
            params, opt_state, key, {k: jnp.asarray(v) for k, v in batch.items()}, {})
        ploss = pstep({k: torch.as_tensor(v).long() for k, v in batch.items()}, {})
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-4)
    assert ptrainer.opt_state["count"] == int(opt_state["count"]) == 5
    got = export_params(pmodel)
    for name, ref in params.items():
        np.testing.assert_allclose(got[name], np.asarray(ref), rtol=2e-4, atol=1e-5)

    jtrainer.params = params
    load_jax_params(pmodel, {k: np.asarray(v) for k, v in params.items()})
    for jdata, pdata in ((jvalid, pvalid), (jtest, ptest)):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])


def test_invalid_item_mask_matches_jax():
    """The eval mask equals the one the JAX fused eval step builds
    (trainer.py:984-990): [PAD] and each user's history, exactly."""
    rng = np.random.RandomState(0)
    n_users, n_items, H, B = 30, 60, 15, 40
    lens = rng.randint(0, H + 1, n_users)
    hist = np.zeros((n_users, H), np.int64)
    for u in range(n_users):
        hist[u, :lens[u]] = rng.randint(1, n_items, lens[u])   # repeats allowed
    users = rng.randint(0, n_users, B)
    uh = jnp.asarray(hist)[users]
    hvalid = jnp.arange(H)[None, :] < jnp.asarray(lens)[users][:, None]
    ref = jnp.zeros((B, n_items), jnp.int8).at[:, 0].set(1)
    ref = ref.at[jnp.arange(B)[:, None], uh].max(hvalid.astype(jnp.int8))
    got = invalid_item_mask(torch.as_tensor(users), torch.as_tensor(hist),
                            torch.as_tensor(lens), n_items)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", [1, 3])
def test_rec_augment_pairs_each_row_with_k_negatives(synth_dataset_dir, tmp_path, k):
    """The pairwise branch of _make_rec_augment: k = 1 adds a negative
    column; k > 1 repeats each row k times, one negative each. No negative
    lies in the row user's train history."""
    trainer, _, train, _, _ = _port_pipeline(
        _cfg(synth_dataset_dir, tmp_path, training_neg_sample_num=k,
             neg_sampling_resample_rounds=32))
    augment, consts = trainer._make_rec_augment(train)
    cols = train.columns()
    batch = {f: torch.as_tensor(v[:100]).long() for f, v in cols.items()
             if f in ("user_id", "item_id")}
    out = augment(batch, trainer.generator, consts)
    assert out["neg_item_id"].shape == (100 * k,)
    assert torch.equal(out["user_id"], batch["user_id"].repeat_interleave(k))
    hist = train.phase_history.history["train"]
    lens = train.phase_history.hist_len["train"]
    for u, n in zip(out["user_id"].tolist(), out["neg_item_id"].tolist()):
        assert n not in set(hist[u, :lens[u]].tolist())


def test_bpr_end_to_end_on_cpu(synth_dataset_dir, tmp_path):
    """Port twin of tests/test_smoke_bpr.py."""
    result = run_recbole(model="BPR", dataset="synth", config_dict={
        "data_path": synth_dataset_dir, "epochs": 2, "train_batch_size": 512,
        "eval_batch_size": 512, "checkpoint_dir": str(tmp_path / "saved"),
        "log_dir": str(tmp_path / "log"), "state": "ERROR",
        "valid_full_to_uni1000": False, "device": "cpu"}, saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    # with planted structure, 2 epochs of BPR must beat the ~random floor
    assert tr["hit@10"] > 0.05


def test_resume_matches_straight_run(synth_dataset_dir, tmp_path):
    """Two epochs, a checkpoint, a resumed trainer for two more: the same
    parameters, moments and loss curve as four epochs straight."""
    straight, smodel, strain, _, _ = _port_pipeline(
        _cfg(synth_dataset_dir, tmp_path / "a", epochs=4))
    straight.fit(strain, None, saved=False, verbose=False)

    first, _, ftrain, _, _ = _port_pipeline(_cfg(synth_dataset_dir, tmp_path / "b"))
    first.fit(ftrain, None, saved=True, verbose=False)
    resumed, rmodel, rtrain, _, _ = _port_pipeline(
        _cfg(synth_dataset_dir, tmp_path / "c", epochs=4))
    resumed.resume_checkpoint(first.saved_model_file)
    assert resumed.start_epoch == 2
    resumed.fit(rtrain, None, saved=False, verbose=False)

    for name, p in smodel.named_parameters():
        assert torch.equal(p, dict(rmodel.named_parameters())[name]), name
        assert torch.equal(straight.opt_state["mu"][name], resumed.opt_state["mu"][name])
    assert straight.opt_state["count"] == resumed.opt_state["count"]
    assert straight.train_loss_dict == resumed.train_loss_dict


def test_deepfm_five_steps_and_value_metrics_match_jax(synth_dataset_dir, tmp_path):
    """Five DeepFM steps on the same rows (dropout 0, no shuffle), the JAX
    step core with its fused Adam against the port's: loss at rtol 2e-4;
    params at rtol 2e-4 / atol 1e-5, every element of every leaf outside
    the MLP's weight matrices. In those, at least 99.9% of a leaf's elements
    meet that bound and every element is within 1.5e-4, about a seventh of
    one Adam step (lr 1e-3). Read on this test's inputs: the only leaf with
    misses is mlp.2.w, 8 of its 16,384 elements, worst |diff| 7.0e-5; the
    next worst leaf is mlp.1.w at 1.4e-5 with no miss, and every leaf
    outside the MLP is within 1.6e-6. Where a dense-layer gradient element
    is a cancelling sum near zero, Adam's normalised update
    m / (sqrt(v) + eps) turns the two packages' fp32 sum orders into steps
    that differ by a fraction of lr. Then _evaluate_individual on the valid
    and test splits from the same (JAX-trained) weights: AUC and LogLoss
    agree to 4 decimals."""
    cfg = _cfg(synth_dataset_dir, tmp_path, dropout_prob=0.0, **CTR)
    jc = JaxConfig("DeepFM", "synth", config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jtrain, jvalid, jtest = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model("DeepFM")(jc, jtrain.dataset)
    jtrainer = JaxTrainer(jc, jmodel)
    params = jmodel.init_params(jax.random.key(0))

    ptrainer, pmodel, ptrain, pvalid, ptest = _port_pipeline(cfg, "DeepFM")
    assert type(ptrainer) is get_trainer(ptrainer.config["MODEL_TYPE"], "DeepFM")
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))

    jtrainer._fused_adam = True
    opt_state = jtrainer._fused_adam_init(params)
    jaugment, jconsts = jtrainer._make_rec_augment(jtrain)
    jstep = jtrainer._make_step_core(jaugment, jmodel.calculate_loss)
    ptrainer.opt_state = ptrainer._fused_adam_init()
    paugment, pconsts = ptrainer._make_rec_augment(ptrain)
    pstep = ptrainer._make_step_core(paugment, pmodel.calculate_loss)

    cols = ptrain.columns()
    key = jax.random.key(1)
    for step in range(5):
        rows = slice(step * 256, (step + 1) * 256)
        batch = {f: v[rows] for f, v in cols.items()}
        params, opt_state, key, jloss, _ = jstep(
            params, opt_state, key, {f: jnp.asarray(v) for f, v in batch.items()}, jconsts)
        ploss = pstep(ptrainer._take_batch(ptrainer._upload_table(batch), slice(None)), pconsts)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-4)
        assert not pmodel.training      # train mode only inside the step
    got = flatten_tree(export_params(pmodel))
    for name, ref in flatten_tree(jax.tree.map(np.asarray, params)).items():
        diff = np.abs(got[name] - ref)
        within = np.mean(diff <= 1e-5 + 2e-4 * np.abs(ref))
        if name.startswith("mlp.") and name.endswith(".w"):
            assert within >= 0.999, (name, within)
            assert diff.max() <= 1.5e-4, (name, diff.max())
        else:
            assert within == 1.0, (name, diff.max())

    jtrainer.params = params
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))
    for jdata, pdata in ((jvalid, pvalid), (jtest, ptest)):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres) == {"auc", "logloss"}
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-4, (k, jres[k], pres[k])


def test_training_table_is_one_matrix_per_dtype(synth_dataset_dir, tmp_path):
    """The uploaded table holds the id columns in one int64 matrix and the
    float columns in one float32 matrix; a batch gathered from them equals
    the rows of the loader's columns."""
    trainer, _, train, _, _ = _port_pipeline(_cfg(synth_dataset_dir, tmp_path, **CTR), "DeepFM")
    tables = trainer._upload_table(train.columns())
    assert sorted(tuple(m.shape[1:]) + (str(m.dtype),) for _, m in tables) == [
        (2, "torch.float32"), (2, "torch.int64")]
    idx = torch.tensor([5, 0, 17, 5])
    batch = trainer._take_batch(tables, idx)
    assert set(batch) == set(train.columns())
    for f, v in train.columns().items():
        np.testing.assert_array_equal(batch[f].numpy(), v[idx.numpy()].astype(batch[f].numpy().dtype))


def test_evaluate_individual_batches_do_not_change_the_result(synth_dataset_dir, tmp_path):
    """One batch over the whole split or ragged batches of 37 rows: the same
    predictions reach the metrics."""
    trainer, _, _, valid, _ = _port_pipeline(
        _cfg(synth_dataset_dir, tmp_path, **CTR), "DeepFM")
    whole = trainer.evaluate(valid, load_best_model=False)
    assert valid.batch_size >= 65536 and len(valid) == 1
    valid.batch_size = 37
    assert trainer.evaluate(valid, load_best_model=False) == whole


def test_eval_loader_keeps_no_trainer_alive(synth_dataset_dir, tmp_path):
    """The value-metric pass keeps its uploaded table with the loader, keyed
    on the device: a second trainer on the same loader reuses the upload,
    and once the first trainer and its model are dropped, nothing holds
    them."""
    cfg = _cfg(synth_dataset_dir, tmp_path, **CTR)
    trainer, model, _, valid, _ = _port_pipeline(cfg, "DeepFM")
    first = trainer.evaluate(valid, load_best_model=False)
    upload = valid._individual_cache[1]
    dead_trainer, dead_model = weakref.ref(trainer), weakref.ref(model)
    del trainer, model
    gc.collect()
    assert dead_trainer() is None and dead_model() is None
    pc = Config("DeepFM", "synth", config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    again = Trainer(pc, get_model("DeepFM")(pc, valid.dataset))
    assert again.evaluate(valid, load_best_model=False) == first
    assert valid._individual_cache[1] is upload


@pytest.mark.parametrize("model", ["DeepFM", "FM", "LR"])
def test_ctr_end_to_end_on_cpu(model, synth_dataset_dir, tmp_path):
    """Port twin of tests/test_context.py::test_ctr_model_smoke."""
    result = run_recbole(model=model, dataset="synth", config_dict=_cfg(
        synth_dataset_dir, tmp_path, **CTR), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"auc", "logloss"}
    assert 0.0 <= tr["auc"] <= 1.0 and tr["logloss"] > 0.0
    assert set(result["best_valid_result"]) == {"auc", "logloss"}
    assert result["valid_score_bigger"] is True


def test_pointwise_training_with_sampled_negatives_still_raises(synth_dataset_dir, tmp_path):
    """Pointwise training with sampled negatives is ported: each row, then
    its negative labelled 0, drawn outside the user's train items; every
    other column repeated."""
    trainer, _, train, _, _ = _port_pipeline(
        _cfg(synth_dataset_dir, tmp_path, training_neg_sample_num=1, **CTR), "DeepFM")
    augment, consts = trainer._make_rec_augment(train)
    cols = train.columns()
    batch = {f: torch.as_tensor(v[:50]) for f, v in cols.items()}
    out = augment(batch, trainer.generator, consts)
    assert set(out) == set(batch)
    assert torch.equal(out["label"][:50], batch["label"]) and not out["label"][50:].any()
    assert torch.equal(out["user_id"], batch["user_id"].repeat(2))
    hist, hlen = consts["hist"], consts["hlen"]
    for u, i in zip(out["user_id"][50:].tolist(), out["item_id"][50:].tolist()):
        assert i not in hist[u, :hlen[u]].tolist()


def test_deepfm_without_device_cpu_raises_where_there_is_no_card(synth_dataset_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg(synth_dataset_dir, tmp_path, **CTR)
    del cfg["device"]
    with pytest.raises(RuntimeError, match="CUDA"):
        run_recbole(model="DeepFM", dataset="synth", config_dict=cfg)


def test_deepfm_resume_matches_straight_run(synth_dataset_dir, tmp_path):
    """With dropout on: the checkpoint carries the generator state, so two
    epochs, a checkpoint and two more equal four epochs straight."""
    def cfg(sub, **extra):
        return _cfg(synth_dataset_dir, tmp_path / sub, **CTR, **extra)
    straight, smodel, strain, _, _ = _port_pipeline(cfg("a", epochs=4), "DeepFM")
    assert smodel.mlp.dropout == 0.2
    straight.fit(strain, None, saved=False, verbose=False)

    first, _, ftrain, _, _ = _port_pipeline(cfg("b"), "DeepFM")
    first.fit(ftrain, None, saved=True, verbose=False)
    resumed, rmodel, rtrain, _, _ = _port_pipeline(cfg("c", epochs=4), "DeepFM")
    resumed.resume_checkpoint(first.saved_model_file)
    resumed.fit(rtrain, None, saved=False, verbose=False)

    for name, p in smodel.named_parameters():
        assert torch.equal(p, dict(rmodel.named_parameters())[name]), name
        assert torch.equal(straight.opt_state["nu"][name], resumed.opt_state["nu"][name])
    assert straight.train_loss_dict == resumed.train_loss_dict
