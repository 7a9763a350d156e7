"""The port's learners, gradient clipping, bfloat16 eval scores and GAUC
against the JAX package: each learner's steps (sgd, adagrad, rmsprop, adam,
adamw and sparse_adam, with and without clip_grad_norm on both sides of
max_norm and with coupled weight decay) against the JAX package's optax
chain (``build_optimizer``) at fp32 rtol 2e-4; lazy_adam's untouched rows
bit for bit; ``gauc_metric_sums`` with ties against the JAX function; the
trainer's GAUC on the full-sort, sampled and labeled protocols; the bf16
fused and non-fused eval steps' top-k ids against the JAX steps' where the
k-th and (k+1)-th scores are apart; and ``run_recbole`` with each."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from recbole_tpu.evaluator.evaluator import gauc_metric_sums as jax_gauc
from recbole_tpu.ops.masked_topk import masked_topk_xla
from recbole_tpu.trainer import trainer as jax_trainer_mod
from recbole_tpu.trainer.lazy_adam import lazy_adam as jax_lazy_adam
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.evaluator.evaluator import TopKCollector, gauc_metric_sums
from recbole_tpu_torch.ops.masked_topk import masked_topk
from recbole_tpu_torch.trainer.lazy_adam import lazy_adam_step
from recbole_tpu_torch.trainer.trainer import (Trainer, bf16_parameters, build_optimizer,
                                               get_trainer)
from tests.test_torch_protocols import (LABELED, _inject, _jax_eval_draws, _pair,
                                        _same_metrics)

RTOL = 2e-4
LR = 1e-3
SHAPES = {"pad": (20, 8), "table": (12, 4), "none": (7,), "scalar": ()}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Leaves(nn.Module):
    """Four leaves: a table whose row 0 is [PAD] (a zero head), a plain
    table, a leaf the loss does not reach, a 0-d leaf."""

    pad_zero_params = ("pad",)

    def __init__(self, p0):
        super().__init__()
        for k, v in p0.items():
            setattr(self, k, nn.Parameter(torch.tensor(v)))


def _trainer(p0, learner, clip, wd):
    cfg = {"learner": learner, "learning_rate": LR, "clip_grad_norm": clip,
           "weight_decay": wd}
    trainer = Trainer.__new__(Trainer)
    trainer.model = _Leaves(p0)
    trainer.optimizer = build_optimizer(cfg)
    trainer._adam_leaves = trainer._pad_heads = None
    trainer.opt_state = trainer._fused_adam_init()
    return trainer, jax_trainer_mod.build_optimizer(cfg)


def _inputs(seed, steps=3, idle_rows=()):
    rng = np.random.RandomState(seed)
    p0 = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
    p0["pad"][0] = 0.0
    grads = [{k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    for g in grads[1:]:
        for r in idle_rows:
            g["pad"][r] = 0.0
    return p0, grads


def _run_both(p0, grads, learner, clip, wd):
    """The steps through the port's trainer (``_apply_gradients``: None for
    the unreached leaf, the [PAD] row as a zero head) and through the JAX
    chain (the [PAD] row's gradient zeroed, as its step does)."""
    trainer, tx = _trainer(p0, learner, clip, wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    names = list(SHAPES)
    for g in grads:
        jg = {k: jnp.zeros(SHAPES[k]) if k == "none" else jnp.asarray(v) for k, v in g.items()}
        jg["pad"] = jg["pad"].at[0].set(0.0)
        updates, state = tx.update(jg, state, jp)
        jp = {k: jp[k] + updates[k] for k in names}
        trainer._apply_gradients([None if k == "none" else torch.tensor(g[k]) for k in names])
    return trainer, jp


def _global_norm(g):
    g = dict(g)
    g["pad"] = g["pad"].copy()
    g["pad"][0] = 0.0
    return float(np.sqrt(sum(float(np.sum(np.square(v.astype(np.float64))))
                             for k, v in g.items() if k != "none")))


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("clip", ["off", "above", "below"])
@pytest.mark.parametrize("learner", ["sgd", "adagrad", "rmsprop", "adam", "adamw", "sparse_adam"])
def test_learner_steps_match_the_jax_optax_chain(learner, clip, wd):
    """Three steps of each learner against the JAX package's optax chain
    (clip_by_global_norm, add_decayed_weights, the learner), every leaf at
    rtol 2e-4: clipping off, with max_norm 3x above every step's global
    norm (nothing clipped) and 10x below it (every step clipped); weight
    decay off and on (sparse_adam warns and drops it in both packages). The
    [PAD] row and its moments stay zero."""
    p0, grads = _inputs(7)
    norms = [_global_norm(g) for g in grads]
    max_norm = {"off": None, "above": 3.0 * max(norms), "below": 0.1 * min(norms)}[clip]
    trainer, jp = _run_both(p0, grads, learner, max_norm and {"max_norm": max_norm}, wd)
    got = dict(trainer.model.named_parameters())
    for k in SHAPES:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(jp[k]), rtol=RTOL,
                                   atol=1e-9, err_msg=k)
        # the unreached leaf moves only by a decay (sparse_adam: not at all)
        if k != "none" or (learner != "sparse_adam" and (wd or learner == "adamw")):
            assert not np.array_equal(got[k].detach().numpy(), p0[k]), k
    assert not got["pad"][0].any()
    for table in ("mu", "nu", "sum_of_squares"):
        if table in trainer.opt_state:
            state_row = trainer.opt_state[table]["pad"][0]
            assert torch.equal(state_row, torch.full_like(state_row, state_row.flatten()[0]))


def test_clip_scales_as_optax_and_only_past_max_norm():
    """optax's clip: (g / norm) * max_norm once the global norm reaches
    max_norm, the gradient itself below it; the norm leaves the zero head
    out. The Adam path with max_norm far above the norm gives the unclipped
    path's bits."""
    p0, grads = _inputs(8, steps=1)
    names = list(SHAPES)
    tg = [None if k == "none" else torch.tensor(grads[0][k]) for k in names]
    t0, _ = _trainer(p0, "adam", None, 0.0)
    t1, _ = _trainer(p0, "adam", {"max_norm": 1e3}, 0.0)
    norm, max_norm = t1._clip(tg)
    np.testing.assert_allclose(float(norm), _global_norm(grads[0]), rtol=1e-6)
    assert max_norm == 1e3
    t0._apply_gradients(tg)
    t1._apply_gradients(tg)
    for (n, a), b in zip(t0.model.named_parameters(), t1.model.parameters()):
        assert torch.equal(a, b), n
    assert build_optimizer({"learner": "adam", "learning_rate": LR, "clip_grad_norm": 2.5,
                            "weight_decay": 0})["max_norm"] == 2.5
    assert build_optimizer({"learner": "adam", "learning_rate": LR,
                            "clip_grad_norm": {"other": 1}, "weight_decay": 0})["max_norm"] == 5.0


def test_unknown_learner_warns_and_trains_with_adam(caplog):
    opt = build_optimizer({"learner": "Lion", "learning_rate": LR, "clip_grad_norm": None,
                           "weight_decay": 0.0})
    assert opt["learner"] == "adam"
    assert "falling back to adam" in caplog.text
    opt = build_optimizer({"learner": "sparse_adam", "learning_rate": LR,
                           "clip_grad_norm": None, "weight_decay": 1e-3})
    assert opt["weight_decay"] == 0.0 and "sparse_adam does not support" in caplog.text


def test_lazy_adam_matches_jax_and_keeps_untouched_rows_bit_for_bit():
    """lazy_adam_step against the JAX package's lazy_adam over four steps,
    every leaf at rtol 2e-4; rows 3-5 of the table, untouched after the
    first step, keep their value and moments bit for bit (and so do the
    [PAD] row's), as do elements of a 1-D leaf whose gradient is 0."""
    p0, grads = _inputs(9, steps=4, idle_rows=(3, 4, 5))
    for g in grads:
        g["pad"][0] = 0.0
        g["none"][2] = 0.0
    tx = jax_lazy_adam(LR)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    after_first = None
    for t, g in enumerate(grads, start=1):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        lazy_adam_step(list(tp.values()), [torch.tensor(g[k]) for k in tp],
                       list(mu.values()), list(nu.values()), t, lr=LR)
        if t == 1:
            after_first = {k: (tp[k].clone(), mu[k].clone(), nu[k].clone())
                           for k in ("pad", "none")}
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=1e-9,
                                   err_msg=k)
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(state.mu[k]), rtol=RTOL,
                                   atol=1e-12, err_msg=k)
    p1, m1, v1 = after_first["pad"]
    for r in (3, 4, 5):
        assert torch.equal(tp["pad"][r], p1[r]) and torch.equal(mu["pad"][r], m1[r])
        assert torch.equal(nu["pad"][r], v1[r])
    assert not tp["pad"][0].any() and not mu["pad"][0].any()
    p1, m1, v1 = after_first["none"]
    assert torch.equal(tp["none"][2], p1[2]) and torch.equal(mu["none"][2], m1[2])


# ------------------------------------------------------------------ GAUC

@pytest.mark.parametrize("seed", [0, 1])
def test_gauc_metric_sums_match_jax_exactly_with_ties(seed):
    """Scores drawn from a few values (many ties, NEG_INF slots among them),
    positives, list lengths and a row mask: every row's numerator and
    denominator equal the JAX function's exactly (the ranks, rank sums and
    user AUCs are exact in both); the batch's, one float32 sum over the rows
    in each package's own order, within rtol 1e-6."""
    rng = np.random.RandomState(seed)
    B, C = 24, 40
    scores = rng.randint(0, 6, (B, C)).astype(np.float32) * 0.25
    scores[rng.rand(B, C) < 0.1] = -1e15
    pos = (rng.rand(B, C) < 0.2).astype(np.int32)
    pos[3] = 0
    pos_len = pos.sum(1).astype(np.int32)
    user_len = np.full(B, C, np.float32)
    user_len[5] = pos_len[5]
    mask = (rng.rand(B) < 0.9).astype(np.float32)
    ref = jax_gauc(jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(pos_len),
                   jnp.asarray(user_len), jnp.asarray(mask))
    got = gauc_metric_sums(torch.tensor(scores), torch.tensor(pos), torch.tensor(pos_len),
                           torch.tensor(user_len), torch.tensor(mask))
    for k in ("gauc_num", "gauc_den"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    # row by row (a sum of one term): exact
    for b in range(B):
        args = (scores[b:b + 1], pos[b:b + 1], pos_len[b:b + 1], user_len[b:b + 1], mask[b:b + 1])
        ref = jax_gauc(*map(jnp.asarray, args))
        got = gauc_metric_sums(*map(torch.tensor, args))
        for k in ("gauc_num", "gauc_den"):
            assert float(got[k]) == float(ref[k]), (b, k, float(got[k]), float(ref[k]))


def _gauc_cfg(**extra):
    return {"metrics": ["Recall", "NDCG", "GAUC"], "topk": [5, 10],
            "valid_metric": "GAUC", "embedding_size": 16, **extra}


@pytest.mark.parametrize("case", ["full", "uni20", "labeled"])
def test_trainer_gauc_matches_jax(case, synth_dataset_dir, tmp_path, monkeypatch):
    """GAUC through both trainers from the same weights, within rtol 1e-6:
    full sort (the non-fused step, history masked), the sampled step with
    the JAX-drawn negatives handed to the port, and the labeled step."""
    if case == "labeled":
        model, extra = "MFSimple", {**LABELED, "eval_use_dataset_negatives": True,
                                    "embedding_dimension": 16}
    else:
        model, extra = "BPR", ({"eval_setting": "RO_RS,uni20"} if case == "uni20" else {})
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(
        model, tmp_path, synth_dataset_dir, **_gauc_cfg(**extra))
    jtrainer = jax_trainer_mod.get_trainer(jc["MODEL_TYPE"], model)(jc, jmodel)
    jtrainer.params = jmodel.attach_consts(jax.tree.map(jnp.asarray, params))
    ptrainer = get_trainer(pc["MODEL_TYPE"], model)(pc, pmodel)
    assert TopKCollector(pc).needs_gauc
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        if hasattr(pdata, "neg_k"):
            draws = _jax_eval_draws(jtrainer, jdata, jc["neg_sampling_resample_rounds"])
            _inject(monkeypatch, draws, False)
            with jax.disable_jit():
                jres = jtrainer.evaluate(jdata, load_best_model=False)
        else:
            jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert "gauc" in pres and 0.0 < pres["gauc"] < 1.0
        _same_metrics(jres, pres)


# ------------------------------------------------------- bf16 eval scores

def _apart(vals, k, margin):
    """Rows whose k-th and (k+1)-th scores differ by more than ``margin``."""
    return (vals[:, k - 1] - vals[:, k]) > margin


def test_bf16_fused_topk_ids_match_jax(synth_dataset_dir, tmp_path):
    """The fused step's bf16 operands: the port's masked_topk on the query
    and table rounded to bf16 against the JAX step's masked_topk_xla on the
    same, ids equal where the k-th and (k+1)-th scores are 1e-6 apart; then
    BPR's metrics through both trainers under eval_score_dtype bfloat16
    within rtol 1e-6."""
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(
        "BPR", tmp_path, synth_dataset_dir, embedding_size=16, eval_score_dtype="bfloat16")
    rng = np.random.RandomState(3)
    B, N, k = 40, pmodel.n_items, 10
    users = torch.as_tensor(rng.randint(1, pmodel.n_users, B))
    query, table = pmodel.full_sort_query({"user_id": users})
    invalid = (rng.rand(B, N) < 0.2).astype(np.int8)
    invalid[:, 0] = 1
    q16, t16 = query.detach().to(torch.bfloat16), table.detach().to(torch.bfloat16)
    vals, ids = masked_topk(q16, t16, torch.as_tensor(invalid), k)
    jq = jnp.asarray(q16.float().numpy()).astype(jnp.bfloat16)
    jt = jnp.asarray(t16.float().numpy()).astype(jnp.bfloat16)
    jv, ji = masked_topk_xla(jq, jt, jnp.asarray(invalid), k + 1)
    jv, ji = np.asarray(jv), np.asarray(ji)
    keep = _apart(jv, k, 1e-6)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(ids.numpy()[keep], ji[keep, :k])
    np.testing.assert_allclose(vals.numpy(), jv[:, :k], rtol=1e-6, atol=1e-6)
    jtrainer = jax_trainer_mod.Trainer(jc, jmodel)
    jtrainer.params = jax.tree.map(jnp.asarray, params)
    ptrainer = Trainer(pc, pmodel)
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        _same_metrics(jtrainer.evaluate(jdata, load_best_model=False),
                      ptrainer.evaluate(pdata, load_best_model=False))


def test_bf16_chunked_score_items_topk_ids_match_jax(synth_dataset_dir, tmp_path):
    """The non-fused step under bf16 (NCF, no full_sort_predict: chunked
    score_items): every float32 parameter rounded to bf16 in both packages,
    each model's scores of every item, ids of the top 10 equal where the
    10th and 11th scores are apart by 2% of the scores' spread (the JAX
    towers round some elementwise results to bf16, the port keeps fp32
    between its exact products); the parameters come back as they were
    after the step."""
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(
        "NCF", tmp_path, synth_dataset_dir, mlp_embedding_dimension=16,
        gmf_embedding_dimension=8, eval_score_dtype="bfloat16")
    rng = np.random.RandomState(4)
    B, N, k = 32, pmodel.n_items, 10
    users = rng.randint(1, pmodel.n_users, B)
    items = np.broadcast_to(np.arange(N)[None, :], (B, N))
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == np.float32 else a,
                      jax.tree.map(jnp.asarray, params))
    jscores = np.asarray(jmodel.score_items(jp, {"user_id": jnp.asarray(users)},
                                            jnp.asarray(items)).astype(jnp.float32))
    before = [p.detach().clone() for p in pmodel.parameters()]
    with torch.no_grad(), bf16_parameters(pmodel):
        for p in pmodel.parameters():
            assert torch.equal(p, p.to(torch.bfloat16).float())
        pscores = pmodel.score_items({"user_id": torch.as_tensor(users)},
                                     torch.as_tensor(np.ascontiguousarray(items))).float()
    assert all(torch.equal(p, b) for p, b in zip(pmodel.parameters(), before))
    jsorted = -np.sort(-jscores, axis=1)
    spread = jsorted[:, 0] - jsorted[:, -1]
    keep = (jsorted[:, k - 1] - jsorted[:, k]) > 0.02 * spread
    assert keep.sum() >= B // 4
    pids = torch.sort(pscores, dim=1, descending=True, stable=True).indices[:, :k].numpy()
    jids = np.argsort(-jscores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.sort(pids[keep], 1), np.sort(jids[keep], 1))


# ------------------------------------------------------------ end to end

@pytest.mark.parametrize("extra", [
    {"learner": "sgd", "clip_grad_norm": {"max_norm": 1.0}},
    {"learner": "adagrad"}, {"learner": "rmsprop", "weight_decay": 1e-4},
    {"learner": "adamw", "clip_grad_norm": 0.5}, {"learner": "sparse_adam"},
    {"metrics": ["Recall", "GAUC"], "valid_metric": "GAUC"},
    {"eval_score_dtype": "bfloat16"}],
    ids=["sgd-clip", "adagrad", "rmsprop-wd", "adamw-clip", "sparse_adam", "gauc", "bf16"])
def test_run_recbole_with_each_option(extra, synth_dataset_dir, tmp_path):
    cfg = {"device": "cpu", "data_path": synth_dataset_dir, "epochs": 2,
           "train_batch_size": 256, "eval_batch_size": 512, "state": "ERROR",
           "valid_full_to_uni1000": False, "checkpoint_dir": str(tmp_path / "saved"),
           "log_dir": str(tmp_path / "log"), **extra}
    result = run_recbole(model="BPR", dataset="synth", config_dict=cfg, saved=True)
    tr = result["test_result"]
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert ("gauc" in tr) is ("GAUC" in extra.get("metrics", ()))
