"""The fork's protocols and simple baselines on the port, against the JAX
package: the sampled eval step (uni<k>/pop<k>, general and sequential, the
fork's uni1000 validation) with the JAX-drawn negatives handed to the port,
the labeled eval step over the dataset's own negatives, the both-way and
dataset-negative train augments and listwise input with the same draws,
MFSimple, GMF, MLP and NCF (losses, gradients, scores, three trainer steps
with weight decay), Adam's coupled weight decay against the JAX package's
optax chain, the sampler's binary-search route, and ``run_recbole`` end to
end on the CPU. Tolerances: fp32 rtol 2e-4 (losses, gradients, scores,
parameters; of a tensor's largest value where a gradient may be ~0);
ranking metrics within rtol 1e-6 (the hit rows are the same; both packages
add them in float32, in their own order); augments and loaders exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.sampler.sampler import (sample_negatives as jax_sample_negatives,
                                         sample_negatives_unchecked as jax_sample_unchecked)
from recbole_tpu.trainer import trainer as jax_trainer_mod
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.loaders import (DatasetNegEvalLoader, SampledEvalLoader,
                                            SequentialSampledEvalLoader)
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.models.base import AbstractRecommender
from recbole_tpu_torch.ops.fused_adam import AdamLeaves, adam_leaf_torch, adam_multi
from recbole_tpu_torch.sampler import sampler as port_sampler
from recbole_tpu_torch.trainer import trainer as trainer_mod
from recbole_tpu_torch.trainer.trainer import Trainer, get_trainer
from recbole_tpu_torch.utils.enums import InputType, ModelType
from recbole_tpu_torch.utils.utils import init_seed

RTOL = 2e-4
LABELED = {"load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"]},
           "threshold": {"rating": 3}}
# the fork's baselines at narrow widths, and their other branches
BASELINES = {
    "MFSimple": ("MFSimple", {"embedding_dimension": 16}),
    "GMF": ("GMF", {"embedding_dimension": 16}),
    "MLP": ("MLP", {"embedding_dimension": 12, "ff_layers": [16, 8], "dropout": 0.0}),
    "MLP-mul": ("MLP", {"embedding_dimension": 12, "ff_layers": [16, 8], "dropout": 0.0,
                        "mlp_variant": "mul"}),
    "NCF": ("NCF", {"mlp_embedding_dimension": 16, "gmf_embedding_dimension": 8}),
    "NCF-fix": ("NCF", {"mlp_embedding_dimension": 16, "gmf_embedding_dimension": 8,
                        "ncf_fix_gmf_item_lookup": True}),
}


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
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= tol * scale + atol, (what, err, scale)


def _cfg(tmp_path, data_path, **extra):
    return {"epochs": 1, "train_batch_size": 256, "eval_batch_size": 512,
            "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
            "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
            "metric_decimal_place": 12, "data_path": data_path, **extra}


def _pair(model, tmp_path, data_path, perturb=False, dataset="synth", **extra):
    """Both packages' loaders and models on the synthetic set, the port's
    model loaded with the JAX one's initial weights (``perturb``: its 1-D
    leaves moved off their zero or unit starts)."""
    cfg = _cfg(tmp_path, data_path, **extra)
    jc = JaxConfig(model, dataset, config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model(model)(jc, jloaders[0].dataset)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    if perturb:
        rng = np.random.RandomState(0)
        params = jax.tree.map(lambda v: v + 0.05 * rng.randn(*v.shape).astype(np.float32)
                              if v.ndim == 1 else v, params)
    pc = Config(model, dataset, config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    pmodel = get_model(model)(pc, ploaders[0].dataset)
    load_jax_params(pmodel, params)
    return jc, pc, jloaders, ploaders, jmodel, params, pmodel


def _pointwise_batch(loader, n_items, seed, n=64):
    """Rows of the train table labelled 1, then two random items each
    labelled 0 (unbalanced, so that no bias's gradient is ~0 and signed
    by rounding alone)."""
    rng = np.random.RandomState(seed)
    cols = loader.columns()
    rows = rng.randint(0, len(cols["user_id"]), n)
    users = cols["user_id"][rows].astype(np.int64)
    items = cols["item_id"][rows].astype(np.int64)
    return {"user_id": np.concatenate([users] * 3),
            "item_id": np.concatenate([items, rng.randint(1, n_items, 2 * n)]),
            "label": np.concatenate([np.ones(n), np.zeros(2 * n)]).astype(np.float32)}


# ----------------------------------------------------------- weight decay

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-3


@pytest.mark.parametrize("wd", [1e-8, 1e-2])
def test_adam_weight_decay_matches_the_jax_optax_chain(wd):
    """Three steps of the plain version with coupled weight decay against
    the JAX package's own optimizer (build_optimizer: add_decayed_weights,
    then adam), every row of every leaf, rtol 2e-4: a table with a [PAD]
    row of zeros (its gradient zeroed first, as the JAX step zeroes a
    pad_zero_params row: it stays zero, moments too), one whose head row is
    not zero (the chain decays it, and so does the zero head), a leaf
    without a gradient (decayed alone) and a 0-d leaf."""
    rng = np.random.RandomState(5)
    shapes = {"pad": (20, 8), "head": (12, 4), "none": (7,), "scalar": ()}
    heads = {"pad": 8, "head": 4, "none": 0, "scalar": 0}
    p0 = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    p0["pad"][0] = 0.0
    grads = [{k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = jax_trainer_mod.build_optimizer({"learning_rate": LR, "learner": "adam",
                                          "clip_grad_norm": None, "weight_decay": wd})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    names = list(shapes)
    leaves = AdamLeaves([torch.tensor(p0[k]) for k in names],
                        [torch.zeros(shapes[k]) for k in names],
                        [torch.zeros(shapes[k]) for k in names], [heads[k] for k in names])
    for t, g in enumerate(grads, start=1):
        jg = {k: jnp.zeros(shapes[k]) if k == "none" else jnp.asarray(v) for k, v in g.items()}
        for k in ("pad", "head"):
            jg[k] = jg[k].at[0].set(0.0)
        updates, state = tx.update(jg, state, jp)
        jp = {k: jp[k] + updates[k] for k in names}
        adam_multi(leaves, [None if k == "none" else torch.tensor(g[k]) for k in names],
                   1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t), b1=B1, b2=B2, lr=LR, eps=EPS,
                   wd=wd)
    for i, k in enumerate(names):
        np.testing.assert_allclose(leaves.p[i].numpy(), np.asarray(jp[k]), rtol=RTOL,
                                   atol=1e-9, err_msg=k)
    assert not leaves.p[0][0].any() and not leaves.m[0][0].any() and not leaves.v[0][0].any()
    assert not np.array_equal(leaves.p[1][0].numpy(), p0["head"][0])
    assert not np.array_equal(leaves.p[2].numpy(), p0["none"])


def test_adam_without_weight_decay_is_unchanged_bit_for_bit():
    """wd 0 (the default) leaves the plain version's arithmetic as it was:
    the same bits as the formula without the term, a -0 gradient and an
    infinite parameter included."""
    rng = np.random.RandomState(6)
    p = torch.tensor((rng.standard_normal(257) * 0.1).astype(np.float32))
    p[3] = float("inf")
    g = torch.tensor((rng.standard_normal(257) * 1e-3).astype(np.float32))
    g[5] = -0.0
    m, v = torch.zeros(257), torch.zeros(257)
    m[7] = -0.0
    c1, c2 = 10.0, 1000.0
    m2 = B1 * m + (1.0 - B1) * g
    v2 = B2 * v + (1.0 - B2) * g * g
    p2 = p - LR * (m2 * c1) / (torch.sqrt(v2 * c2) + EPS)
    for kw in ({}, {"wd": 0.0}):
        pp, mm, vv = p.clone(), m.clone(), v.clone()
        adam_leaf_torch(pp, mm, vv, g, c1, c2, b1=B1, b2=B2, lr=LR, eps=EPS, **kw)
        for got, ref in ((pp, p2), (mm, m2), (vv, v2)):
            assert torch.equal(got, ref) and torch.equal(torch.signbit(got), torch.signbit(ref))


# --------------------------------------------------------------- baselines

@pytest.mark.parametrize("variant", sorted(BASELINES))
def test_baseline_loss_gradients_and_scores_match_jax(variant, synth_dataset_dir, tmp_path):
    """calculate_loss and the gradient of every leaf (rtol 2e-4; MLP's
    dropout at 0: the two packages draw other masks), predict, score_items
    over (B, C) candidates, and full_sort_predict where the model has it,
    from the same weights; the weight carrier's round trip and the port's
    own initialiser's names and shapes."""
    model, extra = BASELINES[variant]
    _, pc, _, ploaders, jmodel, params, pmodel = _pair(model, tmp_path, synth_dataset_dir,
                                                       perturb=True, **extra)
    b = _pointwise_batch(ploaders[0], pmodel.n_items, 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jb, jax.random.key(2)))(
        jax.tree.map(jnp.asarray, params))
    loss = pmodel.calculate_loss({k: torch.as_tensor(v) for k, v in b.items()},
                                 generator=torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert set(ref) == set(dict(pmodel.named_parameters()))
    for name, p in pmodel.named_parameters():
        _close(p.grad.numpy(), ref[name], name, atol=1e-10)
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.RandomState(4)
    users = rng.randint(1, pmodel.n_users, 23).astype(np.int64)
    items = rng.randint(1, pmodel.n_items, (23, 37)).astype(np.int64)
    with torch.no_grad():
        pair = {k: torch.as_tensor(b[k]) for k in ("user_id", "item_id")}
        _close(pmodel.predict(pair).numpy(),
               jmodel.predict(jparams, {k: jnp.asarray(b[k]) for k in pair}), "predict")
        got = pmodel.score_items({"user_id": torch.as_tensor(users)}, torch.as_tensor(items))
        _close(got.numpy(), jmodel.score_items(jparams, {"user_id": jnp.asarray(users)},
                                               jnp.asarray(items)), "score_items")
        has_full = type(pmodel).full_sort_predict is not AbstractRecommender.full_sort_predict
        assert has_full is (model in ("MFSimple", "GMF"))
        assert not trainer_mod.fused_full_sort(type(pmodel))
        if has_full:
            _close(pmodel.full_sort_predict({"user_id": torch.as_tensor(users)}).numpy(),
                   jmodel.full_sort_predict(jparams, {"user_id": jnp.asarray(users)}),
                   "full_sort_predict")
    back = flatten_tree(export_params(pmodel))
    assert set(back) == set(flatten_tree(params))
    fresh = get_model(model)(pc, ploaders[0].dataset)
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == {
        k: v.shape for k, v in flatten_tree(params).items()}


def test_ncf_user_indexed_item_lookup_clamps_as_jax(tmp_path):
    """NCF's default GMF tower reads gmf_item_embedding at the USER id (the
    fork's quirk); with more users than items (as ml-1m has) the ids past
    the item table read its last row and give it no gradient, as the JAX
    package's gather clamps them and its scatter drops them: loss and
    gradients at rtol 2e-4 on a set of 90 users and 40 items."""
    from tests.synth_data import make_synthetic_dataset
    make_synthetic_dataset(str(tmp_path / "data"), name="wide", n_users=90, n_items=40,
                           n_inter=1500, with_kg=False)
    _, _, _, ploaders, jmodel, params, pmodel = _pair(
        "NCF", tmp_path, str(tmp_path / "data"), dataset="wide", **BASELINES["NCF"][1])
    assert pmodel.n_users > pmodel.n_items
    b = _pointwise_batch(ploaders[0], pmodel.n_items, 0)
    assert (b["user_id"] >= pmodel.n_items).any()
    jl, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}))(jax.tree.map(jnp.asarray, params))
    loss = pmodel.calculate_loss({k: torch.as_tensor(v) for k, v in b.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    for name, p in pmodel.named_parameters():
        _close(p.grad.numpy(), ref[name], name, atol=1e-10)


@pytest.mark.parametrize("variant", ["MFSimple", "GMF", "MLP", "NCF"])
def test_three_steps_with_weight_decay_match_jax(variant, synth_dataset_dir, tmp_path):
    """Three train steps at weight_decay 1e-2 on the same batches: the JAX
    step core through its optax chain (add_decayed_weights, adam: the JAX
    trainer leaves its fused Adam under weight decay) against the port's
    fused Adam with the decay in it; the loss at each step and every
    parameter after, rtol 2e-4 / atol 1e-6."""
    model, extra = BASELINES[variant]
    jc, pc, _, ploaders, jmodel, params, pmodel = _pair(model, tmp_path, synth_dataset_dir,
                                                        perturb=True, weight_decay=1e-2, **extra)
    jtrainer = jax_trainer_mod.Trainer(jc, jmodel)
    assert not jtrainer._use_fused_adam()
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = jtrainer.optimizer.init(jparams)
    ptrainer = Trainer(pc, pmodel)
    assert ptrainer.optimizer["weight_decay"] == 1e-2
    ptrainer.opt_state = ptrainer._fused_adam_init()
    jstep = jtrainer._make_step_core(lambda batch, rng, consts: batch, jmodel.calculate_loss)
    pstep = ptrainer._make_step_core(lambda batch, gen, consts: batch, pmodel.calculate_loss)
    key = jax.random.key(1)
    for step in range(3):
        b = _pointwise_batch(ploaders[0], pmodel.n_items, 10 + step)
        jparams, opt_state, key, jloss, _ = jstep(
            jparams, opt_state, key, {k: jnp.asarray(v) for k, v in b.items()}, {})
        ploss = pstep({k: torch.as_tensor(v) for k, v in b.items()}, {})
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL)
    got = flatten_tree(export_params(pmodel))
    for name, ref in flatten_tree(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=1e-6, err_msg=name)


# -------------------------------------------------------- eval protocols

def _jax_eval_draws(jtrainer, jdata, rounds):
    """The negatives the JAX trainer's evaluate draws for each batch of a
    sampled loader, from its rng as it splits it (trainer.py:1320-1322)
    and by its sampler as its step calls it (:1117-1123). A sequential
    split's draws may repeat a row's target: such a negative and the target
    score the same but for the last bit of JAX's einsum over the candidate
    axis, which then breaks their tie either way; it is drawn again, for
    both packages (``test_candidate_ties_rank_as_jax_top_k`` holds the
    port's tie rule)."""
    rng = jtrainer.rng
    phase = jdata.sample_phase
    hist, hlen = jdata.phase_history.device_tables(phase)
    pop = (jnp.asarray(jdata.phase_history.pop_items[phase])
           if jdata.distribution == "popularity" else None)
    count = jdata.max_pos * jdata.neg_k
    draws = []
    for batch in jdata:
        rng, ek = jax.random.split(rng)
        uid = jnp.asarray(batch["user_id"])
        if getattr(jdata, "repeatable_sampling", False):
            negs = np.asarray(jax_sample_unchecked(ek, (uid.shape[0], count), jdata.n_items,
                                                   pop_items=pop))
            target = batch["pos_items"][:, :1]
            negs = np.where(negs == target, target % (jdata.n_items - 1) + 1, negs)
        else:
            negs = np.asarray(jax_sample_negatives(ek, uid, hist, hlen, jdata.n_items, count,
                                                   rounds=rounds, pop_items=pop))
        draws.append(negs)
    return draws


def _inject(monkeypatch, draws, repeatable):
    """Hand ``draws`` to both packages' sampled eval steps, batch by batch:
    the JAX step's sampler (its evaluate then runs without jit, so that each
    batch calls it) and the port's ``draw_negatives``."""
    jax_draws = list(draws)

    def jax_fake(*args, **kwargs):
        return jnp.asarray(jax_draws.pop(0))

    def port_fake(generator, user_id, consts, count, n_items, rounds, repeatable_):
        assert repeatable_ is repeatable and ("hist" in consts) is not repeatable
        negs = draws.pop(0)
        assert negs.shape == (user_id.shape[0], count)
        return torch.as_tensor(negs.astype(np.int64))

    name = "sample_negatives_unchecked" if repeatable else "sample_negatives"
    monkeypatch.setattr(jax_trainer_mod, name, jax_fake)
    monkeypatch.setattr(trainer_mod, "draw_negatives", port_fake)
    return jax_draws


def _same_metrics(jres, pres):
    """Both packages add each batch's per-user values in float32 on their
    device, in their own order: equal hit rows give metrics within rtol
    1e-6 (one hit more or less in 60 users moves recall by ~1e-2)."""
    assert set(jres) == set(pres)
    for k, v in jres.items():
        np.testing.assert_allclose(pres[k], v, rtol=1e-6, atol=1e-12, err_msg=k)


SAMPLED = {
    "BPR-uni20": ("BPR", {"eval_setting": "RO_RS,uni20", "embedding_size": 16}),
    "BPR-pop20": ("BPR", {"eval_setting": "RO_RS,pop20", "embedding_size": 16}),
    # the fork's override: uni1000 validation, full-sort test
    "BPR-valid-uni1000": ("BPR", {"valid_full_to_uni1000": True, "embedding_size": 16}),
    "MFSimple-uni50": ("MFSimple", {"eval_setting": "RO_RS,uni50", "embedding_dimension": 16}),
    "SASRec-uni20": ("SASRec", {"eval_setting": "TO_LS,uni20"}),
    "SASRec-pop20": ("SASRec", {"eval_setting": "TO_LS,pop20"}),
}
SEQ = {"MAX_ITEM_LIST_LENGTH": 8, "n_layers": 1, "n_heads": 2, "hidden_size": 16,
       "inner_size": 32, "compute_dtype": "float32", "fused_attention": False}


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_sampled_eval_matches_jax(case, synth_dataset_dir, tmp_path, monkeypatch):
    """The sampled eval step (positives first, P*k negatives, the validity
    masks, the -inf pad to max_k, ``topk_idx < pos_len``) from the same
    weights and the JAX-drawn negatives: valid and test metrics within rtol
    1e-6, at topk [5, 10, 50] (50 wider than some candidate lists);
    sequential negatives that repeat the target tie with it, and rank
    after it, as jax.lax.top_k ranks equal scores."""
    model, extra = SAMPLED[case]
    extra = {**extra, **(SEQ if model == "SASRec" else {}),
             "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision", "MAP"],
             "topk": [5, 10, 50]}
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(
        model, tmp_path, synth_dataset_dir, perturb=model == "SASRec", **extra)
    jtrainer = jax_trainer_mod.get_trainer(jc["MODEL_TYPE"], model)(jc, jmodel)
    jtrainer.params = jmodel.attach_consts(jax.tree.map(jnp.asarray, params))
    ptrainer = get_trainer(pc["MODEL_TYPE"], model)(pc, pmodel)
    sampled = 0
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        assert type(pdata).__name__ == type(jdata).__name__
        if hasattr(pdata, "neg_k"):
            sampled += 1
            assert isinstance(pdata, (SampledEvalLoader, SequentialSampledEvalLoader))
            assert (pdata.neg_k, pdata.distribution, pdata.max_pos, pdata.batch_size) == (
                jdata.neg_k, jdata.distribution, jdata.max_pos, jdata.batch_size)
            repeatable = getattr(pdata, "repeatable_sampling", False)
            assert repeatable is (model == "SASRec")
            draws = _jax_eval_draws(jtrainer, jdata, jc["neg_sampling_resample_rounds"])
            jax_draws = _inject(monkeypatch, draws, repeatable)
            with jax.disable_jit():
                jres = jtrainer.evaluate(jdata, load_best_model=False)
            assert not jax_draws
        else:
            jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        _same_metrics(jres, pres)
        if hasattr(pdata, "neg_k"):
            assert not draws
    assert sampled == (1 if case == "BPR-valid-uni1000" else 2)


def test_labeled_eval_matches_jax(synth_dataset_dir, tmp_path):
    """The labeled eval step over the dataset's own negatives (each user's
    label-1 items, then their label-0 items; no history mask; lists
    narrower than max_k padded with -inf): the loader's arrays equal the
    JAX package's, and the valid and test metrics from the same weights
    agree within rtol 1e-6."""
    extra = {**LABELED, "eval_use_dataset_negatives": True, "embedding_dimension": 16,
             "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision", "MAP"], "topk": [3, 10, 50]}
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair("MFSimple", tmp_path,
                                                               synth_dataset_dir, **extra)
    jtrainer = jax_trainer_mod.Trainer(jc, jmodel)
    jtrainer.params = jax.tree.map(jnp.asarray, params)
    ptrainer = get_trainer(pc["MODEL_TYPE"], "MFSimple")(pc, pmodel)
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        assert type(pdata) is DatasetNegEvalLoader and not pdata.mask_history
        for name in ("users", "pos_items", "pos_len", "neg_items", "neg_len", "batch_size"):
            np.testing.assert_array_equal(getattr(pdata, name), getattr(jdata, name),
                                          err_msg=name)
        assert pdata.neg_len.min() >= 0 and (pdata.neg_len > 0).any()
        for jb, pb in zip(jdata, pdata):
            assert set(jb) == set(pb)
            for k in jb:
                np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        _same_metrics(jtrainer.evaluate(jdata, load_best_model=False),
                      ptrainer.evaluate(pdata, load_best_model=False))


def test_candidate_ties_rank_as_jax_top_k():
    """Equal scores rank the lower index first, as jax.lax.top_k ranks
    them: a target tied with a negative that repeats it is a hit; invalid
    candidates and the pad past the list score -inf and never are."""
    scores = np.array([[0.5, 0.5, 0.5, 0.9, 0.5, 0.1],
                       [0.2, 0.7, 0.7, 0.7, 0.2, 0.7],
                       [0.3, 0.3, 0.3, 0.3, 0.3, 0.3]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], bool)
    pos_len = np.array([1, 2, 2])
    for max_k in (3, 8):
        got = trainer_mod.candidate_hits(trainer_mod.masked_candidate_scores(
            torch.as_tensor(scores), torch.as_tensor(valid), max_k), torch.as_tensor(pos_len),
            max_k)
        ref = np.where(valid, scores, trainer_mod.NEG_INF)
        ref = np.pad(ref, ((0, 0), (0, max(0, max_k - 6))),
                     constant_values=trainer_mod.NEG_INF)
        _, idx = jax.lax.top_k(jnp.asarray(ref), max_k)
        np.testing.assert_array_equal(got.numpy(), (np.asarray(idx) < pos_len[:, None]))


# ----------------------------------------------------------- train augments

class _Draws:
    """Negatives handed to both packages' ``sample_negatives``, in the order
    their augments ask for them."""

    def __init__(self, seed, n_items):
        self.rng = np.random.RandomState(seed)
        self.n_items = n_items
        self.jax, self.port = [], []

    def jax_fake(self, rng, user_ids, history, hist_len, n_items, num_neg, rounds=8,
                 pop_items=None):
        negs = self.rng.randint(1, self.n_items, (user_ids.shape[0], num_neg))
        self.jax.append(negs)
        return jnp.asarray(negs.astype(np.int32))

    def port_fake(self, generator, user_ids, history, hist_len, n_items, num_neg, rounds=8,
                  pop_items=None):
        negs = self.jax.pop(0)
        assert negs.shape == (user_ids.shape[0], num_neg)
        self.port.append(negs)
        return torch.as_tensor(negs.astype(np.int64))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_bothway_augment_matches_jax(k, synth_dataset_dir, tmp_path, monkeypatch):
    """train_use_bothway_sampler: the B rows, k blocks of sampled negatives
    labelled 0, round(k/3) blocks of sampled pseudo-positives labelled 1,
    every column repeated, ``_weight`` gating each expansion by the row's
    label; the same draws given to both packages: every column exact."""
    extra = {**LABELED, "train_use_bothway_sampler": True, "training_neg_sample_num": k,
             "embedding_dimension": 16}
    _, _, jloaders, ploaders, jmodel, _, pmodel = _pair("MFSimple", tmp_path, synth_dataset_dir,
                                                        **extra)
    draws = _Draws(3, pmodel.n_items)
    monkeypatch.setattr(jax_trainer_mod, "sample_negatives", draws.jax_fake)
    monkeypatch.setattr(trainer_mod, "sample_negatives", draws.port_fake)
    jtrainer = jax_trainer_mod.Trainer(jloaders[0].config, jmodel)
    ptrainer = Trainer(ploaders[0].config, pmodel)
    jaug, jconsts = jtrainer._make_rec_augment(jloaders[0])
    paug, pconsts = ptrainer._make_rec_augment(ploaders[0])
    cols = ploaders[0].columns()
    rows = np.random.RandomState(1).randint(0, len(cols["user_id"]), 50)
    batch = {f: v[rows] for f, v in cols.items()}
    assert set(np.unique(batch["label"])) == {0.0, 1.0}
    batch["_weight"] = np.where(np.arange(50) < 45, 1.0, 0.0).astype(np.float32)
    jout = jaug({f: jnp.asarray(v) for f, v in batch.items()}, jax.random.key(0), jconsts)
    pout = paug({f: torch.as_tensor(v) for f, v in batch.items()}, ptrainer.generator, pconsts)
    k3 = max(int(round(k / 3)), 1)
    assert len(draws.port) == 2 and draws.port[1].shape == (50, k3) and not draws.jax
    assert set(jout) == set(pout)
    for f in jout:
        np.testing.assert_array_equal(pout[f].numpy(), np.asarray(jout[f]), err_msg=f)
    assert pout["item_id"].shape == (50 * (1 + k + k3),)


@pytest.mark.parametrize("kind", ["dataset_negatives", "listwise"])
def test_labeled_rows_pass_through_as_jax(kind, synth_dataset_dir, tmp_path, monkeypatch):
    """train_use_dataset_negatives, and listwise input, take the rows as
    they are (no draw), as the JAX package's augment does."""
    extra = {**LABELED, "embedding_dimension": 16, "training_neg_sample_num": 4,
             "train_use_dataset_negatives": kind == "dataset_negatives"}
    _, _, jloaders, ploaders, jmodel, _, pmodel = _pair("MFSimple", tmp_path, synth_dataset_dir,
                                                        **extra)
    if kind == "listwise":
        monkeypatch.setattr(pmodel, "input_type", InputType.LISTWISE)
        monkeypatch.setattr(jmodel, "input_type", jax_trainer_mod.InputType.LISTWISE)

    def no_draw(*a, **kw):
        raise AssertionError("no negatives are drawn")

    monkeypatch.setattr(jax_trainer_mod, "sample_negatives", no_draw)
    monkeypatch.setattr(trainer_mod, "sample_negatives", no_draw)
    jaug, jconsts = jax_trainer_mod.Trainer(jloaders[0].config, jmodel)._make_rec_augment(
        jloaders[0])
    ptrainer = Trainer(ploaders[0].config, pmodel)
    paug, pconsts = ptrainer._make_rec_augment(ploaders[0])
    batch = {f: v[:40] for f, v in ploaders[0].columns().items()}
    jout = jaug({f: jnp.asarray(v) for f, v in batch.items()}, jax.random.key(0), jconsts)
    pout = paug({f: torch.as_tensor(v) for f, v in batch.items()}, ptrainer.generator, pconsts)
    assert set(jout) == set(pout) == set(batch)
    for f in batch:
        np.testing.assert_array_equal(pout[f].numpy(), np.asarray(jout[f]), err_msg=f)


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("seed", [0, 1])
def test_binary_search_route_picks_what_all_pairs_picks(seed):
    """A candidate is looked up in its user's sorted history row by binary
    search: the chosen ids equal those of the JAX package's all-pairs
    comparison (every candidate against every valid entry, then the first
    round that does not collide) on histories with padding, repeats and
    empty rows."""
    rng = np.random.RandomState(seed)
    n_users, n_items, H = 30, 50, 40
    hlen = rng.randint(0, H + 1, n_users)
    hlen[3] = 0
    hist = np.zeros((n_users, H), np.int64)
    for u in range(n_users):
        hist[u, :hlen[u]] = rng.randint(1, n_items, hlen[u])
    cand = rng.randint(1, n_items, (8, 64, 5))
    users = rng.randint(0, n_users, 64)
    picked = port_sampler.first_non_colliding(
        torch.as_tensor(cand), torch.as_tensor(users), torch.as_tensor(hist),
        torch.as_tensor(hlen))
    valid = np.arange(H)[None, :] < hlen[users][:, None]
    collide = ((cand[:, :, :, None] == hist[users][None, :, None, :])
               & valid[None, :, None, :]).any(-1)
    first_ok = np.argmax(~collide, axis=0)
    np.testing.assert_array_equal(picked.numpy(),
                                  np.take_along_axis(cand, first_ok[None], 0)[0])
    found = port_sampler.in_history(torch.as_tensor(cand), torch.as_tensor(hist[users]),
                                    torch.as_tensor(valid))
    np.testing.assert_array_equal(found.numpy(), collide)


# --------------------------------------------------------- end to end, CPU

@pytest.mark.parametrize("case", ["dataset_negatives", "bothway", "GMF", "MLP", "NCF",
                                  "BPR-uni1000", "SASRec-uni100"])
def test_end_to_end_on_cpu(case, synth_dataset_dir, tmp_path):
    """run_recbole on the synthetic set: MFSimple under the two labeled
    workflows (SURVEY 2.9: dataset negatives both ways; the both-way
    sampler at k 3), GMF, MLP and NCF at their defaults, BPR with the fork's
    uni1000 validation and SASRec under TO_LS,uni100: metrics in [0, 1]."""
    model, extra = {
        "dataset_negatives": ("MFSimple", {**LABELED, "train_use_dataset_negatives": True,
                                           "eval_use_dataset_negatives": True}),
        "bothway": ("MFSimple", {**LABELED, "train_use_bothway_sampler": True,
                                 "training_neg_sample_num": 3}),
        "GMF": ("GMF", {}), "MLP": ("MLP", {}), "NCF": ("NCF", {}),
        "BPR-uni1000": ("BPR", {"valid_full_to_uni1000": True}),
        "SASRec-uni100": ("SASRec", {"eval_setting": "TO_LS,uni100", **SEQ}),
    }[case]
    result = run_recbole(model=model, dataset="synth",
                         config_dict=_cfg(tmp_path, synth_dataset_dir, epochs=2, **extra))
    for split in ("best_valid_result", "test_result"):
        vals = result[split]
        assert set(vals) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
        assert all(0.0 <= v <= 1.0 for v in vals.values()), (split, vals)


def test_registry_builds_the_baselines():
    for model in ("MFSimple", "GMF", "MLP", "NCF"):
        assert get_model(model).model_name == model
        assert get_model(model).input_type is InputType.POINTWISE
        assert get_trainer(ModelType.GENERAL, model) is Trainer
        assert get_model(model).default_config["weight_decay"] == 1e-8
