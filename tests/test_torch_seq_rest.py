"""The last nine sequential models, Caser, NextItNet, TransRec, FPMC, HGN,
HRM, NPE, SHAN and FOSSIL, on the port against the JAX package: each
model's ``calculate_loss``, the gradient of every leaf, and its full-sort,
``score_items`` and ``predict`` scores at rtol 2e-4 (fp32, dropout off) on
weights carried across by ``convert.py``; Caser with a filter whose
activations are all zero and one whose activations tie, NextItNet on
right-padded short rows, HGN's two BPR tables, TransRec's 1-D [PAD] row
through Adam steps, the fused masked top-k of the base-stack models against
their non-fused scores, and ``run_recbole`` for each model on the CPU. The
harness is ``tests/test_torch_gru_users.py``'s."""

import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.ops.masked_topk import masked_topk
from recbole_tpu_torch.trainer.trainer import (Trainer, fused_full_sort, history_masked_scores,
                                               invalid_item_mask)
from recbole_tpu_torch.utils.utils import init_seed
# _one_thread: the same autouse fixture, one torch thread a test
from tests.test_torch_gru_users import (RTOL, _batch, _cfg, _close, _grads_close,  # noqa: F401
                                        _jax_loss, _one_thread, _pair, _torch_batch)

MODELS = ("Caser", "NextItNet", "TransRec", "FPMC", "HGN", "HRM", "NPE", "SHAN", "FOSSIL")
# the models that keep the sequential base's scoring: the fused masked top-k
BASE_STACK = ("Caser", "NextItNet", "HGN", "HRM", "NPE", "SHAN", "FOSSIL")
BPR = {"loss_type": "BPR", "training_neg_sample_num": 1}
# (model, extra config) of each case; "BPR" in a case's name adds a
# negative column to its batch, "weighted" a _weight with zeros
CASES = {
    "Caser": ("Caser", {}),
    "Caser-BPR-weighted": ("Caser", BPR),
    "NextItNet": ("NextItNet", {"block_num": 2}),
    "NextItNet-BPR": ("NextItNet", {"block_num": 1, "dilations": [1, 2, 4], **BPR}),
    "TransRec-BPR": ("TransRec", {}),
    "TransRec-BPR-weighted": ("TransRec", {}),
    "FPMC-BPR": ("FPMC", {}),
    "FPMC-BPR-weighted": ("FPMC", {}),
    "HGN-BPR": ("HGN", {}),
    "HGN-BPR-regs-weighted": ("HGN", {"reg_weight": [0.01, 0.001]}),
    "HGN-BPR-max": ("HGN", {"pooling_type": "max", "reg_weight": [0.01, 0.001]}),
    "HGN-CE": ("HGN", {"loss_type": "CE", "training_neg_sample_num": 0}),
    "HRM": ("HRM", {}),
    "HRM-average-BPR": ("HRM", {"pooling_type_layer_1": "average",
                                "pooling_type_layer_2": "average", "high_order": 3, **BPR}),
    "NPE": ("NPE", {}),
    "NPE-BPR": ("NPE", BPR),
    "SHAN": ("SHAN", {}),
    "SHAN-weighted": ("SHAN", {"short_item_length": 3}),
    "FOSSIL": ("FOSSIL", {"reg_weight": 0.01}),
    "FOSSIL-BPR-weighted": ("FOSSIL", {"reg_weight": 0.01, **BPR}),
}


@pytest.fixture(autouse=True)
def _port_logger():
    """run_recbole's init_logger sets the port logger's level, handlers and
    propagation: restore them after the test (closing the handlers it
    added), so that a later test in the process finds them as they were."""
    logger = logging.getLogger("recbole_tpu_torch")
    level, handlers, propagate = logger.level, list(logger.handlers), logger.propagate
    yield
    for h in logger.handlers:
        if h not in handlers:
            h.close()
    logger.handlers[:] = handlers
    logger.setLevel(level)
    logger.propagate = propagate


def _seq_pair(model, tmp_path, data_path, **extra):
    """_pair, with the leaves that start at zero everywhere (FOSSIL's
    user_lambda) drawn from a seed, so that each scoring path carries
    signal."""
    jmodel, params, pmodel, ploaders = _pair(model, tmp_path, data_path, **extra)
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda v: (0.1 * rng.randn(*v.shape)).astype(np.float32)
                          if v.ndim >= 2 and not np.any(v) else v, params)
    load_jax_params(pmodel, params)
    return jmodel, params, pmodel, ploaders


def _np(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_scores(jmodel, params, pmodel, batch):
    """full_sort_predict, predict and score_items (up to 20 rows x 7
    candidates) against the JAX model's. FPMC's JAX model has no
    score_items of its own (the sequential base's needs a forward): its
    candidates go through the JAX predict, row by row."""
    jparams = jax.tree.map(jnp.asarray, params)
    ev = {k: v for k, v in batch.items() if k not in ("_weight", "neg_item_id")}
    pmodel.eval()
    with torch.no_grad():
        _close(pmodel.full_sort_predict(_torch_batch(ev)).numpy(),
               jmodel.full_sort_predict(jparams, _np(ev)), "full_sort_predict")
        _close(pmodel.predict(_torch_batch(ev)).numpy(), jmodel.predict(jparams, _np(ev)),
               "predict")
        R = min(20, len(ev["item_id"]))
        rows = {k: v[:R] for k, v in ev.items()}
        cand = np.random.RandomState(6).randint(1, pmodel.n_items, (R, 7))
        got = pmodel.score_items(_torch_batch(rows), torch.as_tensor(cand)).numpy()
        if type(pmodel).__name__ == "FPMC":
            flat = {k: np.repeat(v, 7, axis=0) for k, v in rows.items()}
            flat["item_id"] = cand.reshape(-1)
            ref = np.asarray(jmodel.predict(jparams, _np(flat))).reshape(R, 7)
        else:
            ref = jmodel.score_items(jparams, _np(rows), jnp.asarray(cand))
        _close(got, ref, "score_items")


def check_loss_and_grads(jmodel, params, pmodel, batch):
    jloss, jgrads = _jax_loss(jmodel, params, _np(batch))
    pmodel.train()
    pmodel.zero_grad()
    loss = pmodel.calculate_loss(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    _grads_close(pmodel, jgrads)


def check_round_trip(pmodel, params):
    """convert.py gives back the tree it loaded, leaf for leaf, lists (a
    Caser conv_h, NextItNet's blocks) and JAX layouts included."""
    tree = export_params(pmodel)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for got, ref in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(ref))


# ------------------------------------------------------------- the registry

def test_models_are_registered_and_routed():
    """get_model returns the nine; the full sort follows the JAX trainer's
    rule: the base stack takes the fused masked top-k, TransRec and FPMC
    (their own full_sort_predict) the non-fused step; the pairwise models
    train on one negative."""
    for name in MODELS:
        assert get_model(name).__name__ == name
    assert {n: fused_full_sort(get_model(n)) for n in MODELS} == {
        n: n in BASE_STACK for n in MODELS}
    for name in ("TransRec", "FPMC", "HGN"):
        assert get_model(name).default_config["training_neg_sample_num"] == 1


# ------------------------------------------------------------- the models

@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_scores_match_jax(case, synth_dataset_dir, tmp_path):
    """convert.py's round trip; calculate_loss and every leaf's gradient at
    rtol 2e-4 (of the leaf's largest value, or 1% of the largest
    gradient), then full_sort_predict, predict and score_items at rtol
    2e-4."""
    model, extra = CASES[case]
    jmodel, params, pmodel, ploaders = _seq_pair(model, tmp_path, synth_dataset_dir, **extra)
    check_round_trip(pmodel, params)
    batch = _batch(ploaders[0], model, case)
    check_loss_and_grads(jmodel, params, pmodel, batch)
    check_scores(jmodel, params, pmodel, batch)


@pytest.mark.parametrize("bias", [0.0, 0.1])
def test_caser_max_pool_ties_split_the_gradient(bias, synth_dataset_dir, tmp_path):
    """One horizontal filter with zero weights: bias 0 gives activations
    that are all zero; bias 0.1 gives the same positive activation at
    every position, a tie over the whole time axis, whose gradient
    torch.amax splits evenly as jnp.max does (torch.max(dim) would give it
    all to one position, and the weights' gradient would differ)."""
    jmodel, params, pmodel, ploaders = _seq_pair("Caser", tmp_path, synth_dataset_dir)
    params["conv_h"][2] = np.zeros_like(params["conv_h"][2])
    params["conv_h_b"][2] = np.full_like(params["conv_h_b"][2], bias)
    load_jax_params(pmodel, params)
    batch = _batch(ploaders[0], "Caser", "Caser")
    check_loss_and_grads(jmodel, params, pmodel, batch)
    g = pmodel.conv_h[2].grad
    assert (torch.count_nonzero(g) > 0) == (bias > 0)


def test_nextitnet_reads_the_last_position_of_short_rows(synth_dataset_dir, tmp_path):
    """Right-padded rows of 1, 2 and 3 items beside a full one: loss,
    gradients and scores equal the JAX model's, and the output is the last
    position's, which the pad rows reach through the causal stack (a row's
    scores change when the pad positions' outputs would be cut away)."""
    jmodel, params, pmodel, ploaders = _seq_pair("NextItNet", tmp_path, synth_dataset_dir,
                                                 block_num=2)
    batch = _batch(ploaders[0], "NextItNet", "NextItNet", n=8)
    lens = np.array([1, 2, 3, 10, 1, 2, 3, 5])
    seq = np.random.RandomState(4).randint(1, pmodel.n_items, (8, 10))
    seq[np.arange(10)[None, :] >= lens[:, None]] = 0
    batch["item_id_list"], batch["item_length"] = seq, lens
    check_loss_and_grads(jmodel, params, pmodel, batch)
    check_scores(jmodel, params, pmodel, batch)
    with torch.no_grad():
        out = pmodel.forward(_torch_batch(batch))
        x = pmodel.embed_seq(torch.as_tensor(seq))
        assert not torch.allclose(out[0], x[0, 0] @ pmodel.out_w + pmodel.out_b)


def test_hgn_bpr_scores_positives_and_negatives_on_two_tables(synth_dataset_dir, tmp_path):
    """Under BPR the positive's gradient lands in item_out_embedding alone
    and the negative's in item_embedding (beside the history's rows): the
    reference's quirk, as the JAX model keeps it."""
    jmodel, params, pmodel, ploaders = _seq_pair("HGN", tmp_path, synth_dataset_dir)
    batch = _batch(ploaders[0], "HGN", "BPR", n=16)
    seq_items = set(batch["item_id_list"].reshape(-1).tolist())
    pool = np.array(sorted(set(range(1, pmodel.n_items)) - seq_items))
    rng = np.random.RandomState(5)
    batch["item_id"] = rng.choice(pool[: len(pool) // 2], 16)
    batch["neg_item_id"] = rng.choice(pool[len(pool) // 2:], 16)
    check_loss_and_grads(jmodel, params, pmodel, batch)
    out_rows = set(torch.nonzero(pmodel.item_out_embedding.grad.abs().sum(1)).reshape(-1).tolist())
    seq_rows = set(torch.nonzero(pmodel.item_embedding.grad.abs().sum(1)).reshape(-1).tolist())
    assert out_rows == set(batch["item_id"].tolist())
    assert set(batch["neg_item_id"].tolist()) <= seq_rows <= (
        set(batch["neg_item_id"].tolist()) | seq_items)
    assert not seq_rows & set(batch["item_id"].tolist())


def test_transrec_pad_rows_stay_zero_through_adam(synth_dataset_dir, tmp_path):
    """An epoch of Adam steps leaves row 0 of TransRec's three
    pad_zero_params tables bit for bit, the 1-D item_bias's one element
    among them (its zero head is one element wide), and moves the rest."""
    pc = Config("TransRec", "synth", config_dict=_cfg(tmp_path, synth_dataset_dir),
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    train = data_preparation(pc, create_dataset(pc))[0]
    model = get_model("TransRec")(pc, train.dataset)
    with torch.no_grad():
        model.item_bias.add_(0.01)
        model.item_bias[0] = 0.0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(pc, model)
    assert trainer._zero_heads() == [8, 8, 0, 1]
    trainer.prepare(train)
    trainer._train_epoch(train, 0)
    for name in ("user_embedding", "item_embedding", "item_bias"):
        p = getattr(model, name)
        assert torch.equal(p[0], before[name][0]) and not torch.any(p[0]), name
        assert not torch.equal(p[1:], before[name][1:]), name
    assert not torch.equal(model.T, before["T"])


@pytest.mark.parametrize("model", BASE_STACK)
def test_fused_query_gives_the_non_fused_top_k(model, synth_dataset_dir, tmp_path):
    """full_sort_query's (query, table) through the masked top-k give the
    ids that full_sort_predict's masked scores give: NPE's table is ReLU of
    its item table, HGN's is item_out_embedding."""
    _, _, pmodel, ploaders = _seq_pair(model, tmp_path, synth_dataset_dir)
    batch = _torch_batch({k: v[:40] for k, v in ploaders[0].columns().items()})
    pmodel.eval()
    with torch.no_grad():
        q, table = pmodel.full_sort_query(batch)
        ref = (torch.relu(pmodel.item_embedding) if model == "NPE" else
               pmodel.item_out_embedding if model == "HGN" else pmodel.item_embedding)
        assert torch.equal(table, ref)
        uid = batch["user_id"]
        _, ids = masked_topk(q.contiguous(), table.contiguous(),
                             invalid_item_mask(uid, None, None, pmodel.n_items), 10)
        scores = history_masked_scores(pmodel.full_sort_predict(batch), uid, None, None)
        vals, want = torch.topk(scores, 11, dim=1)
    # the same scores in the same order; the same ids where no two of a
    # row's 11 best tie (a Caser row whose ReLU output is all zero scores
    # every item 0)
    torch.testing.assert_close(torch.gather(scores, 1, ids.long()), vals[:, :10],
                               rtol=1e-5, atol=1e-6)
    distinct = torch.all(vals[:, 1:] < vals[:, :-1], dim=1)
    assert distinct.sum() >= 20
    assert torch.equal(ids.long()[distinct], want[distinct, :10])


# ------------------------------------------------------------- end to end

@pytest.mark.parametrize("model", MODELS)
def test_run_recbole_on_cpu(model, synth_dataset_dir, tmp_path):
    """run_recbole with each model's default dropout on the synthetic set."""
    extra = {"block_num": 1} if model == "NextItNet" else {}
    result = run_recbole(model=model, dataset="synth", saved=True, config_dict=_cfg(
        tmp_path, synth_dataset_dir, epochs=2, dropout_prob=get_model(model).default_config.get(
            "dropout_prob", 0.0), **extra))
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert os.listdir(tmp_path / "saved")
