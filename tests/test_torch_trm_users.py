"""The transformer users BERT4Rec, SASRecF, FDSA, GCSAN and S3Rec on the
port against the JAX package: ``session_graph`` exact (repeated items
included), ``ItemFeatEmbedder`` for every pooling, the frozen feature
tables carried by ``convert.py``, each model's ``calculate_loss``, its
gradients and its full-sort scores at rtol 2e-4 (fp32, dropout off, the
cloze and pretraining draws the JAX model makes handed to the port; the
port through the whole-layer path's plain version, the JAX models through
their plain fp32 path), ``S3RecTrainer``'s two stages through the port's
own checkpoint, and ``run_recbole`` for each model on the CPU. Inputs come
from a numpy seed, parameters from the JAX initialisers."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.models.sequential import session_graph as jax_sg
from recbole_tpu.models.sequential.feat_embed import ItemFeatEmbedder as JaxEmbedder
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.models.sequential import session_graph as sg
from recbole_tpu_torch.models.sequential.feat_embed import ItemFeatEmbedder
from recbole_tpu_torch.trainer.trainer import S3RecTrainer, Trainer, get_trainer
from recbole_tpu_torch.utils.utils import init_seed

RTOL = 2e-4
L = 10
ITEMS = {"load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"], "item": "*"}}
SMALL = {"MAX_ITEM_LIST_LENGTH": L, "n_layers": 2, "n_heads": 2, "hidden_size": 16,
         "inner_size": 32}
# (model, extra config) of each case
CASES = {
    "BERT4Rec": ("BERT4Rec", {}),
    "SASRecF": ("SASRecF", ITEMS),
    "SASRecF-max": ("SASRecF", {**ITEMS, "pooling_mode": "max", "selected_features": ["genre"]}),
    "FDSA": ("FDSA", ITEMS),
    "GCSAN": ("GCSAN", {"n_layers": 1, "n_heads": 1, "step": 2}),
    "S3Rec-pretrain": ("S3Rec", {**ITEMS, "item_attribute": "genre"}),
    "S3Rec-finetune": ("S3Rec", {**ITEMS, "item_attribute": "genre", "train_stage": "finetune"}),
}


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


def _pair(model, tmp_path, data_path, **extra):
    """Both packages' loaders and models, dropout off and fp32; the JAX
    model on its plain path, the port's on the whole-layer path; the port
    loaded with the JAX initial weights, 1-D leaves moved off 0 and 1."""
    cfg = _cfg(tmp_path, data_path, hidden_dropout_prob=0.0, attn_dropout_prob=0.0,
               compute_dtype="float32", **extra)
    jc = JaxConfig(model, "synth", _parse_cmd_line=False,
                   config_dict={**cfg, "fused_attention": False})
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model(model)(jc, jloaders[0].dataset)
    params = jmodel.attach_consts(jmodel.zero_pad_rows(jmodel.init_params(jax.random.key(0))))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda v: (np.asarray(v) + 0.05 * rng.randn(*v.shape)).astype(
        np.float32) if v.ndim == 1 else np.asarray(v), params)
    pc = Config(model, "synth", config_dict={**cfg, "fused_attention": "layer2"},
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    pmodel = get_model(model)(pc, ploaders[0].dataset)
    load_jax_params(pmodel, params)
    return jmodel, params, pmodel, ploaders


def _batch(loader, n=64):
    cols = loader.columns()
    return {f: v[:n] for f, v in cols.items()}


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
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max()) / scale
    assert err <= tol, (what, err)


# ------------------------------------------------------------ the modules

@pytest.mark.parametrize("seed", [0, 1])
def test_session_graph_matches_jax_exactly(seed):
    """alias, a_in and a_out equal the JAX function's, bit for bit, on
    sequences with repeated items (an item back to back, an item again
    later, a cycle), padding, a one-item and an empty session."""
    rng = np.random.RandomState(seed)
    B, Ls = 12, 9
    seq = rng.randint(1, 5, (B, Ls))
    lens = rng.randint(1, Ls + 1, B)
    lens[0], lens[1], lens[2] = 1, 0, Ls
    seq[2, :6] = [3, 3, 2, 3, 1, 2]
    seq = np.where(np.arange(Ls)[None, :] < lens[:, None], seq, 0)
    ja, ji, jo = jax_sg.session_graph(jnp.asarray(seq), jnp.asarray(lens))
    pa, pi, po = sg.session_graph(torch.as_tensor(seq), torch.as_tensor(lens))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert pa[2, :6].tolist() == [0, 0, 2, 0, 4, 2]


def test_gnn_apply_matches_jax():
    """Two rounds of the gated GNN, with and without the edge biases,
    against gnn_apply at rtol 2e-4."""
    rng = np.random.RandomState(3)
    B, Ls, D = 6, 8, 12
    seq = rng.randint(1, 6, (B, Ls))
    lens = rng.randint(2, Ls + 1, B)
    hidden = rng.randn(B, Ls, D).astype(np.float32)
    ja, ji, jo = jax_sg.session_graph(jnp.asarray(seq), jnp.asarray(lens))
    for bias in (True, False):
        jp = jax.tree.map(lambda v: np.asarray(v) + 0.1, jax_sg.gnn_init(jax.random.key(1), D,
                                                                        bias_edges=bias))
        ref = jax_sg.gnn_apply(jp, ji, jo, jnp.asarray(hidden), 2)
        gnn = sg.SessionGNN(torch.Generator(), D, "cpu", bias_edges=bias)
        gnn.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
        got = sg.gnn_apply(gnn, torch.tensor(np.asarray(ji)), torch.tensor(np.asarray(jo)),
                           torch.tensor(hidden), 2)
        _close(got.detach().numpy(), ref, f"gnn bias={bias}")


def _datasets(tmp_path, data_path):
    cfg = _cfg(tmp_path, data_path, **ITEMS)
    jc = JaxConfig("SASRecF", "synth", config_dict=cfg, _parse_cmd_line=False)
    pc = Config("SASRecF", "synth", config_dict=cfg, _parse_cmd_line=False)
    return jax_create_dataset(jc), create_dataset(pc)


@pytest.mark.parametrize("pooling", ["mean", "max", "sum"])
def test_item_feat_embedder_matches_jax(pooling, synth_dataset_dir, tmp_path):
    """Every field of the synthetic item file (a token_seq genre, a float
    price), in selected_features order and in the dataset's: the aligned
    columns equal, and embed / embed_flat from the same tables, the id
    field from the caller's trainable table, at rtol 1e-6."""
    jds, pds = _datasets(tmp_path, synth_dataset_dir)
    ids = np.random.RandomState(4).randint(0, pds.item_num, (5, 7))
    for selected in (None, ["price", "genre"]):
        jemb = JaxEmbedder(jds, selected, pooling, include_item_id=True)
        pemb = ItemFeatEmbedder(pds, selected, pooling, include_item_id=True)
        pemb.init_tables(torch.Generator(), 8)
        tables = jax.tree.map(np.asarray, jemb.init(jax.random.key(2), 8, frozen_item_id=False))
        assert set(tables) == set(pemb.table_names())
        for name, v in tables.items():
            getattr(pemb, name).copy_(torch.tensor(v))
        item_table = np.random.RandomState(5).randn(pds.item_num, 8).astype(np.float32)
        jparams = {"item_embedding": jnp.asarray(item_table), "_const": tables}
        ref = np.asarray(jemb.embed_flat(jparams, jnp.asarray(ids)))
        got = pemb.embed_flat(torch.as_tensor(ids), torch.tensor(item_table))
        assert pemb.num_fields == jemb.num_fields == 3
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_frozen_tables_round_trip_through_convert(synth_dataset_dir, tmp_path):
    """SASRecF's and FDSA's frozen tables are persistent buffers that
    convert.py carries to and from the JAX tree's _const, that the
    checkpoint holds, and that no optimizer sees."""
    for model in ("SASRecF", "FDSA"):
        jmodel, params, pmodel, _ = _pair(model, tmp_path / model, synth_dataset_dir, **ITEMS)
        tree = export_params(pmodel)
        assert set(tree["_const"]) == {"feat_genre", "feat_price"}
        for k, v in params["_const"].items():
            np.testing.assert_array_equal(tree["_const"][k], v)
        state = pmodel.state_dict()
        assert "embedder.feat_genre" in state and "embedder.seq_genre" not in state
        assert not any(n.startswith("embedder.") for n, _ in pmodel.named_parameters())
        trainer = Trainer(pmodel.config, pmodel)
        assert set(trainer._state_buffers()) >= {"embedder.feat_genre", "embedder.feat_price"}


# ------------------------------------------------------------- the models

def _jax_draws(jmodel, batch, rng, case):
    """The draws the JAX model makes inside calculate_loss from ``rng``."""
    seq = batch["item_id_list"]
    if case == "BERT4Rec":
        _, km, _ = jax.random.split(rng, 3)
        return {"cloze": torch.tensor(np.asarray(jax.random.uniform(
            km, (seq.shape[0], seq.shape[1] + 1))))}
    if case == "S3Rec-pretrain":
        r_mask, r_neg, r_seg1, r_seg2, _ = jax.random.split(rng, 5)
        B, Ls = seq.shape
        return {"mask": torch.tensor(np.asarray(jax.random.uniform(r_mask, (B, Ls)))),
                "neg": torch.tensor(np.asarray(jax.random.randint(
                    r_neg, (B, Ls), 1, jmodel.n_items))).long(),
                "seg_len": torch.tensor(np.asarray(jax.random.uniform(r_seg1, (B,)))),
                "seg_start": torch.tensor(np.asarray(jax.random.uniform(r_seg2, (B,))))}
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_scores_match_jax(case, synth_dataset_dir, tmp_path):
    """calculate_loss and every parameter's gradient at rtol 2e-4 (of the
    leaf's largest value, or 1% of the largest gradient), the JAX model's
    cloze / pretraining draws injected; then full_sort_predict and
    score_items at rtol 2e-4."""
    model, extra = CASES[case]
    jmodel, params, pmodel, ploaders = _pair(model, tmp_path, synth_dataset_dir, **extra)
    if model == "S3Rec":
        # off its zeroed start, so that no attribute logit is exactly 0,
        # where the JAX model's BCE gradient is not the true one
        # (test_s3rec_bce_gradient_at_a_zero_logit_is_the_true_one)
        fe = params["feature_embedding"].copy()
        fe[0] = 0.05 * np.random.RandomState(1).randn(fe.shape[1])
        params["feature_embedding"] = fe
        load_jax_params(pmodel, params)
    batch = _batch(ploaders[0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    rng = jax.random.key(11)
    jparams = jax.tree.map(jnp.asarray, params)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, rng))(jparams)
    draws = _jax_draws(jmodel, batch, rng, case)
    if case == "BERT4Rec":
        loss = pmodel.calculate_loss(tbatch, cloze=draws["cloze"])
    elif case == "S3Rec-pretrain":
        loss = pmodel.pretrain_loss(tbatch["item_id_list"], tbatch["item_length"], draws)
    else:
        loss = pmodel.calculate_loss(tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    _grads_close(pmodel, jgrads)
    with torch.no_grad():
        _close(pmodel.full_sort_predict(tbatch).numpy(),
               np.asarray(jmodel.full_sort_predict(jparams, jbatch)), "full_sort_predict")
        cand = np.random.RandomState(6).randint(1, pmodel.n_items, (len(batch["item_length"]), 5))
        _close(pmodel.score_items(tbatch, torch.as_tensor(cand)).numpy(),
               np.asarray(jmodel.score_items(jparams, jbatch, jnp.asarray(cand))), "score_items")


def test_s3rec_bce_gradient_at_a_zero_logit_is_the_true_one():
    """S3Rec's attribute BCE, max(l, 0) - l t + log1p(exp(-|l|)), is
    log(1 + e^l) - l t, whose derivative is sigmoid(l) - t. At l = 0 (every
    position's logit for feature row 0, which starts and stays zero) the
    port gives that; the JAX model gives -t (jnp.abs's derivative at 0 is
    1), a fault the port does not copy."""
    from recbole_tpu_torch.models.sequential.s3rec import S3Rec
    t = torch.tensor([0.0, 1.0, 0.0, 1.0])
    logits = torch.tensor([0.0, 0.0, 0.3, -2.0], requires_grad=True)
    S3Rec._bce(logits, t).sum().backward()
    np.testing.assert_allclose(logits.grad.numpy(),
                               (torch.sigmoid(logits.detach()) - t).numpy(), rtol=1e-6)
    jgrad = jax.grad(lambda x: jnp.sum(jnp.maximum(x, 0) - x * jnp.asarray(t.numpy())
                                       + jnp.log1p(jnp.exp(-jnp.abs(x)))))(jnp.zeros(4))
    np.testing.assert_allclose(np.asarray(jgrad)[:2], -t.numpy()[:2])


def test_bert4rec_cloze_capacity_and_first_position():
    """M = ceil(L r + 6 sigma): 28 at the default 51 positions and ratio 0.2;
    a masked position 0 never scores, and the draw's rows keep their real
    items' count."""
    from recbole_tpu_torch.models.sequential.bert4rec import cloze_capacity
    assert cloze_capacity(51, 0.2) == 28
    assert cloze_capacity(4, 0.9) == 4


def test_transformer_users_run_the_fp32_instance_unless_bf16_is_named(synth_dataset_dir,
                                                                      tmp_path):
    """The five models pass no compute dtype to their encoders, as the JAX
    models do: compute_dtype auto keeps the encoder fp32, bfloat16 by name
    rounds its operands; S3Rec takes the non-fused full-sort step (its own
    full_sort_predict, the JAX trainer's rule), the other four the fused."""
    from recbole_tpu_torch.trainer.trainer import fused_full_sort
    for case in ("BERT4Rec", "SASRecF", "FDSA", "GCSAN", "S3Rec-pretrain"):
        model, extra = CASES[case]
        cfg = _cfg(tmp_path / case, synth_dataset_dir, **extra)
        pc = Config(model, "synth", config_dict=cfg, _parse_cmd_line=False)
        init_seed(pc["seed"])
        train = data_preparation(pc, create_dataset(pc))[0]
        auto = get_model(model)(pc, train.dataset)
        assert auto.trm_cdt is None and pc["fused_attention"] == "layer2"
        bf = get_model(model)(Config(model, "synth", _parse_cmd_line=False, config_dict={
            **cfg, "compute_dtype": "bfloat16"}), train.dataset)
        assert bf.trm_cdt == torch.bfloat16
        assert fused_full_sort(type(auto)) is (model != "S3Rec")


# ------------------------------------------------------------- end to end

def test_s3rec_trainer_pretrains_then_finetunes_from_its_checkpoint(synth_dataset_dir,
                                                                     tmp_path):
    """S3RecTrainer: pretraining runs its epochs with no validation and saves
    at save_step and at the last epoch; a finetuning model named with that
    checkpoint as pre_model_path starts from its parameters, and trains and
    evaluates through the normal fit."""
    cfg = _cfg(tmp_path, synth_dataset_dir, **ITEMS, item_attribute="genre", epochs=3,
               save_step=2)
    pc = Config("S3Rec", "synth", config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    train, valid, test = data_preparation(pc, create_dataset(pc))
    model = get_model("S3Rec")(pc, train.dataset)
    assert get_trainer(pc["MODEL_TYPE"], "S3Rec") is S3RecTrainer
    trainer = S3RecTrainer(pc, model)
    saved = []
    orig = trainer._save_checkpoint
    trainer._save_checkpoint = lambda epoch: (saved.append(epoch), orig(epoch))
    score, result = trainer.fit(train, valid)
    assert saved == [1, 2] and score is None and result is None
    assert len(trainer.train_loss_dict) == 3
    pc2 = Config("S3Rec", "synth", _parse_cmd_line=False, config_dict={
        **cfg, "train_stage": "finetune", "pre_model_path": trainer.saved_model_file,
        "epochs": 1})
    tuned = get_model("S3Rec")(pc2, train.dataset)
    for (n, a), b in zip(tuned.named_parameters(), model.parameters()):
        assert torch.equal(a, b), n
    trainer2 = get_trainer(pc2["MODEL_TYPE"], "S3Rec")(pc2, tuned)
    score, result = trainer2.fit(train, valid)
    assert score is not None and set(result) >= {"recall@10", "mrr@10"}


@pytest.mark.parametrize("case", ["BERT4Rec", "SASRecF", "FDSA", "GCSAN"])
def test_run_recbole_on_cpu(case, synth_dataset_dir, tmp_path):
    """run_recbole with each model's default dropout on the synthetic set."""
    model, extra = CASES[case]
    result = run_recbole(model=model, dataset="synth", saved=True,
                         config_dict=_cfg(tmp_path, synth_dataset_dir, epochs=2, **extra))
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())


def test_run_recbole_s3rec_both_stages_on_cpu(synth_dataset_dir, tmp_path):
    cfg = _cfg(tmp_path, synth_dataset_dir, **ITEMS, item_attribute="genre")
    run_recbole(model="S3Rec", dataset="synth", config_dict=cfg, saved=True)
    ckpt = max(glob.glob(str(tmp_path / "saved" / "S3Rec-*.ckpt")), key=os.path.getmtime)
    result = run_recbole(model="S3Rec", dataset="synth", saved=True, config_dict={
        **cfg, "train_stage": "finetune", "pre_model_path": ckpt})
    assert all(0.0 <= v <= 1.0 for v in result["test_result"].values())
