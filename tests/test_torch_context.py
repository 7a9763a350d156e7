"""The port's context (CTR) family against the JAX package's: DeepFM, FM and
LR from the same weights on the same batch, the nested parameter
conversion, dropout from an explicit generator, and the value metrics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.evaluator.metrics import VALUE_METRIC_FNS as JAX_VALUE_FNS
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import (export_params, flatten_tree, load_jax_params,
                                       unflatten_tree)
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.evaluator.metrics import VALUE_METRIC_FNS
from recbole_tpu_torch.models import get_model, model_names
from recbole_tpu_torch.models.layers import MLPLayers, activation, dropout_apply
from recbole_tpu_torch.utils.utils import init_seed

SIDE = {
    "dataset": "synth", "threshold": {"rating": 4}, "normalize_all": True,
    "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"],
                 "user": ["user_id", "age", "gender", "interests"],
                 "item": ["item_id", "genre", "price"]},
}
PURE = {
    "dataset": "criteo", "USER_ID_FIELD": None, "ITEM_ID_FIELD": None,
    "LABEL_FIELD": "label", "load_col": {"inter": "*"},
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pure_feature_dir(tmp_path_factory):
    """A Criteo-style file with no user or item id columns
    (tests/test_context.py:35-52)."""
    root = tmp_path_factory.mktemp("criteo")
    d = root / "criteo"
    d.mkdir()
    rng = np.random.RandomState(0)
    with open(d / "criteo.inter", "w") as fh:
        fh.write("label:float\tI1:float\tI2:float\tC1:token\tC2:token\n")
        for _ in range(600):
            c1, c2 = rng.randint(0, 20), rng.randint(0, 50)
            x1 = rng.random_sample()
            y = int(x1 + 0.3 * (c1 % 2) + 0.2 * rng.random_sample() > 0.75)
            fh.write(f"{y}\t{x1:.4f}\t{rng.random_sample():.4f}\tc{c1}\tv{c2}\n")
    return str(root)


def _pair(model, kind, synth_dataset_dir, pure_feature_dir, tmp_path, **extra):
    """The JAX model with its seeded params, the port's model loaded with
    them, and one training batch of 128 rows as numpy columns."""
    base = SIDE if kind == "side" else PURE
    cfg = {**base, "data_path": synth_dataset_dir if kind == "side" else pure_feature_dir,
           "device": "cpu", "state": "ERROR", "dropout_prob": 0.0,
           "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
           **extra}
    jc = JaxConfig(model, cfg["dataset"], config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])     # the random split draws from numpy's global stream
    jtrain, _, _ = jax_data_preparation(jc, jax_create_dataset(jc))
    jm = jax_get_model(model)(jc, jtrain.dataset)
    params = jm.init_params(jax.random.key(0))
    # the bias column and the zero-initialised leaves start at 0: randomise
    # every leaf so each gradient path carries signal
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + (0.05 * rng.standard_normal(a.shape)).astype(np.float32)),
        params)
    pc = Config(model, cfg["dataset"], config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    ptrain, _, _ = data_preparation(pc, create_dataset(pc))
    pm = get_model(model)(pc, ptrain.dataset)
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    cols = ptrain.columns()
    idx = np.random.RandomState(2).randint(0, ptrain.n, 128)
    batch = {f: v[idx] for f, v in cols.items()}
    for f, v in jtrain.columns().items():
        np.testing.assert_array_equal(v[idx], batch[f])
    return jm, params, pm, batch


def _tbatch(batch):
    return {f: torch.as_tensor(v).to(torch.int64 if np.issubdtype(v.dtype, np.integer)
                                     else torch.float32) for f, v in batch.items()}


def test_context_models_are_registered():
    assert {"BPR", "DeepFM", "FM", "LR"} <= set(model_names())


@pytest.mark.parametrize("kind", ["side", "pure"])
@pytest.mark.parametrize("model", ["DeepFM", "FM", "LR"])
def test_ctr_logits_loss_and_gradients_match_jax(model, kind, synth_dataset_dir,
                                                 pure_feature_dir, tmp_path):
    """Same params (copied through convert), same batch, dropout 0:
    predictions, loss and the gradient of every leaf at rtol 2e-4 (the bar
    of tests/test_loss_parity_vs_reference.py). atol 1e-6 covers leaves whose
    gradient sums terms of both signs. On the CPU the JAX lookup is the
    plain gather with XLA's scatter-add backward; the port's goes through
    GroupedTakeRows."""
    jm, params, pm, batch = _pair(model, kind, synth_dataset_dir, pure_feature_dir, tmp_path)
    if kind == "side":
        assert pm.token_seq_fields and pm.float_fields and len(pm.token_fields) >= 3
    assert [f for f, *_ in pm.token_fields] == [f for f, *_ in jm.token_fields]
    assert [f for f, *_ in pm.float_fields] == [f for f, *_ in jm.float_fields]
    jbatch = {f: jnp.asarray(v) for f, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jm.calculate_loss(p, jbatch))(params)
    tbatch = _tbatch(batch)
    pm.train()
    loss = pm.calculate_loss(tbatch, generator=torch.Generator().manual_seed(0))
    names = list(dict(pm.named_parameters()))
    grads = torch.autograd.grad(loss, list(pm.parameters()), allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    jflat = flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(names)
    for name, g in zip(names, grads):
        ref = jflat[name]
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6, err_msg=name)
    pm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(pm.predict(tbatch).numpy(),
                                   np.asarray(jm.predict(params, jbatch)),
                                   rtol=2e-4, atol=1e-6)


def test_deepfm_convert_round_trip_is_identity(synth_dataset_dir, pure_feature_dir, tmp_path):
    """JAX tree -> port -> JAX tree, leaf for leaf, list of layer dicts
    included; a missing leaf, an extra leaf and a wrong shape raise."""
    _, params, pm, _ = _pair("DeepFM", "side", synth_dataset_dir, pure_feature_dir, tmp_path)
    tree = jax.tree.map(np.asarray, params)
    out = export_params(pm)
    assert isinstance(out["mlp"], list) and set(out["mlp"][0]) == {"w", "b"}
    assert jax.tree.structure(out) == jax.tree.structure(tree)
    for got, ref in zip(jax.tree.leaves(out), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, ref)
    assert out["first_order_bias"].shape == ()
    assert unflatten_tree(flatten_tree(tree)).keys() == tree.keys()
    missing = {k: v for k, v in tree.items() if k != "deep_out_b"}
    with pytest.raises(KeyError):
        load_jax_params(pm, missing)
    with pytest.raises(KeyError):
        load_jax_params(pm, {**tree, "extra": np.zeros(3, np.float32)})
    bad = dict(tree)
    bad["mlp"] = [dict(layer) for layer in tree["mlp"]]
    bad["mlp"][1]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="mlp.1.w"):
        load_jax_params(pm, bad)


def test_port_context_init(synth_dataset_dir, pure_feature_dir, tmp_path):
    """The merged table: xavier on the (V, D) part, a zero bias column; the
    zero-initialised leaves; one seed gives one init."""
    cfg = {**SIDE, "data_path": synth_dataset_dir, "device": "cpu", "state": "ERROR",
           "log_dir": str(tmp_path / "log")}
    pc = Config("DeepFM", "synth", config_dict=cfg, _parse_cmd_line=False)
    train, _, _ = data_preparation(pc, create_dataset(pc))
    a = get_model("DeepFM")(pc, train.dataset)
    b = get_model("DeepFM")(pc, train.dataset)
    V, D = a.token_vocab_total, a.embedding_size
    assert tuple(a.token_embedding.shape) == (V, D + 1)
    assert torch.count_nonzero(a.token_embedding[:, -1]) == 0
    assert abs(float(a.token_embedding.detach()[:, :-1].std()) - np.sqrt(2.0 / (V + D))) < 2e-2
    for name in ("float_weight", "seq_bias", "first_order_bias", "deep_out_b"):
        assert torch.count_nonzero(getattr(a, name)) == 0
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)


# ------------------------------------------------------------------- dropout

def test_dropout_keep_rate_scale_and_generator():
    """Keep rate within 3 sigma of 1 - rate, kept values scaled by 1/keep,
    the same generator state gives the same mask."""
    x = torch.ones(200, 500)
    rate, n = 0.2, 200 * 500
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    y = dropout_apply(gen, x, rate)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) <= 3 * np.sqrt(0.8 * 0.2 / n)
    torch.testing.assert_close(y[kept], torch.full((int(kept.sum()),), 1.0 / 0.8))
    gen.set_state(state)
    assert torch.equal(dropout_apply(gen, x, rate), y)
    assert not torch.equal(dropout_apply(gen, x, rate), y)   # the state moved on


def test_mlp_dropout_only_in_train_mode_with_a_generator():
    gen = torch.Generator().manual_seed(0)
    mlp = MLPLayers(gen, [16, 8, 4], torch.device("cpu"), act="relu", dropout=0.5)
    assert [n for n, _ in mlp.named_parameters()] == ["0.w", "0.b", "1.w", "1.b"]
    x = torch.randn(32, 16, generator=gen)
    mlp.eval()
    ref = mlp(x, generator=gen)
    assert torch.equal(ref, mlp(x, generator=gen))             # eval: the identity
    mlp.train()
    assert torch.equal(ref, mlp(x))                            # no generator: none
    state = gen.get_state()
    dropped = mlp(x, generator=gen)
    assert not torch.equal(dropped, ref)
    gen.set_state(state)
    assert torch.equal(dropped, mlp(x, generator=gen))


def test_mlp_matches_jax_mlp_apply():
    """With and without batch norm, gelu (the erf form): rtol 1e-5."""
    from recbole_tpu.models.layers import mlp_apply, mlp_init
    for bn, act in ((False, "gelu"), (True, "relu"), (False, "leakyrelu")):
        jp = mlp_init(jax.random.key(3), [12, 9, 5], bn=bn)
        mlp = MLPLayers(torch.Generator().manual_seed(0), [12, 9, 5], torch.device("cpu"),
                        act=act, bn=bn)
        with torch.no_grad():
            for path, leaf in flatten_tree(jax.tree.map(np.asarray, jp)).items():
                dict(mlp.named_parameters())[path].copy_(torch.from_numpy(leaf.copy()))
        x = np.random.RandomState(0).randn(20, 12).astype(np.float32)
        np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(mlp_apply(jp, jnp.asarray(x), act=act)),
                                   rtol=1e-5, atol=1e-6)
    x = torch.linspace(-3, 3, 50)
    torch.testing.assert_close(activation("gelu")(x),
                               0.5 * x * (1 + torch.erf(x / np.sqrt(2.0))))


# ------------------------------------------------------------- value metrics

@pytest.mark.parametrize("ties", [False, True])
def test_value_metrics_match_jax(ties):
    """AUC (average ranks over ties), LogLoss (eps 1e-7), MAE and RMSE on
    seeded arrays against the JAX functions: rtol 1e-6."""
    rng = np.random.RandomState(11)
    n = 1500
    trues = (rng.random_sample(n) < 0.3).astype(np.float32)
    preds = rng.random_sample(n).astype(np.float32)
    if ties:
        preds = np.round(preds, 1)            # eleven values: long runs of ties
        preds[:5] = [0.0, 1.0, 0.0, 1.0, 1.0]  # the clip of log_loss_ is exercised
    for name, fn in VALUE_METRIC_FNS.items():
        got = fn(torch.from_numpy(trues), torch.from_numpy(preds))
        ref = JAX_VALUE_FNS[name](jnp.asarray(trues), jnp.asarray(preds))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, err_msg=name)
    # AUC against its definition: P(pos > neg) + P(tie) / 2
    pos, neg = preds[trues > 0], preds[trues == 0]
    exact = ((pos[:, None] > neg[None, :]).mean()
             + 0.5 * (pos[:, None] == neg[None, :]).mean())
    auc = VALUE_METRIC_FNS["auc"](torch.from_numpy(trues), torch.from_numpy(preds))
    np.testing.assert_allclose(float(auc), exact, rtol=1e-5)
