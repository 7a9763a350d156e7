"""FFM, FwFM, FNN, WideDeep and xDeepFM on the port against the JAX
package: from the same weights (carried by ``convert.py``) on the same
batch, with dropout off, the loss, the gradient of every leaf and the
predictions at rtol 2e-4, on the synthetic set's side features (token,
float and token_seq fields) and on a pure-feature file; xDeepFM in the
split and the direct variant, with odd ``cin_layer_size`` and with trained
CIN weights; xDeepFM's frozen CIN unchanged bit for bit by Adam steps and
carried through ``convert.py`` and a checkpoint; and ``run_recbole`` for
each model on the CPU. FwFM is held to the JAX package only: the
reference resamples its pair weights on every call."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.convert import export_params, flatten_tree
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.trainer.trainer import Trainer
# _one_thread, pure_feature_dir and _port_logger: the fixtures, imported so
# that pytest finds them here
from tests.test_torch_context import (SIDE, _one_thread, _pair,  # noqa: F401
                                      _tbatch, pure_feature_dir)
from tests.test_torch_seq_rest import _port_logger  # noqa: F401

MODELS = ("FFM", "FwFM", "FNN", "WideDeep", "xDeepFM")
SMALL = {"mlp_hidden_size": [16, 8], "cin_layer_size": [6, 4], "embedding_size": 6}
# (model, extra config) of each case
CASES = {
    "FFM": ("FFM", {}),
    "FwFM": ("FwFM", {}),
    "FNN": ("FNN", {}),
    "WideDeep": ("WideDeep", {}),
    "xDeepFM": ("xDeepFM", {}),
    "xDeepFM-direct": ("xDeepFM", {"direct": True, "cin_layer_size": [5, 3, 4]}),
    "xDeepFM-odd-split": ("xDeepFM", {"cin_layer_size": [7, 5, 3]}),
    "xDeepFM-trained-cin": ("xDeepFM", {"train_cin_weights": True}),
}


def _check(model, extra, kind, synth_dataset_dir, pure_feature_dir, tmp_path):
    jm, params, pm, batch = _pair(model, kind, synth_dataset_dir, pure_feature_dir, tmp_path,
                                  **{**SMALL, **extra})
    tree = export_params(pm)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for got, ref in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    jbatch = {f: jnp.asarray(v) for f, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jm.calculate_loss(p, jbatch))(params)
    tbatch = _tbatch(batch)
    pm.train()
    loss = pm.calculate_loss(tbatch, generator=torch.Generator().manual_seed(0))
    names = list(dict(pm.named_parameters()))
    grads = torch.autograd.grad(loss, list(pm.parameters()), allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    jflat = flatten_tree(jax.tree.map(np.asarray, {k: v for k, v in jgrads.items()
                                                   if k != "_const"}))
    assert set(jflat) == set(names)
    for name, g in zip(names, grads):
        ref = jflat[name]
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6, err_msg=name)
    pm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(pm.predict(tbatch).numpy(),
                                   np.asarray(jm.predict(params, jbatch)), rtol=2e-4, atol=1e-6)
    return jm, params, pm


def test_models_are_registered():
    for name in MODELS:
        assert get_model(name).model_name == name


@pytest.mark.parametrize("kind", ["side", "pure"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_predictions_match_jax(case, kind, synth_dataset_dir,
                                                  pure_feature_dir, tmp_path):
    """convert.py's round trip (xDeepFM's _const.cin, FFM's 3-D table,
    FwFM's pair_weight, the mlp lists); then, same params, same batch,
    dropout 0: loss, every leaf's gradient and
    predict at rtol 2e-4 (atol 1e-6 for the leaves whose gradient sums
    terms of both signs). On the side set FFM's token_seq field takes its
    pooled embedding for every field."""
    model, extra = CASES[case]
    _, params, pm = _check(model, extra, kind, synth_dataset_dir, pure_feature_dir, tmp_path)
    if model == "FFM":
        assert tuple(pm.ffm_token_embedding.shape) == (pm.token_vocab_total, pm.num_fields,
                                                       pm.embedding_size)
        assert bool(pm.token_seq_fields) == (kind == "side")
    if case == "xDeepFM-odd-split":
        # 7 and 5 round down to 6 and 4: halves of 3 and 2 feed on, the
        # last layer keeps its 2
        assert pm.cin_sizes == [6, 4, 2]
        assert [tuple(layer.w.shape) for layer in pm.cin] == [
            (pm.num_fields ** 2, 6), (pm.num_fields * 3, 4), (pm.num_fields * 2, 2)]
        assert tuple(pm.cin_out_w.shape) == (3 + 2 + 2, 1)
    if case == "xDeepFM-direct":
        assert tuple(pm.cin_out_w.shape) == (12, 1)


def test_xdeepfm_frozen_cin_stays_and_is_carried(synth_dataset_dir, pure_feature_dir,
                                                 tmp_path):
    """The frozen CIN weights are persistent buffers: no optimizer sees
    them, convert.py gives them back under the JAX tree's _const.cin, an
    epoch of Adam steps leaves them bit for bit (and moves the trained
    leaves), and a checkpoint carries them into a fresh model."""
    _, _, pm, _ = _pair("xDeepFM", "side", synth_dataset_dir, pure_feature_dir, tmp_path,
                             **SMALL)
    assert not any(n.startswith("cin.") for n, _ in pm.named_parameters())
    assert len(export_params(pm)["_const"]["cin"]) == 2
    frozen = {n: b.clone() for n, b in pm.named_buffers() if n.startswith("cin.")}
    assert set(frozen) == {"cin.0.w", "cin.0.b", "cin.1.w", "cin.1.b"}
    trained = {n: p.detach().clone() for n, p in pm.named_parameters()}
    trainer = Trainer(pm.config, pm)
    assert set(trainer._state_buffers()) == set(pm.const_state_map().values()) == set(frozen)
    train = data_preparation(pm.config, create_dataset(pm.config))[0]
    trainer.prepare(train)
    trainer._train_epoch(train, 0)
    for n, b in pm.named_buffers():
        if n in frozen:
            assert torch.equal(b, frozen[n]), n
    moved = dict(pm.named_parameters())
    assert not torch.equal(moved["cin_out_w"], trained["cin_out_w"])
    assert not torch.equal(moved["mlp.0.w"], trained["mlp.0.w"])
    (tmp_path / "saved").mkdir(exist_ok=True)
    trainer._save_checkpoint(0)
    fresh = get_model("xDeepFM")(pm.config, train.dataset)
    with torch.no_grad():
        for b in fresh.cin.buffers():
            b.zero_()
    Trainer(pm.config, fresh)._load_params(torch.load(trainer.saved_model_file,
                                                      weights_only=False))
    for n, b in fresh.named_buffers():
        if n in frozen:
            assert torch.equal(b, frozen[n]), n
    for n, p in fresh.named_parameters():
        assert torch.equal(p, moved[n]), n


@pytest.mark.parametrize("model", MODELS)
def test_run_recbole_on_cpu(model, synth_dataset_dir, tmp_path):
    """run_recbole at each model's default dropout on the synthetic set's
    CTR protocol: the value metrics in range."""
    result = run_recbole(model=model, dataset="synth", saved=True, config_dict={
        **SIDE, **SMALL, "data_path": synth_dataset_dir, "device": "cpu", "epochs": 2,
        "train_batch_size": 256, "state": "ERROR",
        "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log")})
    tr = result["test_result"]
    assert set(tr) == {"auc", "logloss"}
    assert 0.0 <= tr["auc"] <= 1.0 and np.isfinite(tr["logloss"])
