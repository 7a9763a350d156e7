"""The port's config, dataset, splits, loaders and sampler against the JAX
package's, on the synthetic dataset and on the bundled ml-100k. Remaps,
splits and masks are held exactly."""

import enum

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.sampler.sampler import sample_negatives as jax_sample_negatives
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.data.atomic import read_atomic_file
from recbole_tpu_torch.data.loaders import FullSortEvalLoader, SampledEvalLoader
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.sampler.sampler import first_non_colliding, sample_negatives
from recbole_tpu_torch.trainer.trainer import build_optimizer
from recbole_tpu_torch.utils import utils as port_utils
from recbole_tpu_torch.utils.utils import init_seed


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config_dict(tmp_path, data_path=None):
    d = {"epochs": 1, "state": "ERROR", "valid_full_to_uni1000": False,
         "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
         "device": "cpu"}
    if data_path:
        d["data_path"] = data_path
    return d


def _norm(value):
    """Enums of the two packages compare by name."""
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    return value


def _both(dataset, cfg):
    jc = JaxConfig("BPR", dataset, config_dict=cfg, _parse_cmd_line=False)
    pc = Config("BPR", dataset, config_dict=cfg, _parse_cmd_line=False)
    return jc, pc


@pytest.mark.parametrize("dataset", ["synth", "ml-100k"])
def test_config_matches_jax(dataset, synth_dataset_dir, tmp_path):
    cfg = _config_dict(tmp_path, synth_dataset_dir if dataset == "synth" else None)
    jc, pc = _both(dataset, cfg)
    j = {k: _norm(v) for k, v in jc.final.items() if k != "device"}
    p = {k: _norm(v) for k, v in pc.final.items() if k != "device"}
    assert j == p
    assert pc["device"] == "cpu"
    assert Config("BPR", dataset, config_dict={**cfg, "device": None},
                  _parse_cmd_line=False)["device"] == "cuda"


@pytest.mark.parametrize("dataset", ["synth", "ml-100k"])
def test_dataset_splits_and_loaders_match_jax(dataset, synth_dataset_dir, tmp_path):
    cfg = _config_dict(tmp_path, synth_dataset_dir if dataset == "synth" else None)
    jc, pc = _both(dataset, cfg)
    jax_init_seed(jc["seed"])
    jds = jax_create_dataset(jc)
    jtrain, jvalid, jtest = jax_data_preparation(jc, jds)
    init_seed(pc["seed"])
    pds = create_dataset(pc)
    ptrain, pvalid, ptest = data_preparation(pc, pds)

    assert set(jds.field2id_token) == set(pds.field2id_token)
    for f, toks in jds.field2id_token.items():
        np.testing.assert_array_equal(toks, pds.field2id_token[f])
    assert set(jds.inter_feat) == set(pds.inter_feat)
    for f, col in jds.inter_feat.items():
        np.testing.assert_array_equal(col, pds.inter_feat[f])
    for jl, pl in ((jtrain, ptrain), (jvalid, pvalid), (jtest, ptest)):
        for f, col in jl.dataset.inter_feat.items():
            np.testing.assert_array_equal(col, pl.dataset.inter_feat[f])
    for f, col in jtrain.columns().items():
        np.testing.assert_array_equal(col, ptrain.columns()[f])
    for jl, pl in ((jvalid, pvalid), (jtest, ptest)):
        assert jl.batch_size == pl.batch_size
        for attr in ("users", "pos_items", "pos_len"):
            np.testing.assert_array_equal(getattr(jl, attr), getattr(pl, attr))
        for jb, pb in zip(jl, pl):
            assert set(jb) == set(pb)
            for k in jb:
                np.testing.assert_array_equal(jb[k], pb[k])
    for phase in ("train", "valid", "test"):
        np.testing.assert_array_equal(jtrain.phase_history.history[phase],
                                      ptrain.phase_history.history[phase])
        np.testing.assert_array_equal(jtrain.phase_history.hist_len[phase],
                                      ptrain.phase_history.hist_len[phase])


def test_sampler_choice_matches_jax():
    """Given the candidates the JAX sampler draws from its key, the port's
    choice picks what sample_negatives (sampler.py:111-120) picks."""
    rng = np.random.RandomState(0)
    n_users, n_items, H, B, k, rounds = 20, 30, 12, 64, 3, 4
    lens = rng.randint(0, H + 1, n_users)
    hist = np.zeros((n_users, H), np.int32)
    for u in range(n_users):
        hist[u, :lens[u]] = rng.choice(np.arange(1, n_items), lens[u], replace=False)
    users = rng.randint(0, n_users, B).astype(np.int32)
    key = jax.random.key(3, impl="threefry2x32")
    cand = jax.random.randint(key, (rounds, B, k), 1, n_items, dtype=jnp.int32)
    jax_neg = jax_sample_negatives(key, jnp.asarray(users), jnp.asarray(hist),
                                   jnp.asarray(lens), n_items, k, rounds=rounds)
    port_neg = first_non_colliding(torch.as_tensor(np.array(cand)).long(),
                                   torch.as_tensor(users).long(),
                                   torch.as_tensor(hist).long(),
                                   torch.as_tensor(lens).long())
    np.testing.assert_array_equal(port_neg.numpy(), np.asarray(jax_neg))
    # some candidates collided, so the choice was exercised
    assert (np.asarray(cand)[0] != np.asarray(jax_neg)).any()


@pytest.mark.parametrize("distribution", ["uniform", "popularity"])
def test_sampled_negatives_avoid_history(distribution):
    rng = np.random.RandomState(1)
    n_users, n_items, H = 50, 400, 40
    lens = rng.randint(1, H + 1, n_users)
    hist = np.zeros((n_users, H), np.int64)
    for u in range(n_users):
        hist[u, :lens[u]] = rng.choice(np.arange(1, n_items), lens[u], replace=False)
    users = torch.as_tensor(rng.randint(0, n_users, 2048))
    pop = None
    if distribution == "popularity":
        pop = torch.as_tensor(rng.randint(1, 200, 5000))
    gen = torch.Generator().manual_seed(0)
    negs = sample_negatives(gen, users, torch.as_tensor(hist), torch.as_tensor(lens),
                            n_items, 2, rounds=8, pop_items=pop)
    assert negs.shape == (2048, 2)
    assert int(negs.min()) >= 1 and int(negs.max()) < (n_items if pop is None else 200)
    for b, u in enumerate(users.tolist()):
        assert not set(negs[b].tolist()) & set(hist[u, :lens[u]].tolist())


def test_unported_paths_raise(synth_dataset_dir, tmp_path, monkeypatch):
    cfg = _config_dict(tmp_path, synth_dataset_dir)
    pc = Config("BPR", "synth", config_dict={**cfg, "valid_full_to_uni1000": True},
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    # the fork's validation override builds the uniform-1000 sampled loader;
    # the test split keeps full sort
    _, valid, test = data_preparation(pc, create_dataset(pc))
    assert type(valid) is SampledEvalLoader and type(test) is FullSortEvalLoader
    assert (valid.neg_k, valid.distribution) == (1000, "uniform")
    assert valid.num_candidates == valid.max_pos * 1001
    # the other learners and the clip build since they were ported
    opt = build_optimizer(Config("BPR", "synth", _parse_cmd_line=False,
                                 config_dict={**cfg, "learner": "sgd", "clip_grad_norm": 5.0}))
    assert (opt["learner"], opt["max_norm"]) == ("sgd", 5.0)
    assert build_optimizer(Config("BPR", "synth", config_dict={**cfg, "weight_decay": 1e-4},
                                  _parse_cmd_line=False))["weight_decay"] == 1e-4
    with pytest.raises(NotImplementedError, match="native"):
        read_atomic_file(f"{synth_dataset_dir}/synth/synth.inter", native=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_utils.init_device(Config("BPR", "synth", config_dict={**cfg, "device": "cuda"},
                                      _parse_cmd_line=False))
    assert port_utils.init_device(pc) == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        port_utils.init_device(Config("BPR", "synth", _parse_cmd_line=False,
                                      config_dict={**cfg, "mesh_shape": {"data": 2}}))
    assert not torch.backends.cuda.matmul.allow_tf32


# ------------------------------------------------------ the context (CTR) path

_CTR = {"threshold": {"rating": 4}, "normalize_all": True,
        "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"],
                     "user": ["user_id", "age", "gender", "interests"],
                     "item": ["item_id", "genre", "price"]}}


def _ctr_loaders(model, dataset, cfg):
    jc = JaxConfig(model, dataset, config_dict=cfg, _parse_cmd_line=False)
    pc = Config(model, dataset, config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    return jc, pc, jloaders, ploaders


def _same_row_loaders(jloaders, ploaders):
    jtrain, ptrain = jloaders[0], ploaders[0]
    assert set(jtrain.columns()) == set(ptrain.columns())
    for f, v in jtrain.columns().items():
        np.testing.assert_array_equal(v, ptrain.columns()[f], err_msg=f)
    for jl, pl in zip(jloaders[1:], ploaders[1:]):
        assert type(pl).__name__ == type(jl).__name__ == "RowEvalLoader"
        assert (pl.n, pl.batch_size, len(pl)) == (jl.n, jl.batch_size, len(jl))
        assert pl.batch_size >= 65536           # the value-metric batch floor
        for jb, pb in zip(jl, pl):
            assert set(jb) == set(pb)
            for f in jb:
                np.testing.assert_array_equal(jb[f], pb[f], err_msg=f)


def test_ctr_config_and_row_loaders_match_jax(synth_dataset_dir, tmp_path):
    """DeepFM's config (its defaults, the CONTEXT quick-start overrides) and
    the labeled train table and value-metric eval batches, exactly."""
    cfg = {**_config_dict(tmp_path, synth_dataset_dir), **_CTR}
    jc, pc, jloaders, ploaders = _ctr_loaders("DeepFM", "synth", cfg)
    j = {k: _norm(v) for k, v in jc.final.items() if k != "device"}
    p = {k: _norm(v) for k, v in pc.final.items() if k != "device"}
    assert j == p
    assert pc["metrics"] == ["AUC", "LogLoss"] and pc["valid_metric"] == "AUC"
    assert pc["mlp_hidden_size"] == [128, 128, 128] and pc["dropout_prob"] == 0.2
    _same_row_loaders(jloaders, ploaders)
    assert set(ploaders[0].columns()) == {"user_id", "item_id", "timestamp", "label"}


def test_pure_feature_dataset_matches_jax(tmp_path):
    """USER_ID_FIELD: ~ (the Criteo/Avazu protocol): no id columns, empty
    phase histories, the same rows in the same splits."""
    d = tmp_path / "criteo" / "criteo"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    with open(d / "criteo.inter", "w") as fh:
        fh.write("label:float\tI1:float\tC1:token\tC2:token\n")
        for _ in range(300):
            fh.write(f"{rng.randint(0, 2)}\t{rng.random_sample():.4f}\t"
                     f"c{rng.randint(0, 20)}\tv{rng.randint(0, 50)}\n")
    cfg = {**_config_dict(tmp_path, str(tmp_path / "criteo")),
           "USER_ID_FIELD": None, "ITEM_ID_FIELD": None, "LABEL_FIELD": "label",
           "load_col": {"inter": "*"}}
    _, _, jloaders, ploaders = _ctr_loaders("FM", "criteo", cfg)
    _same_row_loaders(jloaders, ploaders)
    ptrain = ploaders[0]
    assert set(ptrain.columns()) == {"label", "I1", "C1", "C2"}
    assert ptrain.phase_history.history["train"].shape[1] in (0, 1)
    assert int(ptrain.phase_history.hist_len["test"].sum()) == 0
    for field in ("C1", "C2"):
        assert ptrain.dataset.num(field) == jloaders[0].dataset.num(field)
