"""The port's GRU slice against the JAX package's: the recurrence's plain
version against the Pallas kernel in interpret mode and against the
``lax.scan`` of ``gru_apply`` (forward and gradients, fp32 and bf16, one and
two layers); GRU4Rec's and NARM's losses and gradients; five trainer steps
and full-sort metrics (GRU4Rec on the fused top-k route, NARM on the
non-fused one); end-to-end runs and checkpoint resume. Inputs come from a
numpy seed, parameters from the JAX initialisers through ``convert``.
``fused_gru``'s own VJP is never used: it raises under the installed JAX
(ROADMAP Queue 3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.models import layers as jax_layers
from recbole_tpu.ops.fused_gru import fused_gru as jax_fused_gru
from recbole_tpu.trainer.trainer import Trainer as JaxTrainer
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model, layers
from recbole_tpu_torch.models.general.bpr import BPR
from recbole_tpu_torch.models.general.lightgcn import LightGCN
from recbole_tpu_torch.models.sequential.gru4rec import GRU4Rec
from recbole_tpu_torch.models.sequential.narm import NARM
from recbole_tpu_torch.models.sequential.sasrec import SASRec
from recbole_tpu_torch.ops import fused_gru as fg
from recbole_tpu_torch.trainer import trainer as trainer_mod
from recbole_tpu_torch.trainer.trainer import Trainer, fused_full_sort
from recbole_tpu_torch.utils.utils import init_seed

B, L, DIN, H = 8, 9, 12, 16
SEQ_L, SEQ_E, SEQ_H = 8, 16, 24

# bf16 instance against gru_apply(compute_dtype=bfloat16): both round xi, h,
# wh and the outputs at the same places, but JAX's autodiff rounds each
# step's dwh contribution to bf16 and recomputes the gates from the fp32
# carry, where the plain version sums dwh in fp32 and reads the bf16 outputs
# (the kernels' choice, csrc/fused_gru.cu). Largest |difference| over the
# tensor's largest |value|; measured 8e-4 (dbh) to 6.4e-3 (dx through two
# layers).
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32)).max()) / scale
    assert err <= tol, (what, err)


def _gru_inputs(seed, n_layers=1, din=DIN, h0=False):
    """x, a cotangent, h0 and the JAX initialiser's layers with the biases
    moved off 0."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jax_layers.gru_init(jax.random.key(seed), din, H,
                                                          n_layers))
    for layer in params:
        for k in ("bi", "bh"):
            layer[k] = (0.1 * rng.randn(3 * H)).astype(np.float32)
    x = rng.randn(B, L, din).astype(np.float32)
    dy = rng.randn(B, L, H).astype(np.float32)
    hinit = (0.5 * rng.randn(B, H) if h0 else np.zeros((B, H))).astype(np.float32)
    return x, dy, hinit, params


# ----------------------------------------------------------- the recurrence

@pytest.mark.parametrize("h0", [False, True])
def test_plain_fp32_forward_matches_pallas_interpret(h0):
    """fused_gru_torch, fp32, against fused_gru(interpret=True) at the JAX
    test's own bound (rtol 1e-5, atol 1e-6)."""
    rng = np.random.RandomState(1 + h0)
    xi = rng.randn(B, L, 3 * H).astype(np.float32)
    wh = (0.3 * rng.randn(H, 3 * H)).astype(np.float32)
    bh = (0.1 * rng.randn(3 * H)).astype(np.float32)
    hinit = (0.5 * rng.randn(B, H) if h0 else np.zeros((B, H))).astype(np.float32)
    ref = jax_fused_gru(jnp.asarray(xi), jnp.asarray(hinit), jnp.asarray(wh), jnp.asarray(bh),
                        interpret=True)
    got = fg.fused_gru_torch(*(torch.as_tensor(a) for a in (xi, hinit, wh, bh)), bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _op_grads_jax(xi, hinit, wh, bh, dy, cdt):
    """The recurrence alone through gru_apply: an identity input projection
    (zero bias) makes its xi equal to x, so jax.vjp gives dxi, dh0, dwh and
    dbh of the lax.scan."""
    eye = jnp.eye(3 * H, dtype=jnp.float32)

    def f(xi, h0, wh, bh):
        layer = [{"wi": eye, "bi": jnp.zeros(3 * H), "wh": wh, "bh": bh}]
        return jax_layers.gru_apply(layer, xi, h0=h0, compute_dtype=cdt).astype(jnp.float32)

    y, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (xi, hinit, wh, bh)))
    ct = jnp.asarray(dy)
    if cdt is not None:
        ct = ct.astype(cdt).astype(jnp.float32)
    return [np.asarray(y)] + [np.asarray(g) for g in vjp(ct)]


def _op_grads_port(xi, hinit, wh, bh, dy, bf16):
    txi = torch.tensor(xi)
    if bf16:
        txi = txi.to(torch.bfloat16)
    txi.requires_grad_(True)
    th0, twh, tbh = (torch.tensor(a, requires_grad=True) for a in (hinit, wh, bh))
    out = fg.fused_gru_torch(txi, th0, twh, tbh, bf16=bf16)
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tbh.shape == (3 * H,)
    (out.float() * torch.as_tensor(dy).to(out.dtype).float()).sum().backward()
    assert txi.grad.dtype == txi.dtype and tbh.grad.shape == (3 * H,)
    return [out.float().detach().numpy()] + [t.grad.float().numpy()
                                             for t in (txi, th0, twh, tbh)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("h0", [False, True])
def test_plain_recurrence_and_gradients_match_gru_apply(bf16, h0):
    """The recurrence's output and dxi, dh0, dwh, dbh against jax.vjp of
    gru_apply's scan: fp32 at rtol 2e-4 of each tensor's largest value,
    bf16 at BF16_TOL. xi is bf16-representable, so both instances see the
    same input."""
    rng = np.random.RandomState(3 + 2 * bf16 + h0)
    xi = rng.randn(B, L, 3 * H).astype(np.float32)
    if bf16:
        xi = np.asarray(torch.tensor(xi).to(torch.bfloat16).float())
    wh = (0.3 * rng.randn(H, 3 * H)).astype(np.float32)
    bh = (0.1 * rng.randn(3 * H)).astype(np.float32)
    hinit = (0.5 * rng.randn(B, H) if h0 else np.zeros((B, H))).astype(np.float32)
    dy = rng.randn(B, L, H).astype(np.float32)
    ref = _op_grads_jax(xi, hinit, wh, bh, dy, jnp.bfloat16 if bf16 else None)
    got = _op_grads_port(xi, hinit, wh, bh, dy, bf16)
    tol = BF16_TOL if bf16 else 2e-4
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), got, ref):
        _close(a, b, tol, name)


def test_plain_backward_is_the_gradient_of_the_forward():
    """fp32: the hand-written backward equals autograd through the plain
    forward's own loop, at rtol 2e-4."""
    rng = np.random.RandomState(7)
    xi, wh, bh = (rng.randn(B, L, 3 * H), 0.3 * rng.randn(H, 3 * H), 0.1 * rng.randn(3 * H))
    hinit, dy = 0.5 * rng.randn(B, H), rng.randn(B, L, H)
    args = [torch.tensor(a.astype(np.float32), requires_grad=True) for a in (xi, hinit, wh, bh)]
    out = fg.fused_gru_torch_fwd(*args, bf16=False)
    (out * torch.tensor(dy.astype(np.float32))).sum().backward()
    got = fg.fused_gru_torch_bwd(*(a.detach() for a in args), out.detach(),
                                 torch.tensor(dy.astype(np.float32)), bf16=False)
    for name, a, b in zip(("dxi", "dh0", "dwh", "dbh"), got, args):
        _close(a.numpy(), b.grad.numpy(), 2e-4, name)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_gru_apply_matches_jax(n_layers, cdt):
    """layers.gru_apply (input projections, then the recurrence through
    ops/fused_gru.py) against the JAX gru_apply: outputs and the gradients
    of x, h0 and every layer's wi, wh, bi, bh; fp32 at rtol 2e-4, bf16 at
    BF16_TOL, each relative to its tensor's largest value."""
    x, dy, hinit, params = _gru_inputs(11 + n_layers, n_layers, h0=True)
    jcdt = None if cdt is None else jnp.bfloat16
    tcdt = None if cdt is None else torch.bfloat16

    def jf(p, x, h0):
        return jax_layers.gru_apply(p, x, h0=h0, compute_dtype=jcdt).astype(jnp.float32)

    y, vjp = jax.vjp(jf, params, jnp.asarray(x), jnp.asarray(hinit))
    ct = jnp.asarray(dy) if jcdt is None else jnp.asarray(dy).astype(jcdt).astype(jnp.float32)
    gp, gx, gh = vjp(ct)
    gru = layers.GRU(torch.Generator().manual_seed(0), DIN, H, n_layers, "cpu")
    with torch.no_grad():
        for name, p in gru.named_parameters():
            p.copy_(torch.tensor(flatten_tree(params)[name]))
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(hinit, requires_grad=True)
    out = layers.gru_apply(gru, tx, h0=th, compute_dtype=tcdt)
    assert out.dtype == (tcdt or torch.float32) and out.shape == (B, L, H)
    (out.float() * torch.as_tensor(np.asarray(ct))).sum().backward()
    tol = 2e-4 if cdt is None else BF16_TOL
    _close(out.float().detach().numpy(), np.asarray(y), tol, "out")
    _close(tx.grad.numpy(), np.asarray(gx), tol, "dx")
    _close(th.grad.numpy(), np.asarray(gh), tol, "dh0")
    ref = flatten_tree(jax.tree.map(np.asarray, gp))
    for name, p in gru.named_parameters():
        _close(p.grad.numpy(), ref[name], tol, name)


def test_gru_module_init_and_names():
    """The port's own GRU: the JAX tree's paths, xavier-uniform weights in
    their limits, zero biases."""
    gru = layers.GRU(torch.Generator().manual_seed(0), DIN, H, 2, "cpu")
    jtree = jax_layers.gru_init(jax.random.key(0), DIN, H, 2)
    assert set(dict(gru.named_parameters())) == set(flatten_tree(jtree))
    lim = np.sqrt(6.0 / (DIN + 3 * H))
    w = gru[0].wi.detach().abs()
    assert float(w.max()) <= lim and float(w.max()) > 0.8 * lim
    assert float(gru[1].wi.detach().abs().max()) <= np.sqrt(6.0 / (4 * H))
    assert not any(float(layer.bi.detach().abs().max()) or float(layer.bh.detach().abs().max())
               for layer in gru)


def test_gru_dispatch_stays_plain_on_cpu_and_launchers_refuse_it():
    rng = np.random.RandomState(5)
    xi = torch.tensor(rng.randn(2, 3, 3 * H).astype(np.float32))
    h0, wh, bh = torch.zeros(2, H), torch.tensor(rng.randn(H, 3 * H).astype(np.float32)), \
        torch.zeros(3 * H)
    with pytest.raises(ValueError, match="CUDA"):
        fg.fused_gru_fwd_cuda(xi, h0, wh, bh)
    with pytest.raises(ValueError, match="CUDA"):
        fg.fused_gru_bwd_cuda(xi, h0, wh, bh, xi[..., :H], xi[..., :H])
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fg.fused_gru(xi.double(), h0, wh, bh)
    before = (fg.fused_gru_fwd_cuda.launches, fg.fused_gru_bwd_cuda.launches)
    xi.requires_grad_(True)
    out = fg.fused_gru(xi, h0, wh, bh)
    out.sum().backward()
    assert (fg.fused_gru_fwd_cuda.launches, fg.fused_gru_bwd_cuda.launches) == before
    assert torch.equal(out, fg.fused_gru_torch(xi, h0, wh, bh))
    assert torch.isfinite(xi.grad).all()


# --------------------------------------------------------------- the models

def _seq_cfg(tmp_path, data_path=None, **extra):
    cfg = {"epochs": 2, "train_batch_size": 256, "eval_batch_size": 512,
           "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
           "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
           "MAX_ITEM_LIST_LENGTH": SEQ_L, "embedding_size": SEQ_E, "hidden_size": SEQ_H,
           **extra}
    if data_path:
        cfg["data_path"] = data_path
    return cfg


def _pair(model, synth_dataset_dir, tmp_path, **extra):
    cfg = _seq_cfg(tmp_path, synth_dataset_dir, **extra)
    jc = JaxConfig(model, "synth", config_dict=cfg, _parse_cmd_line=False)
    pc = Config(model, "synth", config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    jmodel = jax_get_model(model)(jc, jloaders[0].dataset)
    params = jmodel.init_params(jax.random.key(0))
    # move the zero biases off their initial values
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda v: v + 0.05 * rng.randn(*v.shape).astype(np.float32)
                          if v.ndim == 1 else v, params)
    pmodel = get_model(model)(pc, ploaders[0].dataset)
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))
    return jc, pc, jloaders, ploaders, jmodel, params, pmodel


def _train_batch(ptrain, rows, n_items, seed=0):
    cols = ptrain.columns()
    batch = {f: v[rows] for f, v in cols.items()}
    batch["neg_item_id"] = np.random.RandomState(seed).randint(1, n_items, len(rows))
    return batch


@pytest.mark.parametrize("model,cdt", [("GRU4Rec", "bfloat16"), ("GRU4Rec", "float32"),
                                       ("NARM", "auto")])
@pytest.mark.parametrize("loss_type", ["CE", "BPR"])
def test_loss_and_gradients_match_jax(synth_dataset_dir, tmp_path, model, cdt, loss_type):
    """calculate_loss and the gradient of every leaf, dropout off; predict
    and full_sort_predict from the same weights. fp32 (NARM's GRU always,
    GRU4Rec under compute_dtype float32) at rtol 2e-4 of each leaf's largest
    value (or 1% of the largest gradient for a leaf whose gradient is about
    0); GRU4Rec's bf16 default at BF16_TOL (5% floor)."""
    extra = {"loss_type": loss_type, "compute_dtype": cdt,
             "training_neg_sample_num": 1 if loss_type == "BPR" else 0}
    _, _, _, ploaders, jmodel, params, pmodel = _pair(model, synth_dataset_dir, tmp_path,
                                                      **extra)
    bf16 = model == "GRU4Rec" and cdt == "bfloat16"
    assert pmodel.cdt == (torch.bfloat16 if cdt != "float32" else None)
    batch = _train_batch(ploaders[0], np.arange(96), pmodel.n_items)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jbatch))(params)
    tbatch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    loss = pmodel.calculate_loss(tbatch)
    loss.backward()
    tol, floor = (BF16_TOL, 5e-2) if bf16 else (2e-4, 1e-2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert set(ref) == set(dict(pmodel.named_parameters()))
    gscale = max(float(np.abs(v).max()) for v in ref.values())
    for name, p in pmodel.named_parameters():
        denom = max(float(np.abs(ref[name]).max()), floor * gscale)
        err = float(np.abs(p.grad.numpy() - ref[name]).max()) / denom
        assert err <= tol, (name, err)
    with torch.no_grad():
        _close(pmodel.full_sort_predict(tbatch).numpy(),
               np.asarray(jmodel.full_sort_predict(params, jbatch)), tol, "full_sort_predict")
        _close(pmodel.predict(tbatch).numpy(), np.asarray(jmodel.predict(params, jbatch)), tol,
               "predict")


@pytest.mark.parametrize("cls,fused", [(GRU4Rec, True), (SASRec, True), (BPR, True),
                                       (NARM, False), (LightGCN, False)])
def test_full_sort_route_follows_the_jax_rule(cls, fused):
    """GRU4Rec defines full_sort_query itself and SASRec inherits the whole
    dot-product stack: the fused masked top-k. NARM overrides
    full_sort_predict alone: the non-fused step, as in the JAX trainer."""
    assert fused_full_sort(cls) is fused


@pytest.mark.parametrize("model", ["GRU4Rec", "NARM"])
def test_five_steps_and_full_sort_metrics_match_jax(synth_dataset_dir, tmp_path, model,
                                                    monkeypatch):
    """Five steps on the same rows (dropout off, fp32): loss at rtol 2e-4,
    parameters at rtol 2e-4 / atol 2e-5 for at least 99.5% of every leaf's
    elements and every element within 2.5e-4 (a quarter of an Adam step at
    lr 1e-3: where a gradient element is a cancelling sum near zero, Adam's
    normalised update turns the packages' fp32 sum orders into different
    steps). Row 0 of item_embedding stays zero. Then full-sort metrics on
    the valid and test splits from the same weights agree within 1e-6:
    GRU4Rec through the masked top-k, NARM through full_sort_predict and
    torch.topk."""
    extra = {"compute_dtype": "float32",
             **({"dropout_prob": 0.0} if model == "GRU4Rec" else {"dropout_probs": [0.0, 0.0]})}
    jc, pc, jloaders, ploaders, jmodel, params, pmodel = _pair(model, synth_dataset_dir,
                                                               tmp_path, **extra)
    jtrainer, ptrainer = JaxTrainer(jc, jmodel), Trainer(pc, pmodel)
    jtrainer._fused_adam = True
    opt_state = jtrainer._fused_adam_init(params)
    ident = lambda batch, rng, consts: batch
    jstep = jtrainer._make_step_core(ident, jmodel.calculate_loss)
    ptrainer.opt_state = ptrainer._fused_adam_init()
    pstep = ptrainer._make_step_core(ident, pmodel.calculate_loss)
    key = jax.random.key(1)
    for step in range(5):
        batch = _train_batch(ploaders[0], np.arange(step * 128, (step + 1) * 128),
                             pmodel.n_items, seed=step)
        params, opt_state, key, jloss, _ = jstep(
            params, opt_state, key, {k: jnp.asarray(v) for k, v in batch.items()}, {})
        ploss = pstep({k: torch.as_tensor(v).long() for k, v in batch.items()}, {})
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-4)
    got = flatten_tree(export_params(pmodel))
    for name, ref in flatten_tree(jax.tree.map(np.asarray, params)).items():
        diff = np.abs(got[name] - ref)
        assert np.mean(diff <= 2e-5 + 2e-4 * np.abs(ref)) >= 0.995, name
        assert diff.max() <= 2.5e-4, (name, diff.max())
    assert float(np.abs(got["item_embedding"][0]).max()) == 0.0

    calls = []
    real = trainer_mod.masked_topk
    monkeypatch.setattr(trainer_mod, "masked_topk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jtrainer.params = params
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])
    assert bool(calls) == (model == "GRU4Rec")


@pytest.mark.parametrize("model,extra", [
    ("GRU4Rec", {}), ("GRU4Rec", {"loss_type": "BPR", "training_neg_sample_num": 1,
                                  "compute_dtype": "float32", "num_layers": 2}),
    ("NARM", {}), ("NARM", {"loss_type": "BPR", "training_neg_sample_num": 1})],
    ids=["GRU4Rec-CE-bf16", "GRU4Rec-BPR-fp32-2layers", "NARM-CE", "NARM-BPR"])
def test_end_to_end_on_cpu(synth_dataset_dir, tmp_path, model, extra):
    """run_recbole on the synthetic dataset, dropout on (the defaults)."""
    result = run_recbole(model=model, dataset="synth", config_dict=_seq_cfg(
        tmp_path, synth_dataset_dir, **extra), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert set(result["best_valid_result"]) == set(tr)


@pytest.mark.parametrize("model", ["GRU4Rec", "NARM"])
def test_resume_matches_straight_run(synth_dataset_dir, tmp_path, model):
    """With dropout on: two epochs, a checkpoint and two more equal four
    epochs straight, parameters, moments and loss curve."""
    def pipeline(sub, **extra):
        pc = Config(model, "synth", _parse_cmd_line=False,
                    config_dict=_seq_cfg(tmp_path / sub, synth_dataset_dir, **extra))
        init_seed(pc["seed"])
        train, _, _ = data_preparation(pc, create_dataset(pc))
        m = get_model(model)(pc, train.dataset)
        return Trainer(pc, m), m, train

    straight, smodel, strain = pipeline("a", epochs=4)
    straight.fit(strain, None, saved=False, verbose=False)
    first, _, ftrain = pipeline("b")
    first.fit(ftrain, None, saved=True, verbose=False)
    resumed, rmodel, rtrain = pipeline("c", epochs=4)
    resumed.resume_checkpoint(first.saved_model_file)
    assert resumed.start_epoch == 2
    resumed.fit(rtrain, None, saved=False, verbose=False)
    for name, p in smodel.named_parameters():
        assert torch.equal(p, dict(rmodel.named_parameters())[name]), name
        assert torch.equal(straight.opt_state["nu"][name], resumed.opt_state["nu"][name])
    assert straight.train_loss_dict == resumed.train_loss_dict


def test_init_and_compute_dtype_rule(synth_dataset_dir, tmp_path):
    """The port's own initialisation: [PAD] row zero, names equal to the JAX
    tree's paths; GRU4Rec's compute dtype auto is bfloat16 (its GRU outputs
    bf16), NARM's GRU runs fp32 whatever the family default."""
    _, pc, _, ploaders, _, params, pmodel = _pair("GRU4Rec", synth_dataset_dir, tmp_path)
    assert set(dict(pmodel.named_parameters())) == set(flatten_tree(params))
    fresh = get_model("GRU4Rec")(pc, ploaders[0].dataset)
    assert pc["compute_dtype"] == "auto" and fresh.cdt == torch.bfloat16
    assert torch.count_nonzero(fresh.item_embedding[0]) == 0
    seq = torch.as_tensor(ploaders[0].columns()["item_id_list"][:4]).long()
    x = fresh.embed_seq(seq)
    assert layers.gru_apply(fresh.gru, x, compute_dtype=fresh.cdt).dtype == torch.bfloat16
    narm = get_model("NARM")(Config("NARM", "synth", _parse_cmd_line=False,
                                    config_dict=_seq_cfg(tmp_path, synth_dataset_dir)),
                             ploaders[0].dataset)
    assert narm.cdt == torch.bfloat16
    assert layers.gru_apply(narm.gru, narm.embed_seq(seq)).dtype == torch.float32
    assert torch.count_nonzero(narm.item_embedding[0]) == 0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden", [10, 30])
def test_padding_to_a_multiple_of_four_leaves_the_result(bf16, hidden):
    """The dispatcher's zero-padding of H up to a multiple of 4 (what the
    kernels run on the card), applied to the plain version: the padded
    units' outputs are exactly 0 at every step and their rows of the
    gradients slice away; the real units' outputs and the gradients equal
    the unpadded run's within 2e-6 of each tensor's largest value (the
    padding adds exact zeros, but the CPU library's product blocks a
    10-long and a 12-long sum differently; the kernels add k in order, so
    there the zeros come last)."""
    rng = np.random.RandomState(hidden + bf16)
    Hh = hidden
    xi = torch.tensor(rng.randn(B, L, 3 * Hh).astype(np.float32))
    if bf16:
        xi = xi.to(torch.bfloat16)
    h0 = torch.tensor((0.5 * rng.randn(B, Hh)).astype(np.float32))
    wh = torch.tensor((0.3 * rng.randn(Hh, 3 * Hh)).astype(np.float32))
    bh = torch.tensor((0.1 * rng.randn(3 * Hh)).astype(np.float32))
    dy = torch.tensor(rng.randn(B, L, Hh).astype(np.float32))
    Hp = fg.padded_hidden(Hh)
    assert Hp % 4 == 0 and Hh < Hp < Hh + 4

    def grads(pad):
        args = [t.clone().requires_grad_(True) for t in (xi, h0, wh, bh)]
        padded = fg.pad_hidden(*args, Hp) if pad else args
        full = fg.fused_gru_torch(*padded, bf16=bf16)
        out = full[..., :Hh]
        (out.float() * dy).sum().backward()
        return full.detach(), [out.detach()] + [a.grad for a in args]

    full, got = grads(True)
    _, ref = grads(False)
    assert float(full[..., Hh:].float().abs().max()) == 0.0
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close(a.float().numpy(), b.float().numpy(), 2e-6, name)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_gru4rec_odd_hidden_size_matches_jax(synth_dataset_dir, tmp_path, cdt):
    """GRU4Rec at hidden_size 10 (not a multiple of 4: the kernels' path
    pads it on the card): the loss and every leaf's gradient against JAX at
    the file's tolerances (rtol 2e-4 in fp32, BF16_TOL with a 5% floor in
    bf16), from the same weights and batch."""
    _, _, _, ploaders, jmodel, params, pmodel = _pair(
        "GRU4Rec", synth_dataset_dir, tmp_path, hidden_size=10, compute_dtype=cdt)
    assert pmodel.gru[0].wh.shape == (10, 30)
    batch = _train_batch(ploaders[0], np.arange(64), pmodel.n_items)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jbatch))(params)
    loss = pmodel.calculate_loss({k: torch.as_tensor(v).long() for k, v in batch.items()})
    loss.backward()
    tol, floor = (BF16_TOL, 5e-2) if cdt == "bfloat16" else (2e-4, 1e-2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    gscale = max(float(np.abs(v).max()) for v in ref.values())
    for name, p in pmodel.named_parameters():
        denom = max(float(np.abs(ref[name]).max()), floor * gscale)
        assert float(np.abs(p.grad.numpy() - ref[name]).max()) / denom <= tol, name
