"""Shapes the port's kernels do not take, routed before launch to a path
that runs, as the JAX package runs them: the masked top-k's widths (zero
padding) and its k past 128 or widths past 512 (the non-fused full-sort
step), the relation apply's widths (zero padding, square blocks of 128
composed), and the packed-bit kernels' widths (an odd D padded, slices of
128 columns). On the CPU each route runs with the plain versions in place
of the kernels and is held against the plain version at the unpadded
width; the full-sort routes are held against the JAX trainer's metrics.
The ``cuda`` cases of the same routes are in tests/test_torch_ops.py."""

import numpy as np
import jax
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
from recbole_tpu_torch.convert import load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.ops import bit_kernels as port_bits
from recbole_tpu_torch.ops import masked_topk as port_topk
from recbole_tpu_torch.ops import rel_apply as port_rel
from recbole_tpu_torch.trainer import trainer as trainer_mod
from recbole_tpu_torch.utils.utils import init_seed
from tests.synth_data import make_synthetic_dataset


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def wide_dataset_dir(tmp_path_factory):
    """A synthetic set with 300 items: room for k = 200."""
    root = tmp_path_factory.mktemp("routedata")
    make_synthetic_dataset(str(root), name="synth300", n_users=40, n_items=300, n_inter=2000,
                           seed=11)
    return str(root)


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# ------------------------------------------------------------- masked top-k

@pytest.mark.parametrize("D", [6, 10, 17])
def test_masked_topk_padded_width_keeps_the_topk(D):
    """The query and item columns zero-padded to a multiple of 4: the same
    ids, the same values within one fp32 rounding of a sum."""
    rng = np.random.RandomState(D)
    q = torch.tensor(rng.randn(37, D).astype(np.float32))
    items = torch.tensor(rng.randn(300, D).astype(np.float32))
    mask = torch.tensor((rng.rand(37, 300) < 0.2).astype(np.int8))
    qp, ip = port_topk.pad_width(q, items)
    assert qp.shape[1] == ip.shape[1] == port_topk.padded_width(D) == -(-D // 4) * 4
    assert torch.equal(qp[:, :D], q) and float(qp[:, D:].abs().sum()) == 0.0
    v, i = port_topk.masked_topk_torch(q, items, mask, 20)
    vp, ip_ = port_topk.masked_topk_torch(qp, ip, mask, 20)
    assert torch.equal(i, ip_)
    torch.testing.assert_close(vp, v, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("D, k, fits", [(64, 10, True), (10, 10, True), (510, 10, True),
                                        (512, 128, True), (513, 10, False),
                                        (1024, 10, False), (64, 129, False),
                                        (64, 200, False)])
def test_masked_topk_fits_decides_the_route(D, k, fits):
    assert port_topk.masked_topk_fits(D, k) is fits


def _bpr_pair(data_dir, tmp_path, **extra):
    cfg = {"data_path": data_dir, "epochs": 1, "train_batch_size": 256,
           "eval_batch_size": 512, "checkpoint_dir": str(tmp_path / "saved"),
           "log_dir": str(tmp_path / "log"), "state": "ERROR",
           "valid_full_to_uni1000": False, "device": "cpu",
           # unrounded metrics: a fourth decimal's rounding can flip on fp32 noise
           "metric_decimal_place": 12, **extra}
    jc = JaxConfig("BPR", "synth300", config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model("BPR")(jc, jloaders[0].dataset)
    jtrainer = JaxTrainer(jc, jmodel)
    params = jmodel.init_params(jax.random.key(0))
    jtrainer.params = params
    pc = Config("BPR", "synth300", config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    pmodel = get_model("BPR")(pc, ploaders[0].dataset)
    load_jax_params(pmodel, {k: np.asarray(v) for k, v in params.items()})
    return jtrainer, jloaders, trainer_mod.Trainer(pc, pmodel), ploaders


@pytest.mark.parametrize("extra, fused", [
    ({"embedding_size": 10, "topk": [10]}, True),
    ({"embedding_size": 16, "topk": [200]}, False),
    ({"embedding_size": 520, "topk": [10]}, False)])
def test_bpr_full_sort_routes_match_jax(wide_dataset_dir, tmp_path, monkeypatch, extra, fused):
    """BPR's full sort on the fused rule: at D 10 through the masked top-k
    (padded on the card), at k 200 and at D 520 through the non-fused step
    (no masked top-k call); valid and test metrics within 1e-6 of the JAX
    trainer's from the same weights."""
    jtrainer, jloaders, ptrainer, ploaders = _bpr_pair(wide_dataset_dir, tmp_path, **extra)
    calls = []
    real = trainer_mod.masked_topk
    monkeypatch.setattr(trainer_mod, "masked_topk",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for key in jres:
            assert abs(jres[key] - pres[key]) <= 1e-6, (key, jres[key], pres[key])
    assert bool(calls) is fused


# ------------------------------------------------------------ relation apply

def _rel_operands(N, D, NR, seed):
    rng = np.random.RandomState(seed)
    rel = torch.tensor(rng.randint(0, NR + 1, N))  # id NR lies outside
    v = torch.tensor(rng.randn(N, D).astype(np.float32))
    R = torch.tensor((rng.randn(NR, D, D) / np.sqrt(D)).astype(np.float32))
    dy = torch.tensor(rng.randn(N, D).astype(np.float32))
    return v, rel, R, dy


@pytest.mark.parametrize("D, block, Dp, n_blocks", [(18, 128, 20, 1), (20, 8, 24, 3),
                                                    (18, 8, 24, 3), (256, 128, 256, 2),
                                                    (130, 64, 132, 3), (200, 128, 200, 2)])
@pytest.mark.parametrize("bf16", [False, True])
def test_rel_apply_blocks_match_the_plain_version(D, block, Dp, n_blocks, bf16):
    """rel_apply_blocks with the plain version in the kernels' place: D
    zero-padded to a multiple of 4, and past ``block`` square blocks
    composed, against the plain version at D; y, dv and dR at rtol 2e-4 of
    their largest value (the bf16 instance: each block's y rounded to bf16
    before the blocks add, within 2e-2)."""
    assert port_rel.width_blocks(D, block) == (
        Dp, [(i * Dp // n_blocks, (i + 1) * Dp // n_blocks) for i in range(n_blocks)])
    assert Dp // n_blocks <= block and Dp // n_blocks % 4 == 0
    v, rel, R, dy = _rel_operands(300, D, 5, D)
    widths = []

    def apply(v_b, rel_b, R_b, bf16_b):
        widths.append(v_b.shape[1])
        assert R_b.shape[1:] == (v_b.shape[1], v_b.shape[1]) and R_b.is_contiguous()
        return port_rel._PlainRelApply.apply(v_b, rel_b, R_b, bf16_b)

    vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)
    y = port_rel.rel_apply_blocks(vg, rel, Rg, bf16, apply, block=block)
    (y * dy).sum().backward()
    assert len(widths) == n_blocks ** 2 and max(widths) <= block
    ref_y = port_rel.rel_apply_torch(v, rel, R, bf16)
    ref_dv, ref_dR = port_rel.rel_apply_torch_bwd(v, rel, R, dy, bf16)
    tol = 2e-2 if bf16 else 2e-4
    assert y.shape == (300, D)
    for what, got, ref in (("y", y.detach(), ref_y), ("dv", vg.grad, ref_dv),
                           ("dR", Rg.grad, ref_dR)):
        assert _rel_err(got, ref) <= tol, what
    assert float(y.detach()[rel == 5].abs().max()) == 0.0


# ------------------------------------------------------------ packed bits

@pytest.mark.parametrize("D, n_slices", [(2, 1), (3, 1), (65, 1), (128, 1), (129, 2),
                                         (256, 2), (301, 3)])
def test_bit_products_by_column_slices_match_the_plain_version(D, n_slices):
    """by_column_slices with the plain versions in the kernels' place: an
    odd D padded by a zero column and dropped, past 128 slices of 128
    columns concatenated; both products against the plain version at D
    (exact terms, fp32 sums: rtol 1e-5)."""
    Dp, slices = port_bits.column_slices(D)
    assert Dp == D + D % 2 and len(slices) == n_slices
    assert all(hi - lo <= port_bits.MAX_D and (hi - lo) % 2 == 0 for lo, hi in slices)
    rng = np.random.RandomState(D)
    bits = torch.tensor(rng.randint(0, 256, (40, 32)).astype(np.uint8))
    rows = torch.tensor(rng.randint(0, 40, 70))
    v = torch.tensor(rng.randn(256, D).astype(np.float32)).to(torch.bfloat16)
    g = torch.tensor(rng.randn(70, D).astype(np.float32)).to(torch.bfloat16)
    widths = []

    def rows_fn(x):
        widths.append(x.shape[1])
        return port_bits.bit_rows_matmul_torch(bits, rows, x)

    def cols_fn(x):
        widths.append(x.shape[1])
        return port_bits.bit_cols_matmul_torch(bits, rows, x)

    got_r = port_bits.by_column_slices(rows_fn, v)
    got_c = port_bits.by_column_slices(cols_fn, g)
    assert len(widths) == 2 * n_slices and all(w % 2 == 0 for w in widths)
    ref_r = port_bits.bit_rows_matmul_torch(bits, rows, v)
    ref_c = port_bits.bit_cols_matmul_torch(bits, rows, g)
    assert got_r.shape == ref_r.shape and got_c.shape == ref_c.shape
    torch.testing.assert_close(got_r, ref_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_c, ref_c, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- end to end

@pytest.mark.parametrize("model, extra", [
    ("BPR", {"embedding_size": 10}),
    ("BPR", {"topk": [200], "metrics": ["Recall", "NDCG"], "valid_metric": "NDCG@200"}),
    ("RippleNet", {"embedding_size": 18, "n_memory": 4}),
    ("RippleNet", {"embedding_size": 256, "n_memory": 4}),
    ("LightGCN", {"embedding_size": 65, "use_restricted_step": True}),
    ("LightGCN", {"embedding_size": 256, "use_restricted_step": True})])
def test_repaired_widths_run_end_to_end_on_cpu(wide_dataset_dir, tmp_path, model, extra):
    """The shapes the kernels refused run through run_recbole: BPR at D 10
    and with k 200, RippleNet at D 18 and 256, LightGCN's restricted step at
    D 65 and 256; finite metrics in [0, 1]."""
    result = run_recbole(model=model, dataset="synth300", config_dict={
        "data_path": wide_dataset_dir, "epochs": 1, "train_batch_size": 512,
        "eval_batch_size": 1024, "checkpoint_dir": str(tmp_path / "saved"),
        "log_dir": str(tmp_path / "log"), "state": "ERROR", "valid_full_to_uni1000": False,
        "device": "cpu", **extra}, saved=False)
    for split in ("best_valid_result", "test_result"):
        vals = result[split]
        assert vals and all(0.0 <= x <= 1.0 for x in vals.values()), (split, vals)
