"""The port's graph slice against the JAX package's, on the CPU: the
packed-bit products (the Pallas kernels in interpret mode), the packed
images, the ELL pass, BipartiteProp's dense and hybrid paths, the restricted
applications and LinearPropBatch, LightGCN's loss and gradients, a
three-step train with full-sort metrics, the non-fused eval step, and
LightGCN end to end. Inputs come from numpy seeds and go to both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from recbole_tpu.config.configurator import Config as JaxConfig
from recbole_tpu.data.utils import (create_dataset as jax_create_dataset,
                                    data_preparation as jax_data_preparation)
from recbole_tpu.models import get_model as jax_get_model
from recbole_tpu.models.general import lightgcn as jax_lightgcn
from recbole_tpu.ops import bitgraph as jax_bg
from recbole_tpu.ops import edge_prop as jax_ep
from recbole_tpu.ops import graph as jax_graph
from recbole_tpu.ops.bit_kernels import bit_cols_matmul, bit_rows_matmul, perm_planes, unperm_planes
from recbole_tpu.trainer.trainer import Trainer as JaxTrainer
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model
from recbole_tpu_torch.models.general import lightgcn as port_lightgcn
from recbole_tpu_torch.ops import bit_kernels as port_bits
from recbole_tpu_torch.ops import bitgraph as port_bg
from recbole_tpu_torch.ops import edge_prop as port_ep
from recbole_tpu_torch.ops import embed_grad as port_eg
from recbole_tpu_torch.ops import graph as port_graph
from recbole_tpu_torch.trainer.trainer import Trainer
from recbole_tpu_torch.utils.utils import init_seed

RTOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    """rtol of each element, plus rtol of the tensor's largest magnitude for
    elements that sums cancel to near zero."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def power_law_graph(seed=1, n_u=120, n_i=90, nnz=3000, dup=True):
    """The power-law item graph of tests/test_ops.py's hybrid test; with
    ``dup`` some interactions repeat, as in real interaction logs."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_u, nnz)
    i = np.floor((n_i - 1) * rng.random_sample(nnz) ** 2.2).astype(np.int64)
    if dup:
        u, i = np.concatenate([u, u[:50]]), np.concatenate([i, i[:50]])
    mat = sp.coo_matrix((np.ones(len(u), np.float32), (u, i)), shape=(n_u, n_i)).tocsr()
    return mat, n_u, n_i


# ------------------------------------------------------------ packed-bit products

def _bit_operands(seed, R=256, nbytes=256, D=64):
    rng = np.random.RandomState(seed)
    packed = rng.randint(0, 256, (R, nbytes)).astype(np.uint8)
    v = np.asarray(jnp.asarray(rng.randn(nbytes * 8, D).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    g = np.asarray(jnp.asarray(rng.randn(R, D).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    rows = np.arange(R, dtype=np.int64)
    return packed, rows, v, g


def _within_terms(got, want, magnitude, rtol=1e-5):
    """Within rtol of each element plus rtol of the sum of the terms'
    magnitudes (the sums run in another order)."""
    assert np.all(np.abs(got - want) <= rtol * (np.abs(want) + magnitude)), \
        float(np.abs(got - want).max())


def test_bit_rows_plain_matches_pallas_interpret():
    packed, rows, v, _ = _bit_operands(0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bit_rows_matmul(jnp.asarray(packed),
                                          perm_planes(jnp.asarray(v).astype(jnp.bfloat16))))
    vb = _t(v).to(torch.bfloat16)
    got = port_bits.bit_rows_matmul(_t(packed), _t(rows), vb).numpy()
    mag = port_bits.bit_rows_matmul(_t(packed), _t(rows), vb.abs()).numpy()
    _within_terms(got, want, mag)


def test_bit_cols_plain_matches_pallas_interpret():
    packed, rows, _, g = _bit_operands(1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(unperm_planes(bit_cols_matmul(
            jnp.asarray(packed), jnp.asarray(g).astype(jnp.bfloat16))))
    gb = _t(g).to(torch.bfloat16)
    got = port_bits.bit_cols_matmul(_t(packed), _t(rows), gb).numpy()
    mag = port_bits.bit_cols_matmul(_t(packed), _t(rows), gb.abs()).numpy()
    _within_terms(got, want, mag)


def test_bit_cols_plain_matches_pallas_interpret_power_law():
    """The column product on a power-law image (columns drawn toward 0) with
    a hot 32-column word set in most picked rows and picked rows repeated, as
    a user batch holds popular items: R 512, nbytes 512 (multiples of the
    Pallas kernel's 256)."""
    rng = np.random.RandomState(4)
    n_major, nbytes, R, D = 700, 512, 512, 64
    cols = np.floor(nbytes * 8 * rng.random_sample((n_major, 28)) ** 3).astype(np.int64)
    image = np.zeros((n_major, nbytes), np.uint8)
    np.bitwise_or.at(image, (np.repeat(np.arange(n_major), 28), cols.ravel() // 8),
                     (1 << (cols.ravel() % 8)).astype(np.uint8))
    hot = (rng.random_sample((n_major, 1)) < 0.9) & (rng.random_sample((n_major, 4)) < 0.7)
    image[:, 4:8] |= (hot * rng.randint(1, 256, (n_major, 4))).astype(np.uint8)
    rows = rng.randint(0, n_major, R).astype(np.int64)
    rows[rng.random_sample(R) < 0.2] = rows[0]
    g = np.asarray(jnp.asarray(rng.randn(R, D).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    assert np.unpackbits(image[rows][:, 4:8], axis=1).sum() > 8 * R
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(unperm_planes(bit_cols_matmul(
            jnp.asarray(image[rows]), jnp.asarray(g).astype(jnp.bfloat16))))
    gb = _t(g).to(torch.bfloat16)
    got = port_bits.bit_cols_matmul(_t(image), _t(rows), gb).numpy()
    mag = port_bits.bit_cols_matmul(_t(image), _t(rows), gb.abs()).numpy()
    _within_terms(got, want, mag)


def test_bit_rows_plain_matches_pallas_interpret_power_law():
    """The row product on a power-law image with a hot word set in most
    rows and one dense row (1,500 set bits, the item side's popular rows)
    picked many times among repeated picks: the rows a walk of each distinct
    id gives its copies, held against the Pallas kernel on the gathered rows:
    R 512, nbytes 512 (multiples of the Pallas kernel's 256)."""
    rng = np.random.RandomState(6)
    n_major, nbytes, R, D = 700, 512, 512, 64
    cols = np.floor(nbytes * 8 * rng.random_sample((n_major, 28)) ** 3).astype(np.int64)
    image = np.zeros((n_major, nbytes), np.uint8)
    np.bitwise_or.at(image, (np.repeat(np.arange(n_major), 28), cols.ravel() // 8),
                     (1 << (cols.ravel() % 8)).astype(np.uint8))
    hot = (rng.random_sample((n_major, 1)) < 0.9) & (rng.random_sample((n_major, 4)) < 0.7)
    image[:, 4:8] |= (hot * rng.randint(1, 256, (n_major, 4))).astype(np.uint8)
    dense = rng.choice(nbytes * 8, 1500, replace=False)
    np.bitwise_or.at(image[3], dense // 8, (1 << (dense % 8)).astype(np.uint8))
    rows = rng.randint(0, n_major, R).astype(np.int64)
    rows[rng.random_sample(R) < 0.2] = rows[0]
    rows[rng.random_sample(R) < 0.05] = 3
    v = np.asarray(jnp.asarray(rng.randn(nbytes * 8, D).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    assert np.unpackbits(image[rows], axis=1).sum() > 40 * R
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bit_rows_matmul(jnp.asarray(image[rows]),
                                          perm_planes(jnp.asarray(v).astype(jnp.bfloat16))))
    vb = _t(v).to(torch.bfloat16)
    got = port_bits.bit_rows_matmul(_t(image), _t(rows), vb).numpy()
    mag = port_bits.bit_rows_matmul(_t(image), _t(rows), vb.abs()).numpy()
    _within_terms(got, want, mag)


# an H100: 132 SMs; the column kernel holds 2 blocks an SM at D 64 (its
# 112 KB of shared memory), 1 at D 128
H100_SMS = 132


@pytest.mark.parametrize("R,nbytes,D,per_sm", [
    (2048, 12544, 64, 2), (4096, 12800, 64, 2), (2048, 256, 64, 2), (4096, 256, 64, 2),
    (0, 12800, 64, 2), (1, 12544, 64, 2), (37, 256, 16, 5), (1864, 12800, 128, 1),
    (100_000, 32, 2, 8)])
def test_bit_cols_plan_covers_every_strip_and_row_once(R, nbytes, D, per_sm):
    """Every strip is one cluster of C blocks; a split leaves each block at
    least a tile of the picked rows (the kernel splits them: the on-card
    tests hold its sums to the plain version's)."""
    plan = port_bits.bit_cols_plan(R, nbytes, D, H100_SMS, per_sm)
    C = plan["cluster"]
    assert plan["strips"] * port_bits.STRIP_BYTES == nbytes
    assert plan["blocks"] == plan["strips"] * C and 1 <= C <= port_bits.MAX_CLUSTER
    assert C & (C - 1) == 0 and plan["slots"] == H100_SMS * per_sm
    assert plan["waves"] == -(-plan["blocks"] // plan["slots"])
    assert C == 1 or R // C >= port_bits.TILE_ROWS


def test_bit_cols_plan_fills_the_card():
    """On an H100 at D 64: the Yelp user side (392 strips) splits its rows in
    two and takes 3 waves, the last at least 90% full; ml-100k's 8 strips take
    clusters of 16, a block on at least 90% of the SMs. The Yelp item side's
    400 strips fill no last wave at any cluster size on 264 slots (an open
    shortfall of the strip-a-cluster grid, not a goal); there the plan takes
    the cluster size of least cost."""
    slots = H100_SMS * 2
    user = port_bits.bit_cols_plan(2048, 12544, 64, H100_SMS, 2)
    assert (user["cluster"], user["waves"]) == (2, 3)
    assert user["blocks"] >= 0.9 * user["waves"] * slots
    for R in (2048, 4096):
        small = port_bits.bit_cols_plan(R, 256, 64, H100_SMS, 2)
        assert small["cluster"] == 16 and 0.9 * H100_SMS <= small["blocks"] <= H100_SMS
    item = port_bits.bit_cols_plan(4096, 12800, 64, H100_SMS, 2)

    def cost(C):
        return -(-400 * C // slots) * (-(-4096 // C) + port_bits.BLOCK_COST_ROWS)

    sizes = [C for C in (1, 2, 4, 8, 16) if C == 1 or 4096 // C >= port_bits.TILE_ROWS]
    assert cost(item["cluster"]) == min(cost(C) for C in sizes)
    assert item["waves"] == -(-400 * item["cluster"] // slots)
    # fewer cluster sizes on a card that holds no cluster of 16
    assert port_bits.bit_cols_plan(2048, 256, 64, H100_SMS, 2, max_cluster=8)["cluster"] == 8


@pytest.mark.parametrize("R,nbytes,D,sms,per_sm,most", [
    (10, 12800, 130, 132, 2, 16), (10, 12800, 3, 132, 2, 16), (10, 12800, 0, 132, 2, 16),
    (10, 48, 64, 132, 2, 16), (10, 16, 64, 132, 2, 16), (-1, 32, 64, 132, 2, 16),
    (10, 32, 64, 0, 2, 16), (10, 32, 64, 132, 0, 16), (10, 32, 64, 132, 2, 32)])
def test_bit_cols_plan_refuses_shapes_beyond_the_kernel(R, nbytes, D, sms, per_sm, most):
    with pytest.raises(ValueError):
        port_bits.bit_cols_plan(R, nbytes, D, sms, per_sm, max_cluster=most)


def test_bit_products_plain_at_no_rows():
    """R = 0: the column product is all zeros, the row product empty."""
    packed, _, v, _ = _bit_operands(5, R=8, nbytes=32, D=16)
    rows = torch.zeros(0, dtype=torch.int64)
    g = torch.zeros((0, 16), dtype=torch.bfloat16)
    cols = port_bits.bit_cols_matmul(_t(packed), rows, g)
    assert cols.shape == (256, 16) and not bool(cols.any())
    assert port_bits.bit_rows_matmul(_t(packed), rows, _t(v).bfloat16()).shape == (0, 16)


def test_unpack_bits_matches_jax_and_pad_k():
    packed = np.random.RandomState(2).randint(0, 256, (5, 32)).astype(np.uint8)
    want = np.asarray(jax_bg._unpack_bits(jnp.asarray(packed))).astype(np.float32)
    np.testing.assert_array_equal(port_bits.unpack_bits(_t(packed)).numpy(), want)
    v = torch.ones(3, 2)
    padded = port_bits.pad_k(v, 8)
    assert padded.shape == (8, 2) and float(padded[3:].abs().sum()) == 0
    with pytest.raises(ValueError):
        port_bits.pad_k(v, 2)


# -------------------------------------------------------------- packed images

def test_pack_side_and_bitgraph_bytes_exact():
    mat, n_u, n_i = power_law_graph(dup=True)
    coo = mat.tocoo()
    u, i = coo.row.astype(np.int64), coo.col.astype(np.int64)
    np.testing.assert_array_equal(port_bg._pack_side(u, i, n_u, n_i),
                                  jax_bg._pack_side(u, i, n_u, n_i))
    for shape in ((102_047, 98_409), (944, 1683), (1, 1), (120, 90)):
        assert port_bg.bitgraph_bytes(*shape) == jax_bg.bitgraph_bytes(*shape)
    port = port_bg.BitRestrictedGraph(mat, n_u, n_i)
    jax_consts = jax_bg.BitRestrictedGraph(mat, n_u, n_i).init_consts()
    # the port's images also keep their set bits a row (the row kernel's split)
    assert {n for n, _ in port.named_buffers()} - {"bg_user_counts", "bg_item_counts"} \
        == set(jax_consts)
    for name in jax_consts:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(jax_consts[name]))
    assert not list(port.parameters()) and not port.state_dict()


@pytest.mark.parametrize("dup", [True, False])
def test_bitgraph_counts_are_the_images_popcounts_and_jax_degrees(dup):
    """bg_user_counts and bg_item_counts (int32) are each image row's set
    bits and the JAX package's degrees (the D^-1/2 vectors' counts), also
    where the interactions repeat (each repeat sets one bit); side_counts
    gives the same for the raw ids with their repeats."""
    mat, n_u, n_i = power_law_graph(dup=dup)
    port = port_bg.BitRestrictedGraph(mat, n_u, n_i)
    c = jax_bg.BitRestrictedGraph(mat, n_u, n_i).init_consts()
    for counts, image, norm in ((port.bg_user_counts, c["bg_user_bits"], c["bg_unorm"]),
                                (port.bg_item_counts, c["bg_item_bits"], c["bg_inorm"])):
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(),
                                      np.unpackbits(np.asarray(image), axis=1).sum(axis=1))
        degree = np.rint(np.asarray(norm, np.float64) ** -2)
        np.testing.assert_array_equal(np.maximum(counts.numpy(), 1), degree)
    rng = np.random.RandomState(dup)
    u, i = rng.randint(0, 30, 400), rng.randint(0, 50, 400)
    image = port_bg._pack_side(u, i, 30, 50)
    np.testing.assert_array_equal(port_bg.side_counts(u, i, 30, 50),
                                  np.unpackbits(image, axis=1).sum(axis=1))


# ------------------------------------------------------------------------ ELL

def test_build_ell_consts_exact_and_ell_propagate_matches_jax():
    rng = np.random.RandomState(3)
    n_nodes, E = 70, 900
    heads = np.floor((n_nodes - 1) * rng.random_sample(E) ** 2.0).astype(np.int64)
    tails = rng.randint(0, n_nodes, E)
    consts, shapes = port_ep.build_ell_consts(heads, tails, n_nodes, prefix="t")
    jconsts, jshapes = jax_ep.build_ell_consts(heads, tails, n_nodes, prefix="t")
    assert shapes == jshapes and set(consts) == set(jconsts)
    for k in consts:
        np.testing.assert_array_equal(consts[k], jconsts[k])
    att = rng.rand(E).astype(np.float32)
    x = rng.randn(n_nodes, 8).astype(np.float32)
    dy = rng.randn(n_nodes, 8).astype(np.float32)
    names = ("tf_eidx", "tf_nbr", "tf_inv", "tb_eidx", "tb_nbr", "tb_inv")

    def jfn(x):
        return jax_ep.ell_propagate(jshapes, x, jnp.asarray(att),
                                    *(jnp.asarray(jconsts[k]) for k in names))

    jy, jvjp = jax.vjp(jax.jit(jfn), jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = port_ep.ell_propagate(shapes, xt, _t(att), *(_t(consts[k]) for k in names))
    y.backward(_t(dy))
    _close(y.detach().numpy(), jy)
    _close(xt.grad.numpy(), jvjp(jnp.asarray(dy))[0])


# ---------------------------------------------------------------- BipartiteProp

@pytest.mark.parametrize("path", ["dense", "dense_rw", "hybrid"])
def test_bipartite_prop_matches_jax(path):
    """Values and gradients of a two-layer sum of squares, port against JAX
    at fp32 rtol 2e-4; the hybrid forced by dense_budget=1 with both the hub
    and the ELL tail non-empty."""
    mat, n_u, n_i = power_law_graph()
    kw = {"dense": {}, "dense_rw": {"norm": "rw"}, "hybrid": {"dense_budget": 1}}[path]
    jprop = jax_graph.BipartiteProp(mat, n_u, n_i, **kw)
    pprop = port_graph.BipartiteProp(mat, n_u, n_i, **kw)
    assert (pprop.dense, pprop.hybrid, pprop.hub_size) == (
        jprop.dense, jprop.hybrid, getattr(jprop, "hub_size", 0))
    if path == "hybrid":
        assert 0 < pprop.hub_size < n_i
    x = np.random.RandomState(4).randn(n_u + n_i, 16).astype(np.float32)
    jc = jprop.init_consts()

    def jloss(x):
        return jnp.sum(jprop(jc, jprop(jc, x)) ** 2)

    jy = jax.jit(lambda x: jprop(jc, x))(jnp.asarray(x))
    jg = jax.jit(jax.grad(jloss))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    _close(pprop(xt).detach().numpy(), jy)
    torch.sum(pprop(pprop(xt)) ** 2).backward()
    _close(xt.grad.numpy(), jg)
    assert not list(pprop.parameters()) and not pprop.state_dict()


def test_bipartite_prop_hybrid_buffers_match_jax_consts():
    mat, n_u, n_i = power_law_graph(seed=5)
    jc = jax_graph.BipartiteProp(mat, n_u, n_i, dense_budget=1).init_consts()
    buf = dict(port_graph.BipartiteProp(mat, n_u, n_i, dense_budget=1).named_buffers())
    assert buf["hub_R"].dtype == torch.bfloat16
    np.testing.assert_array_equal(buf["hub_R"].float().numpy(),
                                  np.asarray(jc["hub_R"]).astype(np.float32))
    np.testing.assert_array_equal(buf["gh_att_ext"].numpy(),
                                  np.append(np.asarray(jc["gh_att"]), 0.0))
    for k in ("hub_ids", "hub_pos", "ghf_eidx", "ghf_nbr", "ghf_inv"):
        np.testing.assert_array_equal(buf[k].numpy(), np.asarray(jc[k]))


def test_sorted_spmm_path_raises():
    mat, n_u, n_i = power_law_graph()
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        port_graph.BipartiteProp(mat, n_u, n_i, dense_budget=1, norm="rw")


# ----------------------------------------------- restricted applications

def _graph_pair(seed, hybrid=False):
    mat, n_u, n_i = power_law_graph(seed=seed, n_u=40, n_i=60, nnz=500)
    kw = {"dense_budget": 1} if hybrid else {}
    jprop = jax_graph.BipartiteProp(mat, n_u, n_i, **kw)
    jbg = jax_bg.BitRestrictedGraph(mat, n_u, n_i)
    consts = {**jprop.init_consts(), **jbg.init_consts()}
    return (mat, n_u, n_i, jprop, consts, port_graph.BipartiteProp(mat, n_u, n_i, **kw),
            port_bg.BitRestrictedGraph(mat, n_u, n_i))


def test_restricted_applies_match_jax_with_duplicate_rows():
    mat, n_u, n_i, _, c, _, pbg = _graph_pair(6)
    rng = np.random.RandomState(7)
    rows_u = np.array([0, 3, 3, 11, n_u - 1, 3], np.int64)
    rows_i = np.array([7, 7, 2, 19, 0], np.int64)
    v_i = rng.randn(n_i, 8).astype(np.float32)
    v_u = rng.randn(n_u, 8).astype(np.float32)
    g_u = rng.randn(len(rows_u), 8).astype(np.float32)
    g_i = rng.randn(len(rows_i), 8).astype(np.float32)
    cases = [
        (port_bg.restricted_rows_apply(pbg.bg_user_bits, _t(rows_u), pbg.bg_unorm, pbg.bg_inorm,
                                       _t(v_i)),
         jax_bg.restricted_rows_apply(c["bg_user_bits"], jnp.asarray(rows_u), c["bg_unorm"],
                                      c["bg_inorm"], jnp.asarray(v_i))),
        (port_bg.restricted_rows_apply(pbg.bg_item_bits, _t(rows_i), pbg.bg_inorm, pbg.bg_unorm,
                                       _t(v_u)),
         jax_bg.restricted_rows_apply(c["bg_item_bits"], jnp.asarray(rows_i), c["bg_inorm"],
                                      c["bg_unorm"], jnp.asarray(v_u))),
        (port_bg.restricted_cols_apply(pbg.bg_user_bits, _t(rows_u), pbg.bg_unorm, pbg.bg_inorm,
                                       _t(g_u), n_i),
         jax_bg.restricted_cols_apply(c["bg_user_bits"], jnp.asarray(rows_u), c["bg_unorm"],
                                      c["bg_inorm"], jnp.asarray(g_u), n_i)),
        (port_bg.restricted_cols_apply(pbg.bg_item_bits, _t(rows_i), pbg.bg_inorm, pbg.bg_unorm,
                                       _t(g_i), n_u),
         jax_bg.restricted_cols_apply(c["bg_item_bits"], jnp.asarray(rows_i), c["bg_inorm"],
                                      c["bg_unorm"], jnp.asarray(g_i), n_u)),
    ]
    for got, want in cases:
        assert got.shape == want.shape
        _close(got.numpy(), want)


def test_rows_to_dense_and_take_rows_match_jax():
    rows = np.array([5, 1, 5, 0, 16999], np.int64)
    vals = np.arange(20, dtype=np.float32).reshape(5, 4)
    for n in (17, 17000):
        r = rows % n
        _close(port_eg.dense_row_grad(_t(r), _t(vals), n).numpy(),
               jax_bg.rows_to_dense(jnp.asarray(r), jnp.asarray(vals), n), rtol=1e-6)
    x = np.random.RandomState(0).randn(9, 4).astype(np.float32)
    idx = np.random.RandomState(1).randint(0, 9, (5, 3)).astype(np.int64)
    jg = jax.grad(lambda x: jnp.sum(jnp.tanh(jax_bg.take_rows(9, x, jnp.asarray(idx)))))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    torch.sum(torch.tanh(port_eg.take_rows_dense_grad(9, xt, _t(idx)))).backward()
    _close(xt.grad.numpy(), jg, rtol=1e-6)


@pytest.mark.parametrize("n_layers,hybrid", [(2, False), (2, True), (1, False), (3, False)])
def test_linear_prop_batch_values_and_grads_match_jax(n_layers, hybrid):
    mat, n_u, n_i, jprop, c, pprop, pbg = _graph_pair(8, hybrid)
    jlpb = jax_bg.LinearPropBatch(jprop, n_u, n_i, n_layers)
    plpb = port_bg.LinearPropBatch(pprop, pbg, n_u, n_i, n_layers)
    rng = np.random.RandomState(9)
    xu = rng.randn(n_u, 8).astype(np.float32) * 0.1
    xi = rng.randn(n_i, 8).astype(np.float32) * 0.1
    rows_u = rng.randint(0, n_u, 6).astype(np.int64)
    rows_i = rng.randint(0, n_i, 12).astype(np.int64)
    rows_u[1] = rows_u[0]

    def jloss(p):
        e_u, e_i = jlpb(c, p["u"], p["i"], jnp.asarray(rows_u), jnp.asarray(rows_i))
        return jnp.sum(jnp.tanh(jnp.sum(e_u * e_i[:6], -1))) + jnp.sum(e_i[6:] ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))({"u": jnp.asarray(xu), "i": jnp.asarray(xi)})
    pu, pi = _t(xu).requires_grad_(True), _t(xi).requires_grad_(True)
    e_u, e_i = plpb(pu, pi, _t(rows_u), _t(rows_i))
    loss = torch.sum(torch.tanh(torch.sum(e_u * e_i[:6], -1))) + torch.sum(e_i[6:] ** 2)
    loss.backward()
    _close(float(loss.detach()), float(jl))
    _close(pu.grad.numpy(), jg["u"])
    _close(pi.grad.numpy(), jg["i"])


# ------------------------------------------------------------------- LightGCN

def _cfg(data_dir, tmp_path, **extra):
    return {"data_path": data_dir, "epochs": 2, "train_batch_size": 256,
            "eval_batch_size": 512, "checkpoint_dir": str(tmp_path / "saved"),
            "log_dir": str(tmp_path / "log"), "state": "ERROR",
            "valid_full_to_uni1000": False, "device": "cpu", **extra}


def _pipelines(cfg):
    jc = JaxConfig("LightGCN", "synth", config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jtrain, jvalid, jtest = jax_data_preparation(jc, jax_create_dataset(jc))
    jmodel = jax_get_model("LightGCN")(jc, jtrain.dataset)
    pc = Config("LightGCN", "synth", config_dict=cfg, _parse_cmd_line=False)
    init_seed(pc["seed"])
    ptrain, pvalid, ptest = data_preparation(pc, create_dataset(pc))
    pmodel = get_model("LightGCN")(pc, ptrain.dataset)
    return (JaxTrainer(jc, jmodel), jmodel, jtrain, jvalid, jtest,
            Trainer(pc, pmodel), pmodel, ptrain, pvalid, ptest)


def _np_params(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("restricted", [True, False])
def test_lightgcn_loss_and_grads_match_jax(synth_dataset_dir, tmp_path, restricted):
    cfg = _cfg(synth_dataset_dir, tmp_path, use_restricted_step=restricted)
    jtr, jmodel, jtrain, *_, pmodel, ptrain, _, _ = _pipelines(cfg)
    assert pmodel.use_restricted == jmodel.use_restricted == restricted
    params = jmodel.init_params(jax.random.key(0))
    load_jax_params(pmodel, _np_params(params))
    rng = np.random.RandomState(11)
    batch = {"user_id": rng.randint(1, pmodel.n_users, 32),
             "item_id": rng.randint(1, pmodel.n_items, 32),
             "neg_item_id": rng.randint(1, pmodel.n_items, 32)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        allow_int=True))(params)
    loss = pmodel.calculate_loss({k: torch.as_tensor(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [pmodel.user_embedding, pmodel.item_embedding])
    _close(float(loss), float(jl))
    _close(grads[0].numpy(), jg["user_embedding"])
    _close(grads[1].numpy(), jg["item_embedding"])


def test_lightgcn_default_gate_and_buffers(synth_dataset_dir, tmp_path):
    """The JAX gate: the dense operator on a small graph, so no restricted
    step; the operator's arrays are buffers, not parameters, and not in the
    state dict."""
    *_, pmodel, ptrain, _, _ = _pipelines(_cfg(synth_dataset_dir, tmp_path))
    assert pmodel.prop.dense and not pmodel.use_restricted
    assert [n for n, _ in pmodel.named_parameters()] == ["user_embedding", "item_embedding"]
    assert set(pmodel.state_dict()) == {"user_embedding", "item_embedding"}
    assert {n for n, _ in pmodel.named_buffers()} == {"prop.R"}


def test_build_norm_adj_matches_jax():
    mat, n_u, n_i = power_law_graph(seed=12)
    for a, b in zip(port_lightgcn.build_norm_adj(mat, n_u, n_i),
                    jax_lightgcn.build_norm_adj(mat, n_u, n_i)):
        np.testing.assert_array_equal(a, b)


def test_lightgcn_three_steps_and_full_sort_metrics_match_jax(synth_dataset_dir, tmp_path):
    """Three restricted steps on identical batches and injected negatives,
    the JAX step core with its fused Adam against the port's: params at rtol
    2e-4; then full-sort metrics on valid and test from the same weights."""
    cfg = _cfg(synth_dataset_dir, tmp_path, use_restricted_step=True)
    (jtrainer, jmodel, jtrain, jvalid, jtest,
     ptrainer, pmodel, ptrain, pvalid, ptest) = _pipelines(cfg)
    params = jmodel.init_params(jax.random.key(0))
    load_jax_params(pmodel, _np_params(params))
    jtrainer._fused_adam = True
    opt_state = jtrainer._fused_adam_init(params)
    jstep = jax.jit(jtrainer._make_step_core(lambda batch, rng, consts: batch,
                                             jmodel.calculate_loss))
    ptrainer.opt_state = ptrainer._fused_adam_init()
    pstep = ptrainer._make_step_core(lambda batch, gen, consts: batch, pmodel.calculate_loss)
    cols = ptrain.columns()
    rng = np.random.RandomState(0)
    key = jax.random.key(1)
    for _ in range(3):
        idx = rng.randint(0, ptrain.n, 256)
        batch = {"user_id": cols["user_id"][idx], "item_id": cols["item_id"][idx],
                 "neg_item_id": rng.randint(1, ptrain.n_items, 256)}
        params, opt_state, key, jloss, _ = jstep(
            params, opt_state, key, {k: jnp.asarray(v) for k, v in batch.items()}, {})
        ploss = pstep({k: torch.as_tensor(v).long() for k, v in batch.items()}, {})
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL)
    got = export_params(pmodel)
    assert set(got) == {"user_embedding", "item_embedding"}
    for name in got:
        np.testing.assert_allclose(got[name], np.asarray(params[name]), rtol=RTOL, atol=1e-5)

    jtrainer.params = params
    load_jax_params(pmodel, _np_params(params))
    for jdata, pdata in ((jvalid, pvalid), (jtest, ptest)):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])


def test_non_fused_eval_step_metrics_match_jax_exactly(synth_dataset_dir, tmp_path):
    """The non-fused full-sort step against the JAX eval_step on the same
    tie-free (B, n_items) scores: identical metrics."""
    (jtrainer, jmodel, _, jvalid, _, ptrainer, pmodel, _, pvalid, _) = _pipelines(
        _cfg(synth_dataset_dir, tmp_path))
    scores = np.random.RandomState(13).permutation(
        pmodel.n_users * pmodel.n_items).reshape(pmodel.n_users, pmodel.n_items)
    scores = (scores / scores.size).astype(np.float32)
    jmodel.full_sort_predict = lambda params, batch: jnp.asarray(scores)[batch["user_id"]]
    pmodel.full_sort_predict = lambda batch: torch.as_tensor(scores)[batch["user_id"]]
    jtrainer.params = jmodel.init_params(jax.random.key(0))
    jres = jtrainer.evaluate(jvalid, load_best_model=False)
    pres = ptrainer.evaluate(pvalid, load_best_model=False)
    assert jres == pres


def test_lightgcn_on_cpu_end_to_end(synth_dataset_dir, tmp_path):
    """LightGCN through run_recbole with the restricted step forced on."""
    result = run_recbole(model="LightGCN", dataset="synth", config_dict=_cfg(
        synth_dataset_dir, tmp_path, use_restricted_step=True), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert tr["hit@10"] > 0.05


def test_lightgcn_resume_matches_straight_run(synth_dataset_dir, tmp_path):
    """Two epochs, a checkpoint holding the parameters and no buffer, a
    resumed trainer for two more: the same parameters, moments and loss
    curve as four epochs straight."""
    def pipeline(sub, epochs):
        cfg = _cfg(synth_dataset_dir, tmp_path / sub, epochs=epochs, use_restricted_step=True)
        pc = Config("LightGCN", "synth", config_dict=cfg, _parse_cmd_line=False)
        init_seed(pc["seed"])
        train, _, _ = data_preparation(pc, create_dataset(pc))
        model = get_model("LightGCN")(pc, train.dataset)
        return Trainer(pc, model), model, train

    straight, smodel, strain = pipeline("a", 4)
    straight.fit(strain, None, saved=False, verbose=False)
    first, _, ftrain = pipeline("b", 2)
    first.fit(ftrain, None, saved=True, verbose=False)
    state = torch.load(first.saved_model_file, map_location="cpu", weights_only=False)
    assert set(state["params"]) == set(state["opt_state"]["mu"]) == {"user_embedding",
                                                                      "item_embedding"}
    resumed, rmodel, rtrain = pipeline("c", 4)
    resumed.resume_checkpoint(first.saved_model_file)
    assert resumed.start_epoch == 2
    resumed.fit(rtrain, None, saved=False, verbose=False)
    for name, p in smodel.named_parameters():
        assert torch.equal(p, dict(rmodel.named_parameters())[name]), name
        assert torch.equal(straight.opt_state["nu"][name], resumed.opt_state["nu"][name])
    assert straight.train_loss_dict == resumed.train_loss_dict


def test_convert_skips_the_const_subtree(synth_dataset_dir, tmp_path):
    """A JAX LightGCN tree, _const included, loads into the port and exports
    back without it."""
    cfg = _cfg(synth_dataset_dir, tmp_path, use_restricted_step=True)
    _, jmodel, *_, pmodel, _, _, _ = _pipelines(cfg)
    params = _np_params(jmodel.init_params(jax.random.key(3)))
    assert "bg_user_bits" in params["_const"]
    load_jax_params(pmodel, params)
    out = export_params(pmodel)
    assert set(out) == {"user_embedding", "item_embedding"}
    for k in out:
        np.testing.assert_array_equal(out[k], params[k])


def test_inter_matrix_matches_jax(synth_dataset_dir, tmp_path):
    """The interaction matrix both packages build LightGCN from, on the
    whole synthetic dataset, its train split and ml-100k (repeated pairs
    summed by the CSR conversion in both)."""
    cfg = _cfg(synth_dataset_dir, tmp_path)
    for name, extra in (("synth", {}), ("ml-100k", {"data_path": None})):
        c = {k: v for k, v in {**cfg, **extra}.items() if v is not None}
        jds = jax_create_dataset(JaxConfig("LightGCN", name, config_dict=c, _parse_cmd_line=False))
        pds = create_dataset(Config("LightGCN", name, config_dict=c, _parse_cmd_line=False))
        pairs = [(jds, pds)]
        if name == "synth":
            jc = JaxConfig("LightGCN", name, config_dict=c, _parse_cmd_line=False)
            pc = Config("LightGCN", name, config_dict=c, _parse_cmd_line=False)
            jax_init_seed(jc["seed"])
            jtrain = jax_data_preparation(jc, jds)[0].dataset
            init_seed(pc["seed"])
            pairs.append((jtrain, data_preparation(pc, pds)[0].dataset))
        for j, p in pairs:
            a, b = j.inter_matrix("csr"), p.inter_matrix("csr")
            assert a.shape == b.shape and (a != b).nnz == 0


def test_unported_graph_models_and_eval_fallback_raise(synth_dataset_dir, tmp_path,
                                                       monkeypatch):
    for name in ("NGCF", "SpectralCF", "GCMC", "DGCF"):
        with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
            get_model(name)
    *_, ptrainer, pmodel, _, pvalid, _ = _pipelines(_cfg(synth_dataset_dir, tmp_path))
    # a model without full_sort_predict is scored by score_items over chunks
    # of the items, by default through predict: the same metrics
    ref = ptrainer.evaluate(pvalid, load_best_model=False)
    from recbole_tpu_torch.models.base import AbstractRecommender
    monkeypatch.setattr(type(pmodel), "full_sort_predict", AbstractRecommender.full_sort_predict)
    ptrainer._eval_step_cache.clear()
    got = ptrainer.evaluate(pvalid, load_best_model=False)
    assert set(got) == set(ref) and all(abs(got[k] - ref[k]) <= 1e-6 for k in ref)
