"""The port's kernel modules against the JAX package's kernel functions.

On the CPU each port module runs its plain PyTorch version; it is held
against the JAX function as the JAX tests run it (the XLA reference, and the
Pallas kernel in interpret mode). The tests marked ``cuda`` hold the
hand-written kernels against the plain versions on the card, at the main
path's shapes, and skip where torch finds no CUDA device.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.ops import embed_grad as jax_eg
from recbole_tpu.ops.fused_adam import adam_leaf_kernel
from recbole_tpu.ops.masked_topk import masked_topk_pallas, masked_topk_xla
from recbole_tpu_torch.ops import bit_kernels as port_bits
from recbole_tpu_torch.ops import embed_grad as port_eg
from recbole_tpu_torch.ops import fused_adam, masked_topk as port_topk
from recbole_tpu_torch.ops import fused_attention as port_attn
from recbole_tpu_torch.ops import fused_gru as port_gru
from recbole_tpu_torch.ops import rel_apply as port_rel
from recbole_tpu_torch.ops import trm_layer as port_trm

B1, B2, LR, EPS = 0.9, 0.999, 1e-3, 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _topk_inputs(B, N, D, seed, history=40):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, D).astype(np.float32)
    items = rng.randn(N, D).astype(np.float32)
    mask = np.zeros((B, N), np.int8)
    mask[:, 0] = 1
    for b in range(B):
        mask[b, rng.choice(N, min(history, N // 4), replace=False)] = 1
    return q, items, mask


def _adam_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype(np.float32) * 0.1
    m = rng.randn(*shape).astype(np.float32) * 1e-3
    v = np.abs(rng.randn(*shape)).astype(np.float32) * 1e-6
    g = rng.randn(*shape).astype(np.float32) * 1e-3
    return p, m, v, g


# ------------------------------------------------------------- masked top-k

@pytest.mark.parametrize("n_items", [300, 1683])
def test_masked_topk_plain_matches_jax(n_items):
    """Tie-free scores: ids exact, values at rtol 1e-6 (the two matmuls sum
    in different orders)."""
    q, items, mask = _topk_inputs(16, n_items, 32, seed=3)
    k = 10
    v, i = port_topk.masked_topk_torch(torch.from_numpy(q), torch.from_numpy(items),
                                       torch.from_numpy(mask), k)
    v_xla, i_xla = masked_topk_xla(jnp.asarray(q), jnp.asarray(items),
                                   jnp.asarray(mask), k)
    v_pl, i_pl = masked_topk_pallas(jnp.asarray(q), jnp.asarray(items),
                                    jnp.asarray(mask), k, tile_n=512, interpret=True)
    assert i.dtype == torch.int32
    for v_ref, i_ref in ((v_xla, i_xla), (v_pl, i_pl)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-6)
    assert not np.take_along_axis(mask, i.numpy().astype(np.int64), 1).any()


def test_masked_topk_ties_go_to_lower_id():
    """Duplicated item rows tie exactly; both packages list the lower id
    first, as lax.top_k does."""
    q, items, mask = _topk_inputs(8, 64, 16, seed=5, history=0)
    mask[:, 0] = 1
    items[40] = items[7]
    items[50] = items[7]
    items[33] = items[12]
    q[:, :] = q[0]
    k = 64 - 1
    v, i = port_topk.masked_topk_torch(torch.from_numpy(q), torch.from_numpy(items),
                                       torch.from_numpy(mask), k)
    _, i_xla = masked_topk_xla(jnp.asarray(q), jnp.asarray(items), jnp.asarray(mask), k)
    ids = list(i[0].numpy())
    assert ids.index(7) < ids.index(40) < ids.index(50)
    assert ids.index(12) < ids.index(33)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_xla))


def test_masked_topk_dispatch_on_cpu_runs_plain_version():
    q, items, mask = _topk_inputs(4, 50, 8, seed=1)
    before = port_topk.masked_topk_cuda.launches
    args = (torch.from_numpy(q), torch.from_numpy(items), torch.from_numpy(mask), 5)
    v, i = port_topk.masked_topk(*args)
    v_ref, i_ref = port_topk.masked_topk_torch(*args)
    assert torch.equal(i, i_ref) and torch.equal(v, v_ref)
    assert port_topk.masked_topk_cuda.launches == before


def test_masked_topk_launcher_refuses_cpu_tensors():
    q, items, mask = _topk_inputs(4, 50, 8, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        port_topk.masked_topk_cuda(torch.from_numpy(q), torch.from_numpy(items),
                                   torch.from_numpy(mask), 5)


# --------------------------------------------------------------------- adam

def test_adam_plain_matches_jax_expression():
    """The plain sweep against the inline JAX expression of trainer.py:335-337,
    at rtol 1e-6 (same fp32 operation order; the CPU kernels may round
    sqrt and division differently in the last ulp)."""
    p, m, v, g = _adam_inputs((300, 64), seed=0)
    c1, c2 = 1.0 / (1.0 - B1 ** 3), 1.0 / (1.0 - B2 ** 3)
    jm = B1 * jnp.asarray(m) + (1.0 - B1) * jnp.asarray(g)
    jv = B2 * jnp.asarray(v) + (1.0 - B2) * jnp.asarray(g) * jnp.asarray(g)
    jp = jnp.asarray(p) - LR * (jm * jnp.float32(c1)) / (
        jnp.sqrt(jv * jnp.float32(c2)) + EPS)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    out = fused_adam.adam_leaf_torch(tp, tm, tv, torch.from_numpy(g), c1, c2,
                                     b1=B1, b2=B2, lr=LR, eps=EPS)
    assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
    for got, ref in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_adam_plain_matches_pallas_kernel_interpret():
    """Against adam_leaf_kernel in interpret mode, at 2 x 131072 elements
    (interpret mode needs a multiple of the kernel's 131072-element chunk):
    rtol 1e-6, plus atol 1e-6 of the tensor's largest magnitude, since the
    interpret-mode program rounds the update term differently in its last
    ulp and p - update cancels where the two are close."""
    from jax.experimental.pallas import tpu as pltpu
    p, m, v, g = _adam_inputs((2, 131072), seed=1)
    c1, c2 = 1.0 / (1.0 - B1 ** 2), 1.0 / (1.0 - B2 ** 2)
    with pltpu.force_tpu_interpret_mode():
        jp, jm, jv = adam_leaf_kernel(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
                                      jnp.asarray(g), jnp.float32(c1), jnp.float32(c2),
                                      b1=B1, b2=B2, lr=LR, eps=EPS)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    fused_adam.adam_leaf(tp, tm, tv, torch.from_numpy(g), c1, c2,
                         b1=B1, b2=B2, lr=LR, eps=EPS)
    for got, ref in ((tp, jp), (tm, jm), (tv, jv)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())


def test_adam_launcher_refuses_cpu_tensors():
    """adam_multi_cuda raises on CPU leaves, and counts no launch."""
    p, m, v, g = (torch.from_numpy(a) for a in _adam_inputs((4, 4), seed=2))
    before = fused_adam.adam_multi_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.adam_multi_cuda(fused_adam.AdamLeaves([p], [m], [v]), [g], 1.0, 1.0,
                                   b1=B1, b2=B2, lr=LR, eps=EPS)
    assert fused_adam.adam_multi_cuda.launches == before


# a SASRec-like leaf set (two layers at width 8, inner 16): the item table
# with its [PAD] row, the position table, LayerNorm gains and biases, and a
# layer's matrices and biases; "bias0" is 0-d and "unused" gets no gradient
ADAM_LEAVES = {"item_embedding": (13, 8), "position_embedding": (6, 8), "ln_g": (8,),
               "ln_b": (8,), "unused": (5, 3), "bias0": ()}
for _l in range(2):
    ADAM_LEAVES.update({f"encoder.{_l}.wq": (8, 8), f"encoder.{_l}.bq": (8,),
                        f"encoder.{_l}.ff1_w": (8, 16), f"encoder.{_l}.ff1_b": (16,),
                        f"encoder.{_l}.ff2_w": (16, 8)})


def test_adam_multi_plain_matches_jax_fused_adam_apply():
    """Three steps of adam_multi_torch over ADAM_LEAVES against the JAX
    trainer's _fused_adam_apply on the same numpy params and gradients:
    the unused leaf's gradient is None here and zeros in JAX, and
    item_embedding's zero_head (its [PAD] row) is given to JAX as gradients
    with row 0 zeroed. rtol 1e-6 plus 1e-6 of the tensor's largest magnitude
    (JAX computes c1 and c2 in fp32 from the count, the port in double)."""
    from types import SimpleNamespace
    from recbole_tpu.trainer.trainer import Trainer as JaxTrainer
    rng = np.random.RandomState(7)
    names = list(ADAM_LEAVES)
    p0 = {n: np.asarray(rng.randn(*s) * 0.1, np.float32) for n, s in ADAM_LEAVES.items()}
    grads = [{n: np.asarray(rng.randn(*s) * 1e-3, np.float32) for n, s in ADAM_LEAVES.items()}
             for _ in range(3)]
    for g in grads:
        g["unused"] = None
    jself = SimpleNamespace(config={"learning_rate": LR}, ADAM_B1=B1, ADAM_B2=B2, ADAM_EPS=EPS)
    jparams = {n: jnp.asarray(a) for n, a in p0.items()}
    jstate = JaxTrainer._fused_adam_init(jself, jparams)

    tp = [torch.from_numpy(p0[n].copy()) for n in names]
    leaves = fused_adam.AdamLeaves(tp, [torch.zeros_like(p) for p in tp],
                                   [torch.zeros_like(p) for p in tp],
                                   [8 if n == "item_embedding" else 0 for n in names])
    for t, g in enumerate(grads, start=1):
        jg = {n: jnp.zeros(ADAM_LEAVES[n], jnp.float32) if a is None else jnp.asarray(a)
              for n, a in g.items()}
        jg["item_embedding"] = jg["item_embedding"].at[0].set(0.0)
        jparams, jstate = JaxTrainer._fused_adam_apply(jself, jparams, jstate, jg)
        tg = [None if g[n] is None else torch.from_numpy(g[n]) for n in names]
        fused_adam.adam_multi(leaves, tg, 1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t),
                              b1=B1, b2=B2, lr=LR, eps=EPS)
    for i, n in enumerate(names):
        for got, ref in ((leaves.p[i], jparams[n]), (leaves.m[i], jstate["mu"][n]),
                         (leaves.v[i], jstate["nu"][n])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=n)
    item = names.index("item_embedding")
    assert not leaves.m[item][0].any() and not leaves.v[item][0].any()
    assert torch.equal(leaves.p[item][0], torch.from_numpy(p0["item_embedding"][0]))


def test_adam_multi_dispatch_on_cpu_runs_plain_version():
    """On CPU leaves the dispatcher is the plain version: the same bits as
    adam_leaf_torch on zero-filled gradients, and no launch counted."""
    rng = np.random.RandomState(3)
    shapes = [(7, 4), (5,), ()]
    p0 = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    g = [np.asarray(rng.randn(*s) * 1e-3, np.float32) for s in shapes]
    before = fused_adam.adam_multi_cuda.launches
    leaves = fused_adam.AdamLeaves([torch.from_numpy(a.copy()) for a in p0],
                                   [torch.zeros(s) for s in shapes],
                                   [torch.zeros(s) for s in shapes], [4, 0, 0])
    fused_adam.adam_multi(leaves, [torch.from_numpy(g[0]), None, torch.from_numpy(g[2])],
                          10.0, 1000.0, b1=B1, b2=B2, lr=LR, eps=EPS)
    assert fused_adam.adam_multi_cuda.launches == before
    g[0][0] = 0.0
    g[1] = np.zeros(shapes[1], np.float32)
    for i, s in enumerate(shapes):
        p, m, v = torch.from_numpy(p0[i].copy()), torch.zeros(s), torch.zeros(s)
        fused_adam.adam_leaf_torch(p, m, v, torch.from_numpy(g[i]), 10.0, 1000.0,
                                   b1=B1, b2=B2, lr=LR, eps=EPS)
        assert torch.equal(leaves.p[i], p) and torch.equal(leaves.m[i], m)
        assert torch.equal(leaves.v[i], v)


def test_adam_after_resume_checkpoint_updates_the_resumed_state(tmp_path):
    """The trainer's leaves follow resume_checkpoint on the CPU too."""
    _adam_resume_case(torch.device("cpu"), tmp_path)


def test_adam_leaf_table_chunks_groups_and_alignment():
    """The kernel's leaf records: leaves of no element left out, chunk
    prefixes counted from each launch's first leaf, a new launch every
    MAX_LEAVES records, and the 16-byte path only where p, m and v are all
    16-byte aligned."""
    C, K = fused_adam.CHUNK, fused_adam.MAX_LEAVES
    numels = [C * 3 + 1, 0, 1, C] + [5] * (K + 2)
    addrs = [(4096 * i, 4096 * i + 1024, 4096 * i + 2048) for i in range(len(numels))]
    addrs[2] = (4096 * 2 + 4, 4096 * 2 + 1024, 4096 * 2 + 2048)
    heads = [11] + [0] * (len(numels) - 1)
    table, rows, groups = fused_adam.leaf_table(addrs, numels, heads)
    assert rows == [0] + list(range(2, len(numels)))
    assert table.dtype.itemsize == 56 and len(table) == len(numels) - 1
    assert list(table["chunk_start"][:4]) == [0, 4, 5, 6]
    assert list(table["vec"][:3]) == [1, 0, 1] and table["zero_head"][0] == 11
    assert table["n"][0] == C * 3 + 1 and table["p"][1] == 4096 * 2 + 4
    assert not table["g"].any()
    assert groups == [(0, K, 4 + 1 + 1 + (K - 3)), (K, len(rows) - K, len(rows) - K)]
    assert table["chunk_start"][K] == 0 and table["chunk_start"][K + 1] == 1


def test_adam_multi_refuses_mismatched_lists():
    with pytest.raises(ValueError, match="one length"):
        fused_adam.AdamLeaves([torch.zeros(3)], [torch.zeros(3)], [])
    leaves = fused_adam.AdamLeaves([torch.zeros(3)], [torch.zeros(3)], [torch.zeros(3)])
    with pytest.raises(ValueError, match="gradients"):
        fused_adam.adam_multi(leaves, [], 1.0, 1.0, b1=B1, b2=B2, lr=LR, eps=EPS)


# ------------------------------------------------------- embedding gradients

def _grad_inputs(R, V, D, seed, dtype=np.float32):
    """Heavy duplicates (ids drawn with a cubic skew toward 0), id 0 present."""
    rng = np.random.RandomState(seed)
    ids = np.floor(V * rng.random_sample(R) ** 3.0).astype(np.int64)
    if R:
        ids[R // 2] = 0
    g = rng.randn(R, D).astype(np.float32)
    return ids, g


def _abs_sums(ids, g, V):
    """sum over r with ids[r] == v of |g[r, d]|: the scale of the hi + lo bound."""
    out = np.zeros((V, g.shape[1]), np.float64)
    np.add.at(out, ids, np.abs(g.astype(np.float64)))
    return out


def _hi_lo_bound(ids, g, V):
    """The plain version is the exact fp32 sum; the JAX functions feed the
    matrix unit a bf16 hi + lo pair of each fp32 term and so drop what lies
    below 16 mantissa bits: |diff| <= 2^-16 * sum|g| + 1e-6 elementwise."""
    return 2.0 ** -16 * _abs_sums(ids, g, V) + 1e-6


@pytest.mark.parametrize("D", [1, 11, 64])
@pytest.mark.parametrize("bf16", [False, True])
def test_onehot_grad_plain_matches_jax(D, bf16):
    """R = 1000 (not a multiple of the Pallas kernel's 512-row chunk) into
    V = 300 rows, against the Pallas kernel in interpret mode and the XLA
    scan. A bf16 cotangent is upcast losslessly by both, so only the fp32
    sum order differs there."""
    from jax.experimental.pallas import tpu as pltpu
    R, V = 1000, 300
    ids, g = _grad_inputs(R, V, D, seed=D)
    tg = torch.from_numpy(g)
    jg = jnp.asarray(g)
    if bf16:
        tg = tg.to(torch.bfloat16)
        jg = jg.astype(jnp.bfloat16)
        g = tg.to(torch.float32).numpy()
    out = port_eg.onehot_matmul_grad(torch.from_numpy(ids), tg, V)
    assert out.dtype == torch.float32 and tuple(out.shape) == (V, D)
    exact = np.zeros((V, D), np.float64)
    np.add.at(exact, ids, g.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), exact, rtol=1e-5, atol=1e-5)
    bound = _hi_lo_bound(ids, g, V)
    with pltpu.force_tpu_interpret_mode():
        ref_pl = jax_eg.onehot_matmul_grad(jnp.asarray(ids, jnp.int32), jg, V)
    ref_xla = jax_eg.onehot_matmul_grad_xla(jnp.asarray(ids, jnp.int32), jg, V)
    for ref in (ref_pl, ref_xla):
        assert (np.abs(out.numpy() - np.asarray(ref)) <= bound).all()


def test_windowed_grad_plain_matches_jax_and_numpy():
    """Against the Pallas kernel in interpret mode and numpy's add.at:
    rtol 1e-6 (plus 1e-6 absolute where a row's terms cancel). All three
    add exact fp32 terms; only the order differs."""
    from jax.experimental.pallas import tpu as pltpu
    R, V, D = 1000, 300, 11
    ids, g = _grad_inputs(R, V, D, seed=7)
    out = port_eg.windowed_grad(torch.from_numpy(ids), torch.from_numpy(g), V)
    ref_np = np.zeros((V, D), np.float32)
    np.add.at(ref_np, ids, g)
    with pltpu.force_tpu_interpret_mode():
        ref_pl = jax_eg.windowed_grad(jnp.asarray(ids, jnp.int32), jnp.asarray(g), V)
    np.testing.assert_allclose(out.numpy(), ref_np, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_pl), rtol=1e-6, atol=1e-6)


def _windowed_refs(ids, g, n_rows, id_base=0):
    """numpy's add.at over the ids in [id_base, id_base + n_rows), and the
    JAX package's windowed_grad (the Pallas kernel in interpret mode) on the
    local ids, which drops the others itself."""
    from jax.experimental.pallas import tpu as pltpu
    local = ids - id_base
    keep = (local >= 0) & (local < n_rows)
    ref_np = np.zeros((n_rows, g.shape[1]), np.float32)
    np.add.at(ref_np, local[keep], g[keep])
    with pltpu.force_tpu_interpret_mode():
        ref_pl = jax_eg.windowed_grad(jnp.asarray(local, jnp.int32), jnp.asarray(g), n_rows)
    return ref_np, np.asarray(ref_pl)


@pytest.mark.parametrize("case", ["below and past the table", "around a nonzero id_base"])
def test_windowed_grad_plain_drops_ids_outside_the_range(case):
    """Ids outside [id_base, id_base + n_rows) add to no row, as in the JAX
    package's windowed_grad and in the kernel: [-1, 2, 7] into 5 rows is
    row 2 alone, and with id_base 20 the ids 19 and 25 are dropped."""
    if case == "below and past the table":
        ids, id_base = np.array([-1, 2, 7], np.int64), 0
    else:
        ids, id_base = np.array([19, 22, 25, 24, 20, 19, 26], np.int64), 20
    g = np.arange(1, 2 * len(ids) + 1, dtype=np.float32).reshape(-1, 2)
    out = port_eg.windowed_grad(torch.from_numpy(ids), torch.from_numpy(g), 5, id_base=id_base)
    ref_np, ref_pl = _windowed_refs(ids, g, 5, id_base)
    np.testing.assert_array_equal(out.numpy(), ref_np)
    np.testing.assert_array_equal(out.numpy(), ref_pl)
    hit = np.unique(ids[(ids >= id_base) & (ids < id_base + 5)] - id_base)
    assert sorted(np.nonzero(out.numpy().any(axis=1))[0].tolist()) == hit.tolist()


def _skewed_case(R, V, D, seed):
    """Cubic skew toward the first rows, and one row (V // 3) that holds a
    quarter of R."""
    rng = np.random.RandomState(seed)
    ids = np.floor(V * rng.random_sample(R) ** 3.0).astype(np.int64)
    ids[rng.permutation(R)[:R // 4]] = V // 3
    g = rng.randn(R, D).astype(np.float32)
    return ids, g


def _exact_sums(ids, g, V):
    out = np.zeros((V, g.shape[1]), np.float64)
    np.add.at(out, ids, g.astype(np.float64))
    return out


def test_windowed_grad_plain_skewed_matches_jax_and_numpy():
    """The hot-row skew the kernel splits into pieces: against the exact
    (float64) sums at rtol 1e-6 (plus 1e-6 absolute), as the unskewed test;
    against the Pallas kernel in interpret mode, which adds the 500 terms of
    the hot row one by one in fp32 and so is off the exact sum by a few
    1e-6 of it, within 1e-6 of the sum of the terms' magnitudes."""
    R, V, D = 2000, 700, 11
    ids, g = _skewed_case(R, V, D, seed=21)
    out = port_eg.windowed_grad(torch.from_numpy(ids), torch.from_numpy(g), V)
    _, ref_pl = _windowed_refs(ids, g, V)
    np.testing.assert_allclose(out.numpy(), _exact_sums(ids, g, V), rtol=1e-6, atol=1e-6)
    assert (np.abs(out.numpy() - ref_pl) <= 1e-6 * _abs_sums(ids, g, V) + 1e-6).all()


def test_grouped_take_rows_large_field_skewed_matches_jax_grad():
    """GroupedTakeRows' CPU backward on one large-vocabulary field (the
    windowed path) at the hot-row skew: against the exact sums at rtol 1e-6
    (plus 1e-6 absolute), and against jax.grad through the JAX package's
    grouped_take_rows (its scatter adds the fp32 terms one by one) within
    1e-6 of the sum of their magnitudes, as above."""
    B, V, D = 1600, port_eg.SMALL_VOCAB_MAX + 3000, 11
    ids, g = _skewed_case(B, V, D, seed=22)
    spec = ((0, V),)
    table = np.random.RandomState(23).randn(V, D).astype(np.float32)
    w = g[:, None, :]
    jgrad = jax.grad(lambda t: jnp.sum(jax_eg.grouped_take_rows(
        spec, t, jnp.asarray(ids[:, None], jnp.int32)) * jnp.asarray(w)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (port_eg.grouped_take_rows(spec, t, torch.from_numpy(ids[:, None]))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), _exact_sums(ids, g, V), rtol=1e-6, atol=1e-6)
    assert (np.abs(t.grad.numpy() - np.asarray(jgrad)) <= 1e-6 * _abs_sums(ids, g, V)
            + 1e-6).all()
    assert abs(t.grad[V // 3]).sum() > 0


@pytest.mark.parametrize("fn", [port_eg.onehot_matmul_grad_torch, port_eg.windowed_grad_torch])
def test_embed_grad_plain_edge_cases(fn):
    """No rows at all, one row, every id equal, a (B, fs) column block with
    an id base, writing into a row range of a larger table, and ids below
    and past the range, which add to no row."""
    assert torch.count_nonzero(fn(torch.zeros(0, dtype=torch.int64),
                                  torch.zeros((0, 3)), 5)) == 0
    one = fn(torch.tensor([2]), torch.tensor([[1.0, 2.0]]), 4)
    assert one.tolist() == [[0, 0], [0, 0], [1, 2], [0, 0]]
    g = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    same = fn(torch.full((6,), 3), g, 5)
    assert same[3].tolist() == [30.0, 36.0] and torch.count_nonzero(same) == 2
    ids = torch.tensor([[10, 3, 21], [11, 4, 20], [10, 4, 22]])
    gg = torch.arange(18, dtype=torch.float32).reshape(3, 3, 2)
    table = torch.full((30, 2), -1.0)
    fn(ids[:, 2:3], gg[:, 2:3], 5, out=table[20:25], id_base=20)
    assert table[20].tolist() == [10.0, 11.0] and table[21].tolist() == [4.0, 5.0]
    assert table[22].tolist() == [16.0, 17.0] and table[23].tolist() == [0.0, 0.0]
    assert (table[:20] == -1).all() and (table[25:] == -1).all()
    fn(torch.tensor([[19, 21], [25, 24], [-3, 20]]), gg[:, :2], 5, out=table[20:25], id_base=20)
    assert table[21].tolist() == [2.0, 3.0] and table[24].tolist() == [8.0, 9.0]
    assert table[20].tolist() == [14.0, 15.0] and torch.count_nonzero(table[20:25]) == 6
    assert (table[:20] == -1).all() and (table[25:] == -1).all()


def test_embed_grad_launchers_refuse_cpu_tensors():
    ids, g = _grad_inputs(8, 5, 3, seed=0)
    for fn in (port_eg.onehot_matmul_grad_cuda, port_eg.windowed_grad_cuda):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.from_numpy(ids), torch.from_numpy(g), 5)
        assert fn.launches == before


def test_field_runs_group_adjacent_fields_of_one_class():
    spec = ((0, 20000), (20000, 30000), (50000, 100), (50100, 50), (50150, 17000), (67150, 7))
    assert port_eg.field_runs(spec) == [
        (0, 2, 0, 50000, False), (2, 4, 50000, 150, True),
        (4, 5, 50150, 17000, False), (5, 6, 67150, 7, True)]


def test_field_runs_cut_small_runs_at_the_one_hot_limit():
    """Adjacent small fields are merged only up to ONEHOT_MAX_ROWS rows, the
    most one one-hot call takes; a field that would pass it starts a run."""
    V = port_eg.SMALL_VOCAB_MAX
    n = port_eg.ONEHOT_MAX_ROWS // V
    spec = tuple((k * V, V) for k in range(n + 2))
    assert port_eg.field_runs(spec) == [(0, n, 0, n * V, True),
                                        (n, n + 2, n * V, 2 * V, True)]


def _hot_row_case(seed, B=512):
    """A CTR batch whose first field has 62 rows drawn with cubic skew (its
    first row takes about a quarter of the ids) beside a 7-row field whose
    every id is one row, and a (B, 2, 11) cotangent."""
    rng = np.random.RandomState(seed)
    spec = ((0, 62), (62, 7))
    ids = np.stack([1 + np.floor(60 * rng.random_sample(B) ** 3.0).astype(np.int64),
                    np.full(B, 62 + 3, np.int64)], axis=1)
    w = rng.randn(B, 2, 11).astype(np.float32)
    return spec, ids, w


def test_onehot_grad_hot_rows_match_jax_xla():
    """At the hot-row skew: the plain version and GroupedTakeRows' CPU
    backward against the JAX package's onehot_matmul_grad_xla (fp32, rtol
    2e-4 of each row's magnitude)."""
    spec, ids, w = _hot_row_case(31)
    V, D = 69, 11
    flat_ids, flat_w = ids.reshape(-1), w.reshape(-1, D)
    ref = np.asarray(jax_eg.onehot_matmul_grad_xla(jnp.asarray(flat_ids, jnp.int32),
                                                   jnp.asarray(flat_w), V))
    tol = 2e-4 * _abs_sums(flat_ids, flat_w, V) + 1e-6
    plain = port_eg.onehot_matmul_grad_torch(torch.from_numpy(flat_ids),
                                             torch.from_numpy(flat_w), V)
    assert (np.abs(plain.numpy() - ref) <= tol).all()
    t = torch.zeros(V, D, requires_grad=True)
    (port_eg.grouped_take_rows(spec, t, torch.from_numpy(ids))
     * torch.from_numpy(w)).sum().backward()
    assert (np.abs(t.grad.numpy() - ref) <= tol).all()
    assert abs(t.grad[1]).sum() > 0 and abs(t.grad[65]).sum() > 0


# one field above SMALL_VOCAB_MAX rows between small ones
_FIELD_VOCABS = (40, 7, 17000, 300)


def _field_case(seed, D):
    rng = np.random.RandomState(seed)
    offs = np.concatenate([[0], np.cumsum(_FIELD_VOCABS)[:-1]])
    spec = tuple((int(o), int(v)) for o, v in zip(offs, _FIELD_VOCABS))
    V, B = int(sum(_FIELD_VOCABS)), 96
    ids = np.stack([o + np.floor(v * rng.random_sample(B) ** 3.0).astype(np.int64)
                    for o, v in spec], axis=1)
    table = rng.randn(V, D).astype(np.float32)
    w = rng.randn(B, len(spec), D).astype(np.float32)
    return spec, V, ids, table, w


@pytest.mark.parametrize("D", [11, 1])
def test_grouped_take_rows_matches_jax_grad(D):
    """Forward exactly, and the (V, D) gradient of sum(w * rows) against
    jax.grad through grouped_take_rows, within the hi + lo bound (its small
    fields go through the one-hot matmul; the large field's scatter adds
    exact terms)."""
    spec, V, ids, table, w = _field_case(3, D)
    jrows = jax_eg.grouped_take_rows(spec, jnp.asarray(table), jnp.asarray(ids, jnp.int32))
    jgrad = jax.grad(lambda t: jnp.sum(jax_eg.grouped_take_rows(
        spec, t, jnp.asarray(ids, jnp.int32)) * jnp.asarray(w)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    rows = port_eg.grouped_take_rows(spec, t, torch.from_numpy(ids))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(jrows))
    (rows * torch.from_numpy(w)).sum().backward()
    bound = _hi_lo_bound(ids.reshape(-1), w.reshape(-1, D), V)
    assert tuple(t.grad.shape) == (V, D)
    assert (np.abs(t.grad.numpy() - np.asarray(jgrad)) <= bound).all()


def test_grouped_take_rows_zero_fills_rows_outside_every_field():
    """A field_spec that leaves gaps in the table: rows no field covers get
    a zero gradient, not uninitialised memory."""
    spec = ((2, 5), (10, 4))
    t = torch.randn(20, 3, requires_grad=True)
    ids = torch.tensor([[2, 10], [6, 13], [6, 10]])
    port_eg.grouped_take_rows(spec, t, ids).sum().backward()
    want = torch.zeros(20, 3)
    want[2], want[6], want[10], want[13] = 1.0, 2.0, 2.0, 1.0
    assert torch.equal(t.grad, want)


def test_grouped_take_rows_on_a_column_view_lands_in_that_column():
    """The standalone first-order path: the lookup reads the (V, 1) view of
    column D of the merged table, and autograd puts the dense gradient there."""
    spec, V, ids, table, w = _field_case(5, 4)
    t = torch.from_numpy(table).requires_grad_()
    rows = port_eg.grouped_take_rows(spec, t[:, -1:], torch.from_numpy(ids))
    (rows[..., 0] * torch.from_numpy(w[..., 0])).sum().backward()
    ref = np.zeros(V, np.float32)
    np.add.at(ref, ids.reshape(-1), w[..., 0].reshape(-1))
    np.testing.assert_allclose(t.grad[:, -1].numpy(), ref, rtol=1e-6, atol=1e-6)
    assert torch.count_nonzero(t.grad[:, :-1]) == 0


@pytest.mark.parametrize("n", [500, 17000])
def test_take_rows_dense_grad_matches_jax_grad(n):
    """rows of shape (B, L) into x (n, 8): below and above SMALL_VOCAB_MAX
    rows, against jax.grad through take_rows_dense_grad, hi + lo bound."""
    rng = np.random.RandomState(n)
    D = 8
    x = rng.randn(n, D).astype(np.float32)
    rows = np.floor(n * rng.random_sample((12, 9)) ** 3.0).astype(np.int64)
    w = rng.randn(12, 9, D).astype(np.float32)
    jgrad = jax.grad(lambda t: jnp.sum(jax_eg.take_rows_dense_grad(
        n, t, jnp.asarray(rows, jnp.int32)) * jnp.asarray(w)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = port_eg.take_rows_dense_grad(n, t, torch.from_numpy(rows))
    np.testing.assert_array_equal(out.detach().numpy(), x[rows])
    (out * torch.from_numpy(w)).sum().backward()
    bound = _hi_lo_bound(rows.reshape(-1), w.reshape(-1, D), n)
    assert (np.abs(t.grad.numpy() - np.asarray(jgrad)) <= bound).all()


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(4096, 3707), (943, 1683), (37, 100)])
def test_masked_topk_kernel_matches_plain_on_card(cuda_device, B, N):
    """The CUDA kernel against the plain version at the main path's shapes:
    values at rtol 1e-5 (another fp32 sum order than cuBLAS), ids equal but
    where two scores lie within that tolerance."""
    q, items, mask = (torch.from_numpy(a).to(cuda_device)
                      for a in _topk_inputs(B, N, 64, seed=7, history=N // 20))
    k = 10
    before = port_topk.masked_topk_cuda.launches
    v, i = port_topk.masked_topk(q, items, mask, k)
    assert port_topk.masked_topk_cuda.launches == before + 1
    v_ref, i_ref = port_topk.masked_topk_torch(q, items, mask, k)
    torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
    scores = torch.where(mask > 0, torch.full((), -1e15, device=cuda_device), q @ items.T)
    differ = i != i_ref
    a = torch.gather(scores, 1, i.long())[differ]
    b = torch.gather(scores, 1, i_ref.long())[differ]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert not torch.gather(mask, 1, i.long()).any()


@pytest.mark.cuda
def test_masked_topk_kernel_ties_and_wide_k_on_card(cuda_device):
    q, items, mask = _topk_inputs(8, 300, 16, seed=5, history=0)
    items[40] = items[7]
    items[250] = items[7]
    for k in (1, 33, 100, 128):
        args = [torch.from_numpy(a).to(cuda_device) for a in (q, items, mask)]
        v, i = port_topk.masked_topk_cuda(*args, k)
        v_ref, i_ref = port_topk.masked_topk_torch(*args, k)
        torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
        assert torch.equal(i, i_ref)


def _topk_on_card(dev, q, items, mask, k, exact_ids=False):
    """The kernel against the plain version: values at rtol 1e-5 / atol
    1e-6, ids equal or (unless ``exact_ids``) near ties within that
    tolerance, no masked item where an unmasked one should be, ids below N,
    two runs bit-identical, one launch a call."""
    q, items, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (q, items, mask))
    before = port_topk.masked_topk_cuda.launches
    v, i = port_topk.masked_topk_cuda(q, items, mask, k)
    v2, i2 = port_topk.masked_topk_cuda(q, items, mask, k)
    torch.cuda.synchronize()
    assert port_topk.masked_topk_cuda.launches == before + 2
    assert torch.equal(v.view(torch.int32), v2.view(torch.int32)) and torch.equal(i, i2)
    v_ref, i_ref = port_topk.masked_topk_torch(q, items, mask, k)
    torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
    assert int(i.min()) >= 0 and int(i.max()) < items.shape[0]
    if exact_ids:
        assert torch.equal(i, i_ref)
    scores = torch.where(mask > 0, torch.full((), -1e15, device=dev), q @ items.T)
    differ = i != i_ref
    a = torch.gather(scores, 1, i.long())[differ]
    b = torch.gather(scores, 1, i_ref.long())[differ]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # masked items only where the plain version has them, by id, exactly
    masked = v_ref == -1e15
    assert torch.equal(torch.gather(mask, 1, i.long()) > 0, masked)
    assert torch.equal(i[masked], i_ref[masked])
    return v, i


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 20, 36, 128, 512])
def test_masked_topk_kernel_widths_on_card(cuda_device, D):
    """D 4 mod 8 (zero-padded k-steps), and D past one 64-float K chunk."""
    _topk_on_card(cuda_device, *_topk_inputs(300, 1683, D, seed=31, history=80), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [6, 10])
def test_masked_topk_dispatcher_pads_the_width_on_card(cuda_device, D):
    """A width the kernel refuses (not a multiple of 4) runs through the
    dispatcher, zero-padded: one launch, against the plain version at D."""
    q, items, mask = (torch.from_numpy(a).to(cuda_device)
                      for a in _topk_inputs(943, 1683, D, seed=34, history=60))
    with pytest.raises(ValueError, match="multiple of 4"):
        port_topk.masked_topk_cuda(q, items, mask, 10)
    before = port_topk.masked_topk_cuda.launches
    v, i = port_topk.masked_topk(q, items, mask, 10)
    assert port_topk.masked_topk_cuda.launches == before + 1
    v_ref, i_ref = port_topk.masked_topk_torch(q, items, mask, 10)
    torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
    scores = torch.where(mask > 0, torch.full((), -1e15, device=cuda_device), q @ items.T)
    differ = i != i_ref
    torch.testing.assert_close(torch.gather(scores, 1, i.long())[differ],
                               torch.gather(scores, 1, i_ref.long())[differ],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37])
def test_masked_topk_kernel_few_rows_on_card(cuda_device, B):
    """B below one row tile: the plan splits the items over many slices."""
    assert port_topk.masked_topk_plan(B, 3707, 64, 10).slices > 8
    _topk_on_card(cuda_device, *_topk_inputs(B, 3707, 64, seed=32, history=100), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.1])
@pytest.mark.parametrize("N", [10, 64, 65, 128])
def test_masked_topk_kernel_k_equals_n_on_card(cuda_device, N, scale):
    """k = N: every item comes out, the masked ones last by id, and with
    them the scores near 0, where the tolerance is its atol. At unit scale
    3xTF32's own sums miss that atol there (1.43e-6 against 1.4e-6 before
    the kernel took its outputs' values again in fp32); 0.1 is the
    embeddings' scale, as chip_smoke.topk_inputs draws them."""
    q, items, mask = _topk_inputs(70, N, 16, seed=33, history=N // 5)
    q, items = q * np.float32(scale), items * np.float32(scale)
    _, i = _topk_on_card(cuda_device, q, items, mask, N)
    assert torch.equal(i.sort(dim=1).values.cpu(),
                       torch.arange(N, dtype=torch.int32).expand(70, N))


@pytest.mark.cuda
def test_masked_topk_kernel_k128_over_short_slices_on_card(cuda_device):
    """k 128 over slices of 64-128 items: each slice's list ends in
    (-inf, INT_MAX) entries that must never come out."""
    q, items, mask = _topk_inputs(8, 300, 16, seed=34, history=20)
    plan = port_topk.masked_topk_plan(8, 300, 16, 128)
    assert plan.slices == 4 and min(hi - lo for lo, hi in plan.slice_items(300)) < 128
    _topk_on_card(cuda_device, q, items, mask, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50, 128])
def test_masked_topk_kernel_rows_short_of_unmasked_items_on_card(cuda_device, k):
    """Rows with fewer unmasked items than k, and a row masked throughout:
    the masked items fill the rest at -1e15 in id order, as the plain
    version orders them."""
    q, items, mask = _topk_inputs(130, 700, 32, seed=35, history=0)
    mask[:64, :] = 1
    mask[:64, 3::97] = 0  # 8 unmasked a row
    mask[64, :] = 1
    mask[65:, 128:320] = 1
    _topk_on_card(cuda_device, q, items, mask, k)


@pytest.mark.cuda
def test_masked_topk_kernel_duplicates_across_slices_on_card(cuda_device):
    """Integer data (every score exact in fp32 and in 3xTF32) with exact
    duplicates either side of every slice boundary: ids exact."""
    rng = np.random.RandomState(36)
    B, N, D = 200, 1683, 64
    q = rng.randint(-3, 4, size=(B, D)).astype(np.float32)
    items = rng.randint(-3, 4, size=(N, D)).astype(np.float32)
    mask = np.zeros((B, N), np.int8)
    mask[:, 0] = 1
    plan = port_topk.masked_topk_plan(B, N, D, 10)
    assert plan.slices > 1
    best = int(np.argmax(q @ items.T, axis=1)[0])
    for lo, _ in plan.slice_items(N)[1:]:
        items[lo - 1] = items[best]
        items[lo] = items[best]
    for k in (10, 40):
        _topk_on_card(cuda_device, q, items, mask, k, exact_ids=True)


@pytest.mark.cuda
def test_masked_topk_kernel_unaligned_mask_on_card(cuda_device):
    """A mask whose rows start at every offset mod 16 and whose base is not
    16-byte aligned (a view one row in): the staged chunks are read within
    the tensor's bytes only."""
    q, items, mask = _topk_inputs(101, 1683, 64, seed=37, history=60)
    big = torch.from_numpy(mask).to(cuda_device)
    sub = big[1:]
    assert sub.data_ptr() % 16
    q_d = torch.from_numpy(q[1:].copy()).to(cuda_device)
    it_d = torch.from_numpy(items).to(cuda_device)
    v, i = port_topk.masked_topk_cuda(q_d, it_d, sub, 10)
    v_ref, i_ref = port_topk.masked_topk_torch(q_d, it_d, sub, 10)
    torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
    assert not torch.gather(sub, 1, i.long()).any()


@pytest.mark.cuda
def test_masked_topk_kernel_one_kernel_a_call_on_card(cuda_device):
    """At most 2 kernels (and no memset) a call, by the wrapper's count and
    by torch.profiler, at the main path's shapes."""
    from torch.profiler import ProfilerActivity, profile
    for B, N in ((4096, 3707), (1944, 3707), (943, 1683)):
        q, items, mask = (torch.from_numpy(a).to(cuda_device)
                          for a in _topk_inputs(B, N, 64, seed=38, history=N // 20))
        port_topk.masked_topk_cuda(q, items, mask, 10)
        torch.cuda.synchronize()
        before = port_topk.masked_topk_cuda.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                port_topk.masked_topk_cuda(q, items, mask, 10)
            torch.cuda.synchronize()
        assert port_topk.masked_topk_cuda.launches == before + 5
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        assert 0 < len(kernels) <= 10
        assert all("masked_topk" in e.name for e in kernels), {e.name for e in kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D", [(4096, 3707, 64), (943, 1683, 64), (37, 100, 8),
                                   (130, 2000, 24), (64, 700, 512)])
def test_masked_topk_bf16_kernel_matches_plain_on_card(cuda_device, B, N, D):
    """The bf16-operand instance (eval_score_dtype bfloat16) against the
    plain version on the same bf16 operands (widened to fp32, cuBLAS fp32
    product): values at rtol 1e-5 / atol 1e-6 (both sum exact products in
    fp32, in other orders), ids equal but where two scores lie within that;
    one launch a call, through the dispatcher too, and two runs the same
    bits."""
    q, items, mask = (torch.from_numpy(a).to(cuda_device)
                      for a in _topk_inputs(B, N, D, seed=8, history=N // 20))
    q, items = q.to(torch.bfloat16), items.to(torch.bfloat16)
    k = 10
    before = port_topk.masked_topk_cuda.launches
    v, i = port_topk.masked_topk(q, items, mask, k)
    v2, i2 = port_topk.masked_topk_cuda(q, items, mask, k)
    assert port_topk.masked_topk_cuda.launches == before + 2
    assert v.dtype == torch.float32 and torch.equal(v, v2) and torch.equal(i, i2)
    v_ref, i_ref = port_topk.masked_topk_torch(q, items, mask, k)
    torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
    scores = torch.where(mask > 0, torch.full((), -1e15, device=cuda_device),
                         q.float() @ items.float().T)
    differ = i != i_ref
    torch.testing.assert_close(torch.gather(scores, 1, i.long())[differ],
                               torch.gather(scores, 1, i_ref.long())[differ],
                               rtol=1e-5, atol=1e-6)
    assert not torch.gather(mask, 1, i.long()).any()


@pytest.mark.cuda
def test_masked_topk_bf16_dispatcher_pads_to_a_multiple_of_8_on_card(cuda_device):
    """bf16 widths the kernel refuses (not a multiple of 8) are zero-padded
    by the dispatcher: the plain version's ids and values."""
    for D in (4, 20, 61):
        q, items, mask = (torch.from_numpy(a).to(cuda_device)
                          for a in _topk_inputs(300, 900, D, seed=D, history=30))
        q, items = q.to(torch.bfloat16), items.to(torch.bfloat16)
        v, i = port_topk.masked_topk(q, items, mask, 10)
        v_ref, _ = port_topk.masked_topk_torch(q, items, mask, 10)
        torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError, match="multiple of 8"):
            port_topk.masked_topk_cuda(q, items, mask, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("clip,dwd,wd", [("below", 0.0, 0.0), ("above", 0.0, 0.0),
                                         ("off", 1e-4, 0.0), ("below", 1e-4, 1e-2)])
def test_adam_multi_kernel_clip_and_adamw_bits_on_card(cuda_device, clip, dwd, wd):
    """The clip scale (the norm read from the device) and adamw's decoupled
    term in the kernel against the plain version, bit for bit, over three
    steps of SASRec's 36 leaves (its [PAD] row a zero head), max_norm 10x
    below every step's norm (every gradient scaled) or 10x above (none);
    the launcher takes the norm itself, two launches of the norm kernels."""
    shapes, heads = ADAM_SETS["sasrec"]
    rng = np.random.RandomState(41)
    p0 = [np.asarray(rng.randn(*s) * 0.1, np.float32) for s in shapes]
    for a, h in zip(p0, heads):
        a.reshape(-1)[:h] = 0.0
    grads = [[torch.from_numpy(np.asarray(rng.randn(*s) * 1e-3, np.float32)).to(cuda_device)
              for s in shapes] for _ in range(3)]
    norms = [float(fused_adam.global_grad_norm(g, heads)) for g in grads]
    max_norm = {"below": 0.1 * min(norms), "above": 10.0 * max(norms), "off": None}[clip]
    out = {}
    for name, fn in (("kernel", fused_adam.adam_multi_cuda),
                     ("plain", fused_adam.adam_multi_torch)):
        leaves = fused_adam.AdamLeaves([torch.from_numpy(a.copy()).to(cuda_device) for a in p0],
                                       [torch.zeros(s, device=cuda_device) for s in shapes],
                                       [torch.zeros(s, device=cuda_device) for s in shapes],
                                       heads)
        for t, g in enumerate(grads, start=1):
            # the trainer's route: the launcher takes the norm with the norm
            # kernels itself; the plain version is handed theirs
            cl = None
            if max_norm is not None:
                cl = (None if name == "kernel" else fused_adam.grad_norm_cuda(leaves, g),
                      max_norm)
            before = fused_adam.grad_norm_cuda.launches
            fn(leaves, g, 1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t), b1=B1, b2=B2, lr=LR,
               eps=EPS, wd=wd, clip=cl, dwd=dwd)
            assert fused_adam.grad_norm_cuda.launches == before + 2 * (
                name == "kernel" and max_norm is not None)
        torch.cuda.synchronize()
        out[name] = leaves
    for i in range(len(shapes)):
        for a, b in ((out["kernel"].p[i], out["plain"].p[i]),
                     (out["kernel"].m[i], out["plain"].m[i]),
                     (out["kernel"].v[i], out["plain"].v[i])):
            assert torch.equal(a, b), (i, float((a - b).abs().max()))
    assert not out["kernel"].p[0][0].any() and not out["kernel"].m[0][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_set", ["sasrec", "edge", "many"])
def test_grad_norm_kernels_match_the_plain_norm_on_card(cuda_device, leaf_set):
    """The clip's norm by the two norm kernels against global_grad_norm at
    rtol 1e-5 (another order of the fp32 sums): SASRec's 36 leaves (its
    [PAD] row a zero head), odd leaves with zero heads, a missing gradient
    and an empty leaf, and 600 leaves (two launches of partial sums); the
    same bits twice; None when no gradient is present."""
    if leaf_set == "sasrec":
        shapes, heads = ADAM_SETS["sasrec"]
    elif leaf_set == "edge":
        shapes, heads = [(2053,), (3, 7), (), (4096,), (2047,), (37, 9), (0,)], [6, 0, 0, 2, 0,
                                                                                  9, 0]
    else:
        shapes, heads = [(int(n),) for n in np.arange(600) % 97 + 1], [1] * 600
    rng = np.random.RandomState(7)
    grads = [None if (leaf_set == "edge" and i == 1) else
             torch.from_numpy(np.asarray(rng.randn(*s), np.float32)).to(cuda_device)
             for i, s in enumerate(shapes)]
    leaves = fused_adam.AdamLeaves([torch.zeros(s, device=cuda_device) for s in shapes],
                                   [torch.zeros(s, device=cuda_device) for s in shapes],
                                   [torch.zeros(s, device=cuda_device) for s in shapes], heads)
    before = fused_adam.grad_norm_cuda.launches
    got = fused_adam.grad_norm_cuda(leaves, grads)
    groups = 1 + len(shapes) // fused_adam.MAX_LEAVES
    assert fused_adam.grad_norm_cuda.launches == before + groups + 1
    ref = fused_adam.global_grad_norm(grads, heads)
    assert got.dtype == torch.float32 and got.dim() == 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    assert torch.equal(got, fused_adam.grad_norm_cuda(leaves, grads))
    assert fused_adam.grad_norm_cuda(leaves, [None] * len(shapes)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6041, 64), (3707, 64)])
def test_adam_kernel_matches_plain_on_card(cuda_device, shape):
    """Three steps of the kernel through the one-leaf dispatcher against the
    plain version: rtol 1e-6 of each element plus 1e-6 of the tensor's
    largest magnitude, the tolerance of every Adam test here."""
    p, m, v, _ = _adam_inputs(shape, seed=3)
    grads = [_adam_inputs(shape, seed=10 + t)[3] for t in range(3)]
    out = {}
    for name, fn in (("kernel", fused_adam.adam_leaf), ("plain", fused_adam.adam_leaf_torch)):
        tp, tm, tv = (torch.from_numpy(a.copy()).to(cuda_device) for a in (p, m, v))
        for t, g in enumerate(grads, start=1):
            fn(tp, tm, tv, torch.from_numpy(g).to(cuda_device),
               1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t), b1=B1, b2=B2, lr=LR, eps=EPS)
        out[name] = (tp, tm, tv)
    for a, b in zip(out["kernel"], out["plain"]):
        assert bool(((a - b).abs() <= 1e-6 * (b.abs() + b.abs().max())).all())


# the leaf sets Adam sweeps in a step at the main paths' shapes: BPR's two
# tables (ml-1m), DeepFM-Criteo's merged table and eleven small leaves (the
# 0-d first_order_bias, the (1,) output bias), SASRec's 36 (ml-1m, 2 layers
# at hidden 64, inner 256; item_embedding's [PAD] row is its zero head) and
# LightGCN's two tables (the Yelp shape)
_SASREC_LAYER = [(64, 64)] * 4 + [(64,)] * 8 + [(64, 256), (256,), (256, 64), (64,)]
ADAM_SETS = {
    "bpr": ([(6041, 64), (3707, 64)], [0, 0]),
    "deepfm_criteo": ([(2565692, 11), (13, 10), (13,), (), (390, 128), (128,), (128, 128),
                       (128,), (128, 128), (128,), (128, 1), (1,)], [0] * 12),
    "sasrec": ([(3707, 64), (50, 64), (64,), (64,)] + _SASREC_LAYER * 2, [64] + [0] * 35),
    "lightgcn": ([(102047, 64), (98409, 64)], [0, 0]),
}


def _adam_multi_on_card(dev, shapes, heads, seed, steps=3, none=(), offset=0, g_offset=None):
    """``steps`` steps of the kernel and of the plain version from the same
    leaves; ``none``: leaves without a gradient; ``offset``: every p, m and
    v a view that many elements into its buffer; ``g_offset`` (default
    ``offset``): the same for every g. Asserts one launch a step (a launch
    per MAX_LEAVES leaves) and the file's tolerance."""
    rng = np.random.RandomState(seed)
    p0 = [np.asarray(rng.randn(*s) * 0.1, np.float32) for s in shapes]
    grads = [[None if i in none else np.asarray(rng.randn(*s) * 1e-3, np.float32)
              for i, s in enumerate(shapes)] for _ in range(steps)]

    def on_card(a, at=offset):
        buf = torch.empty(at + a.size, device=dev)
        buf[at:] = torch.from_numpy(a.reshape(-1)).to(dev)
        return buf[at:].view(a.shape)

    g_at = offset if g_offset is None else g_offset
    out = {}
    for name, fn in (("kernel", fused_adam.adam_multi), ("plain", fused_adam.adam_multi_torch)):
        leaves = fused_adam.AdamLeaves([on_card(a) for a in p0],
                                       [on_card(np.zeros_like(a)) for a in p0],
                                       [on_card(np.zeros_like(a)) for a in p0], heads)
        before = fused_adam.adam_multi_cuda.launches
        for t, g in enumerate(grads, start=1):
            fn(leaves, [None if a is None else on_card(a, g_at) for a in g],
               1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t), b1=B1, b2=B2, lr=LR, eps=EPS)
        if name == "kernel":
            per_step = -(-sum(1 for s in shapes if np.prod(s, dtype=np.int64) > 0)
                         // fused_adam.MAX_LEAVES)
            assert fused_adam.adam_multi_cuda.launches - before == steps * per_step
        torch.cuda.synchronize()
        out[name] = leaves
    for i in range(len(shapes)):
        for a, b in ((out["kernel"].p[i], out["plain"].p[i]),
                     (out["kernel"].m[i], out["plain"].m[i]),
                     (out["kernel"].v[i], out["plain"].v[i])):
            if b.numel():
                assert bool(((a - b).abs() <= 1e-6 * (b.abs() + b.abs().max())).all()), i
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_set", list(ADAM_SETS))
def test_adam_multi_kernel_matches_plain_on_leaf_sets_on_card(cuda_device, leaf_set):
    """Every leaf of a main path's step in one launch a step, three steps,
    against adam_multi_torch; SASRec's [PAD] row stays as it was."""
    shapes, heads = ADAM_SETS[leaf_set]
    out = _adam_multi_on_card(cuda_device, shapes, heads, seed=31)
    if leaf_set == "sasrec":
        assert not out["kernel"].m[0][0].any() and not out["kernel"].v[0][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_adam_multi_kernel_unaligned_views_and_no_gradient_on_card(cuda_device, offset):
    """Leaves that start 1-3 elements into their buffers (not 16-byte
    aligned: the element path), aligned p, m and v whose gradients alone
    start there (the kernel's own check of g sends them to the element
    path), a leaf without a gradient, a 0-d leaf, a head that ends inside a
    16-byte group, and lengths around the chunk."""
    C = fused_adam.CHUNK
    shapes = [(C + 5,), (3, 7), (), (C * 2,), (C - 1,), (37, 9)]
    _adam_multi_on_card(cuda_device, shapes, [6, 0, 0, 2, 0, 9], seed=32, none=(1,),
                        offset=offset)
    _adam_multi_on_card(cuda_device, shapes, [6, 0, 0, 2, 0, 9], seed=36, none=(1,),
                        g_offset=offset)
    _adam_multi_on_card(cuda_device, shapes, [6, 0, 0, 2, 0, 9], seed=33, none=(1,))


@pytest.mark.cuda
def test_adam_multi_kernel_more_leaves_than_a_launch_holds_on_card(cuda_device):
    """MAX_LEAVES + 90 leaves, among them empty ones: two launches a step."""
    rng = np.random.RandomState(34)
    shapes = [tuple(int(d) for d in rng.randint(0, 40, rng.randint(1, 3)))
              for _ in range(fused_adam.MAX_LEAVES + 90)]
    shapes[5] = (3 * fused_adam.CHUNK + 7,)
    _adam_multi_on_card(cuda_device, shapes, [0] * len(shapes), seed=35)


def _make_synth(tmp_path):
    """The synthetic dataset under tmp_path / "data" / "synth", its module
    loaded by path: on some machines another ``tests`` package shadows this
    one."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "synth_data", os.path.join(os.path.dirname(__file__), "synth_data.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    synth.make_synthetic_dataset(str(tmp_path / "data"), name="synth")


def _adam_resume_case(dev, tmp_path):
    """A BPR trainer: two steps, a checkpoint, two more steps; a second
    trainer takes a step on its own fresh moments, resumes the checkpoint
    and takes the same two steps. Adam must update the resumed moments (the
    trainer builds its leaves again): they move off the checkpoint's values,
    and both trainers end on the same parameters and moments, one Adam
    launch a step. Bit for bit on the CPU; on the card the embedding
    gradients' sums may land in another order from run to run, so the
    moments agree within 1e-5 of their largest value, and the parameters
    within 4 lr (an element whose gradient is a cancelling sum may step
    either way) and, for 99% of each leaf, within 1e-5 of their value."""
    import os
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import Trainer
    _make_synth(tmp_path)
    cfg = {"data_path": str(tmp_path / "data"), "train_batch_size": 256,
           "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
           "state": "ERROR", "valid_full_to_uni1000": False, "device": dev.type}
    config = Config("BPR", "synth", config_dict=cfg, _parse_cmd_line=False)
    train = data_preparation(config, create_dataset(config))[0]
    rng = np.random.RandomState(0)
    batches = [{k: torch.from_numpy(rng.randint(1, hi, 256)).to(dev)
                for k, hi in (("user_id", 60), ("item_id", 80), ("neg_item_id", 80))}
               for _ in range(4)]

    def trainer():
        model = get_model("BPR")(config, train.dataset)
        tr = Trainer(config, model)
        tr.opt_state = tr._fused_adam_init()
        return tr, tr._make_step_core(lambda b, gen, consts: b, model.calculate_loss)

    first, step = trainer()
    for b in batches[:2]:
        step(b, {})
    os.makedirs(first.checkpoint_dir, exist_ok=True)
    first._save_checkpoint(0)
    saved_mu = {n: t.clone() for n, t in first.opt_state["mu"].items()}
    for b in batches[2:]:
        step(b, {})
    second, step2 = trainer()
    step2(batches[0], {})
    stale = second._step_leaves()
    second.resume_checkpoint(first.saved_model_file)
    before = fused_adam.adam_multi_cuda.launches
    for b in batches[2:]:
        step2(b, {})
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert fused_adam.adam_multi_cuda.launches == before + 2
    assert second._step_leaves() is not stale
    assert second.opt_state["count"] == first.opt_state["count"] == 4
    params2 = dict(second.model.named_parameters())
    for n, p in first.model.named_parameters():
        assert not torch.equal(second.opt_state["mu"][n], saved_mu[n]), n
        pairs = ((p.detach(), params2[n].detach()),
                 (first.opt_state["mu"][n], second.opt_state["mu"][n]),
                 (first.opt_state["nu"][n], second.opt_state["nu"][n]))
        if dev.type == "cpu":
            assert all(torch.equal(a, b) for a, b in pairs), n
            continue
        (pa, pb), *moments = pairs
        for a, b in moments:
            assert bool(((a - b).abs() <= 1e-5 * b.abs().max()).all()), n
        diff = (pa - pb).abs()
        assert float(diff.max()) <= 4 * config["learning_rate"], n
        assert float((diff <= 1e-5 * pb.abs()).float().mean()) >= 0.99, n


@pytest.mark.cuda
def test_adam_after_resume_checkpoint_updates_the_resumed_state_on_card(cuda_device, tmp_path):
    _adam_resume_case(cuda_device, tmp_path)


# cotangents are summed in fp32 in the order of r by the kernels and in any
# order by index_add_: |diff| <= 1e-5 * sum|g| + 1e-7 elementwise
def _grad_close(out, ref, ids, g, V):
    bound = 1e-5 * _abs_sums(ids, g, V) + 1e-7
    return bool((np.abs(out.cpu().numpy() - ref.cpu().numpy()) <= bound).all())


def _onehot_agrees_on_card(tid, tg, V, ids, g, id_base=0):
    """One call of the one-hot path against the plain version, within the
    file's bound, and a second call bit for bit."""
    before = port_eg.onehot_matmul_grad_cuda.launches
    out = port_eg.onehot_matmul_grad(tid, tg, V, id_base=id_base)
    assert port_eg.onehot_matmul_grad_cuda.launches == before + 1
    torch.cuda.synchronize()
    ref = port_eg.onehot_matmul_grad_torch(tid, tg, V, id_base=id_base)
    keep = (ids >= id_base) & (ids < id_base + V)
    assert _grad_close(out, ref, ids[keep] - id_base,
                       tg.float().cpu().numpy().reshape(-1, g.shape[-1])[keep], V)
    assert torch.equal(out, port_eg.onehot_matmul_grad(tid, tg, V, id_base=id_base))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,D", [(34816, 35692, 11), (2048 * 8, 2700, 11), (5000, 900, 1),
                                   (1, 17, 11), (0, 9, 4), (3000, 700, 64),
                                   (102400, 3707, 64)])
def test_onehot_grad_kernel_matches_plain_on_card(cuda_device, R, V, D):
    """Cubic skew, every id on one row, a bf16 cotangent: R = 0 and 1, D 1,
    11 and 64, the Criteo small fields' and the sequential step's shapes."""
    ids, g = _grad_inputs(R, V, D, seed=R + D)
    tid, tg = torch.from_numpy(ids).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    _onehot_agrees_on_card(tid, tg, V, ids, g)
    _onehot_agrees_on_card(torch.zeros_like(tid), tg, V, np.zeros_like(ids), g)
    _onehot_agrees_on_card(tid, tg.to(torch.bfloat16), V, ids, g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["62-row field", "one row, many pieces", "one row, D=1",
                                  "ids outside the range", "[PAD] tile"])
def test_onehot_grad_kernel_hot_rows_on_card(cuda_device, case):
    """The hot rows the bucketing splits: a 62-row field at cubic skew; R
    far above a piece's 1,024 entries on one row (D 11 and 1); ids below and
    above [id_base, id_base + V); the sequential step's [PAD] row at 40%."""
    rng = np.random.RandomState(len(case))
    D = 1 if case.endswith("D=1") else 11
    id_base = 0
    if case == "62-row field":
        R, V = 2048, 62
        ids = 1 + np.floor(60 * rng.random_sample(R) ** 3.0).astype(np.int64)
    elif case.startswith("one row"):
        R, V = 50000, 700
        ids = np.full(R, 5, np.int64)
    elif case == "ids outside the range":
        R, V, id_base = 20000, 300, 1000
        ids = id_base - 50 + rng.randint(0, V + 100, R).astype(np.int64)
    else:
        R, V, D = 102400, 3707, 64
        ids = 1 + np.floor((V - 1) * rng.random_sample(R) ** 2.2).astype(np.int64)
        ids[rng.random_sample(R) < 0.4] = 0
    g = rng.randn(R, D).astype(np.float32) * 1e-2
    tid, tg = torch.from_numpy(ids).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    out = _onehot_agrees_on_card(tid, tg, V, ids, g, id_base)
    hit = np.zeros(V, bool)
    hit[ids[(ids >= id_base) & (ids < id_base + V)] - id_base] = True
    assert not torch.count_nonzero(out[torch.from_numpy(~hit).to(cuda_device)])


@pytest.mark.cuda
def test_onehot_grad_kernel_row_limit_on_card(cuda_device):
    """The library's row limit is the one field_runs keeps to; past it the
    launcher raises and launches nothing."""
    assert port_eg._lib().embed_grad_onehot_max_rows() == port_eg.ONEHOT_MAX_ROWS
    tid = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    tg = torch.ones(4, 3, device=cuda_device)
    before = port_eg.onehot_matmul_grad_cuda.launches
    with pytest.raises(ValueError, match="n_rows"):
        port_eg.onehot_matmul_grad_cuda(tid, tg, port_eg.ONEHOT_MAX_ROWS + 1)
    assert port_eg.onehot_matmul_grad_cuda.launches == before
    out = port_eg.onehot_matmul_grad_cuda(tid, tg, port_eg.ONEHOT_MAX_ROWS)
    assert out[0].tolist() == [4.0, 4.0, 4.0] and torch.count_nonzero(out) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,D", [(18432, 2530000, 11), (4000, 70000, 1), (1, 17, 11),
                                   (0, 9, 4), (3000, 20000, 64)])
def test_windowed_grad_kernel_matches_plain_on_card(cuda_device, R, V, D):
    ids, g = _grad_inputs(R, V, D, seed=R + D)
    tid, tg = torch.from_numpy(ids).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    before = port_eg.windowed_grad_cuda.launches
    out = port_eg.windowed_grad(tid, tg, V)
    assert port_eg.windowed_grad_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert _grad_close(out, port_eg.windowed_grad_torch(tid, tg, V), ids, g, V)
    assert torch.equal(out, port_eg.windowed_grad(tid, tg, V))   # deterministic
    same = torch.full_like(tid, V - 1)
    assert _grad_close(port_eg.windowed_grad(same, tg, V),
                       port_eg.windowed_grad_torch(same, tg, V),
                       np.full_like(ids, V - 1), g, V)


def _windowed_agrees_on_card(tid, tg, V, id_base=0, out=None):
    """One call of the windowed path against the plain version, within the
    file's bound over the ids in range, and a second call bit for bit."""
    ids = tid.reshape(-1).cpu().numpy()
    g = tg.float().reshape(ids.size, tg.shape[-1]).cpu().numpy()
    before = port_eg.windowed_grad_cuda.launches
    got = port_eg.windowed_grad(tid, tg, V, out=out, id_base=id_base)
    assert port_eg.windowed_grad_cuda.launches == before + 1
    torch.cuda.synchronize()
    ref = port_eg.windowed_grad_torch(tid, tg, V, id_base=id_base)
    keep = (ids >= id_base) & (ids < id_base + V)
    assert _grad_close(got, ref, ids[keep] - id_base, g[keep], V)
    assert torch.equal(got, port_eg.windowed_grad(tid, tg, V, id_base=id_base))
    return got


def _hot_window_ids(rng, R, V):
    """R ids of V rows (windows of 64 rows at V 98,409): a quarter of them
    in window 3, half of those on row 200, then windows 10-16 holding 5, 17,
    20, 32, 33, 60 and 100 ids, on both sides of a warp's 32 and of the
    piece size (54 entries at D 300, 16 at D 1024, 4 at D 4096), the rest
    skewed over rows from 2,048 on."""
    ids = 2048 + np.floor((V - 2048) * rng.random_sample(R) ** 2.2).astype(np.int64)
    hot = R // 4
    ids[:hot] = 192 + rng.randint(0, 64, hot)
    ids[:hot // 2] = 200
    at = hot
    for w, n in zip(range(10, 17), (5, 17, 20, 32, 33, 60, 100)):
        ids[at:at + n] = 64 * w + rng.randint(0, 64, n)
        at += n
    return rng.permutation(ids)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["every id equal", "one window, many pieces",
                                  "ids outside the range, into a row range", "R=0", "R=1",
                                  "D=1", "D=64", "bf16 cotangent", "n_rows not a window multiple",
                                  "10M rows", "column block in place", "D=300, a hot window",
                                  "D=1024, a hot window", "D=4096, a hot window"])
def test_windowed_grad_kernel_cases_on_card(cuda_device, case):
    """The cases the bucketing by window has to get right, each against the
    plain version and rerun bit for bit: a hot row and a hot window (cut
    into many pieces whose partials are added in piece order), ids dropped
    below and past a nonzero id_base while writing a row range of a larger
    table, R = 0 and 1, D 1, 11 and 64, a bf16 cotangent, a table that ends
    inside a window, 10,000,000 rows at D 11 (windows of 8,192 rows), a
    (B, fs) column block that gives the bits of its contiguous copy, and
    rows wider than a block's 256 threads (D 300, 1024, 4096: several column
    slabs, pieces of fewer than 32 entries) with a hot window and windows
    on both sides of a warp's and a piece's size."""
    rng = np.random.RandomState(len(case))
    R, V, D, id_base = 18432, 2530000, 11, 0
    ids = np.floor(V * rng.random_sample(R) ** 3.0).astype(np.int64)
    if case == "every id equal":
        ids[:] = 1234567
    elif case == "one window, many pieces":
        # 1,000,000 rows are windows of 512 rows: 18,432 ids in window 2
        V = 1_000_000
        ids = 1024 + np.floor(512 * rng.random_sample(R) ** 2.0).astype(np.int64)
    elif case.startswith("ids outside"):
        R, V, id_base = 20000, 70000, 50000
        ids = id_base - 1000 + rng.randint(0, V + 2000, R).astype(np.int64)
    elif case.startswith("R="):
        R = int(case[2:])
        ids = ids[:R]
    elif case.endswith("a hot window"):
        D = int(case[2:case.index(",")])
        R, V = {300: 4096, 1024: 2048, 4096: 1024}[D], 98409
        ids = _hot_window_ids(rng, R, V)
    elif case.startswith("D="):
        R, V, D = 4096, 98409, int(case[2:])
        ids = np.floor(V * rng.random_sample(R) ** 2.2).astype(np.int64)
    elif case == "n_rows not a window multiple":
        V = 100_003
        ids = V - 1 - np.floor(V * rng.random_sample(R) ** 3.0).astype(np.int64)
    elif case == "10M rows":
        V = 10_000_000
        ids = np.floor(V * rng.random_sample(R) ** 3.0).astype(np.int64)
    g = (rng.randn(R, D) * 1e-2).astype(np.float32)
    tid, tg = torch.from_numpy(ids).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    if case == "bf16 cotangent":
        tg = tg.to(torch.bfloat16)
    if case.startswith("ids outside"):
        table = torch.full((id_base + V + 30000, D), -1.0, device=cuda_device)
        out = _windowed_agrees_on_card(tid, tg, V, id_base, out=table[id_base:id_base + V])
        assert bool((table[:id_base] == -1).all()) and bool((table[id_base + V:] == -1).all())
        hit = np.zeros(V, bool)
        hit[ids[(ids >= id_base) & (ids < id_base + V)] - id_base] = True
        assert not torch.count_nonzero(out[torch.from_numpy(~hit).to(cuda_device)])
    elif case == "column block in place":
        block_ids, block_g = tid.reshape(-1, 9)[:, 2:7], tg.reshape(-1, 9, D)[:, 2:7]
        got = _windowed_agrees_on_card(block_ids, block_g, V)
        flat = port_eg.windowed_grad(block_ids.reshape(-1).contiguous(),
                                     block_g.reshape(-1, D).contiguous(), V)
        assert torch.equal(got, flat)
    else:
        _windowed_agrees_on_card(tid, tg, V)


@pytest.mark.cuda
def test_windowed_grad_kernel_shared_memory_sizes_in_turn_on_card(cuda_device):
    """Shapes whose scan and piece kernels take more than 48 KB of shared
    memory, a larger size, then a smaller one, then the larger again (the
    launcher keeps each kernel's limit at the most it has been asked for):
    each call agrees with the plain version and reruns bit for bit."""
    rng = np.random.RandomState(23)
    for R, V, D in ((18432, 2530000, 11), (20000, 70000, 11), (18432, 2530000, 11),
                    (4096, 98409, 64), (4096, 98409, 300), (4096, 98409, 64)):
        ids = np.floor(V * rng.random_sample(R) ** 2.2).astype(np.int64)
        g = (rng.randn(R, D) * 1e-2).astype(np.float32)
        _windowed_agrees_on_card(torch.from_numpy(ids).to(cuda_device),
                                 torch.from_numpy(g).to(cuda_device), V)


@pytest.mark.cuda
def test_embed_grad_launchers_refuse_int32_ids_on_card(cuda_device):
    """The kernels take int64 ids, as the trainer uploads them; int32 ids
    raise and launch nothing."""
    ids, g = _grad_inputs(8, 5, 3, seed=0)
    tid = torch.from_numpy(ids).to(cuda_device).to(torch.int32)
    tg = torch.from_numpy(g).to(cuda_device)
    for fn in (port_eg.onehot_matmul_grad_cuda, port_eg.windowed_grad_cuda):
        before = fn.launches
        with pytest.raises(TypeError, match="int64"):
            fn(tid, tg, 5)
        assert fn.launches == before


@pytest.mark.cuda
def test_grouped_take_rows_kernels_match_plain_on_card(cuda_device):
    """The (B, fs) column blocks read in place, each run writing its own row
    range: the CUDA backward against the same Function on the CPU."""
    spec, V, ids, table, w = _field_case(9, 11)
    grads = {}
    for dev in ("cpu", cuda_device):
        t = torch.from_numpy(table).to(dev).requires_grad_()
        rows = port_eg.grouped_take_rows(spec, t, torch.from_numpy(ids).to(dev))
        (rows * torch.from_numpy(w).to(dev)).sum().backward()
        grads[str(dev)] = t.grad.cpu()
    bound = 1e-5 * _abs_sums(ids.reshape(-1), w.reshape(-1, 11), V) + 1e-7
    assert (np.abs(grads["cpu"].numpy() - grads[str(cuda_device)].numpy()) <= bound).all()


@pytest.mark.cuda
def test_onehot_grad_kernel_column_ranges_on_card(cuda_device):
    """A (B, fs) column block read in place gives the same bits as its
    contiguous (R,) / (R, D) copy, whatever the block's columns and offset,
    and agrees with the plain version."""
    spec, V, ids, table, w = _field_case(4, 11)
    tid = torch.from_numpy(ids).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device)
    for f0, f1 in ((0, 2), (3, 4), (0, 4)):
        off, rows = spec[f0][0], sum(v for _, v in spec[f0:f1])
        block = port_eg.onehot_matmul_grad(tid[:, f0:f1], tw[:, f0:f1], rows, id_base=off)
        flat = port_eg.onehot_matmul_grad(tid[:, f0:f1].reshape(-1).contiguous(),
                                          tw[:, f0:f1].reshape(-1, w.shape[-1]).contiguous(),
                                          rows, id_base=off)
        assert torch.equal(block, flat)
        ref = port_eg.onehot_matmul_grad_torch(tid[:, f0:f1], tw[:, f0:f1], rows, id_base=off)
        # on the card the plain version is index_add_, whose atomics add in
        # an order that changes from run to run: the magnitude-relative
        # bound of the other one-hot tests
        assert _grad_close(block, ref, ids[:, f0:f1].reshape(-1) - off,
                           w[:, f0:f1].reshape(-1, w.shape[-1]), rows)


# ------------------------------------------- the whole-layer transformer kernels

def _trm_inputs(B, L, D, I, seed, device, empty_row=False):
    rng = np.random.RandomState(seed)
    params = {}
    for k, shape in port_trm.param_shapes(D, I).items():
        if len(shape) == 2:
            v = rng.uniform(-1, 1, shape) * np.sqrt(6.0 / sum(shape))
        else:
            v = 0.1 * rng.randn(*shape) + (1.0 if k.endswith("_g") else 0.0)
        params[k] = torch.from_numpy(v.astype(np.float32)).to(device)
    lens = rng.randint(1, L + 1, B)
    if empty_row:
        lens[0] = 0
    valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    x = torch.from_numpy((0.5 * rng.randn(B, L, D)).astype(np.float32)).to(device)
    dy = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).to(device)
    return x, params, torch.from_numpy(valid).to(device), dy


def test_trm_layer_launchers_refuse_cpu_tensors_and_dispatch_stays_plain():
    x, params, valid, dy = _trm_inputs(2, 8, 16, 32, 0, "cpu")
    kw = dict(n_heads=2, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        port_trm.trm_layer_fwd_cuda(x, params, valid, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        port_trm.trm_layer_bwd_cuda(x, params, valid, dy, **kw)
    before = (port_trm.trm_layer_fwd_cuda.launches, port_trm.trm_layer_bwd_cuda.launches)
    x.requires_grad_(True)
    (port_trm.trm_layer(x, params, valid, **kw) * dy).sum().backward()
    assert (port_trm.trm_layer_fwd_cuda.launches,
            port_trm.trm_layer_bwd_cuda.launches) == before
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _routed_shapes():
    """Every (L, D, I) the route sends to the whole-layer kernel over D from
    4 to 256 and wide ones to 6,400, inner sizes below, at and past one FFN
    chunk of either instance, every L up to the last that the route takes."""
    for D in list(range(4, 260, 4)) + [384, 512, 1024, 4096, 6400]:
        for I in (4, 32, 36, 60, 64, 68, 124, 128, 256, 260):
            for L in range(1, 400):
                if port_trm.layer_route(L, D, I) != "layer":
                    break
                yield L, D, I


def test_trm_layer_bf16_working_set_fits_wherever_the_route_takes_the_kernel():
    """The route to the whole-layer kernel is decided by one rule for both
    instances (``route_floats``, the working set of the fp32 instance's
    former FMA kernels); the bf16 instance's working set
    (``smem_bytes_bf16``, a copy of the library's formula) fits a Hopper
    block, forward and backward, at every shape the route sends to the
    kernel, and those L stay within the kernels' row passes."""
    taken = 0
    for L, D, I in _routed_shapes():
        taken += 1
        assert L <= port_trm.MAX_LEN, (L, D, I)
        for backward in (False, True):
            need = port_trm.smem_bytes_bf16(L, D, I, backward)
            assert need <= port_trm.MAX_SMEM_BYTES, (L, D, I, backward, need)
    assert taken > 10000
    # SASRec's shape: the working sets the library reports on the card
    assert port_trm.smem_bytes_bf16(50, 64, 256, True) == 105312
    assert port_trm.smem_bytes_bf16(50, 64, 256, False) == 83088
    assert port_trm.layer_route(57, 64, 256) == "layer" != port_trm.layer_route(58, 64, 256)


def test_trm_layer_fp32_working_set_fits_wherever_the_route_takes_the_kernel():
    """The fp32 instance's working set (``smem_bytes_fp32``, a copy of the
    library's ``tc_layout_f32``: fp32 copies, every buffer in the room of
    those dead in its phase) fits a Hopper block, forward and backward, at
    every shape the route sends to the kernel: the rule the route kept from
    the FMA kernels admits nothing the 3xTF32 kernels refuse. At SASRec's
    shape a forward and a backward block each leave room for a second on
    the SM (233,472 bytes an SM, 1,024 of them reserved a block)."""
    taken, largest = 0, 0
    for L, D, I in _routed_shapes():
        taken += 1
        assert L <= port_trm.MAX_LEN, (L, D, I)
        for backward in (False, True):
            need = port_trm.smem_bytes_fp32(L, D, I, backward)
            assert need <= port_trm.MAX_SMEM_BYTES, (L, D, I, backward, need)
            largest = max(largest, need)
    assert taken > 10000 and largest > 0.85 * port_trm.MAX_SMEM_BYTES
    assert port_trm.smem_bytes_fp32(50, 64, 256, True) == 114112
    assert port_trm.smem_bytes_fp32(50, 64, 256, False) == 74288
    assert 2 * (114112 + 1024) <= 233472
    # the route's rule is the FMA kernels' backward working set: 198,200
    # bytes at SASRec's shape
    assert 4 * port_trm.route_floats(50, 64, 256) == 198200


# (B, L, D, H, I): SASRec's widths at a ragged B, and shapes at the tile edges
# of both instances' products (16-row tiles, 8-column strips, k-steps 16
# deep in bf16 and 8 in tf32, FFN chunks of 64 and 128): one position, 7, 13,
# 16, 33, 57; D 16, 20, 24, 32, 64 with 1, 2, 4 and 5 heads (heads 4 and 12
# wide: K past a tf32 k-step's end; D 20 a row of 24 floats, not 4 mod 8);
# inner 32, 36, 44, 68 (a chunk of 64 and 4), 256 and 260
TRM_SHAPES = {"sasrec": (257, 50, 64, 2, 256), "L1-D16-H4": (1, 1, 16, 4, 32),
              "L7-D16-H1": (3, 7, 16, 1, 32), "L16-D32-H2-I260": (3, 16, 32, 2, 260),
              "L57-D64-H4": (5, 57, 64, 4, 256), "L50-D32-H4-I32": (3, 50, 32, 4, 32),
              "B1-L50-D64-H1": (1, 50, 64, 1, 256), "L13-D16-H4-I36": (4, 13, 16, 4, 36),
              "L33-D24-H2-I68": (3, 33, 24, 2, 68), "L20-D20-H5-I44": (2, 20, 20, 5, 44)}


def test_trm_shapes_are_shapes_the_kernels_take():
    """Every TRM_SHAPES case is one the route sends to the whole-layer
    kernel and both instances take: widths multiples of 4, at most MAX_LEN
    positions, and both working sets within a block, both ways; together they
    put K past the end of a tf32 k-step (8) and of a bf16 one (16) in every
    product kind (heads 4 and 12 wide, L 7, 13, 33, 57, inner chunks ending
    at 4 and 36)."""
    ks = set()
    for name, (B, L, D, H, I) in TRM_SHAPES.items():
        hd = D // H
        assert B >= 1 and D % H == 0 and D % 4 == hd % 4 == I % 4 == 0, name
        assert L <= port_trm.MAX_LEN and port_trm.layer_route(L, D, I) == "layer", name
        for backward in (False, True):
            assert port_trm.smem_bytes_fp32(L, D, I, backward) <= port_trm.MAX_SMEM_BYTES
            assert port_trm.smem_bytes_bf16(L, D, I, backward) <= port_trm.MAX_SMEM_BYTES
        ks.update((hd % 8, L % 8, I % 64 % 8, D % 8))
    assert {4, 5, 7, 1} <= ks


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(TRM_SHAPES))
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_trm_layer_kernels_match_plain_on_card(cuda_device, shape, bf16, causal, rate):
    """trm_layer_fwd and trm_layer_bwd against the plain version fed the masks
    the kernels draw, at SASRec's widths and at the tile edges of both
    instances' products (TRM_SHAPES; the bidirectional cases with a sequence
    that has no valid key): y, dx and the 16 gradients, each within 2e-4
    (fp32 instance: 3xTF32 products, fp32's precision) or 1e-2 (bf16
    instance: one bf16 step where an fp32 sum crosses a rounding boundary)
    of the tensor's largest value, a gradient that is 0 but for rounding
    (bk) within that of 1% of the largest gradient; one launch each; two
    runs bit-identical."""
    B, L, D, H, I = TRM_SHAPES[shape]
    x, params, valid, dy = _trm_inputs(B, L, D, I, 3, cuda_device, empty_row=not causal)
    seed = torch.tensor([99], dtype=torch.int64, device=cuda_device)
    kw = dict(n_heads=H, causal=causal, act="gelu", dropout=rate, attn_dropout=rate,
              layer=1, bf16=bf16)
    before = (port_trm.trm_layer_fwd_cuda.launches, port_trm.trm_layer_bwd_cuda.launches)
    y = port_trm.trm_layer_fwd_cuda(x, params, valid, seed, **kw)
    dx, g = port_trm.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw)
    assert (port_trm.trm_layer_fwd_cuda.launches,
            port_trm.trm_layer_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    dx2, g2 = port_trm.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw)
    assert torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
    masks = (port_trm.trm_dropout_masks_cuda(seed, B, H, L, D, rate, rate, layer=1)
             if rate else None)
    cfg = (H, causal, "gelu", 1e-12, bf16)
    ref_y = port_trm.trm_layer_torch_fwd(x, params, valid, masks, *cfg)
    ref_dx, ref_g = port_trm.trm_layer_torch_bwd(x, params, valid, masks, dy, *cfg)
    tol = 1e-2 if bf16 else 2e-4
    floor = 1e-2 * max(float(v.abs().max()) for v in ref_g.values())
    for name, a, b, least in [("y", y, ref_y, 0.0), ("dx", dx, ref_dx, 0.0)] + [
            (k, g[k], ref_g[k], floor) for k in g]:
        err = float((a - b).abs().max()) / max(float(b.abs().max()), least, 1e-30)
        assert err <= tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("shape", [(7, 8, 16, 2, 32), (3, 57, 64, 4, 260)],
                         ids=["L8-D16", "L57-D64-I260"])
def test_trm_layer_autograd_and_limits_on_card(cuda_device, bf16, shape):
    """The dispatcher on CUDA tensors goes through TrmLayer (one forward and
    one backward launch), its dropout keyed by the seed, in both instances,
    at a small shape and at the bf16 instance's edges (57 positions, 4
    heads, a ragged FFN chunk); y against the plain version (fp32 within
    2e-4 relative, bf16 within 1e-2 of its largest value), the gradients of
    x and every leaf against the plain version's autograd at the same bound;
    widths beyond the kernel's limits raise and nothing falls back."""
    B, L, D, H, I = shape
    x, params, valid, dy = _trm_inputs(B, L, D, I, 5, cuda_device)
    x.requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    seed = torch.tensor([7], dtype=torch.int64, device=cuda_device)
    kw = dict(n_heads=H, causal=True, dropout=0.5, attn_dropout=0.5, seed=seed, bf16=bf16)
    before = (port_trm.trm_layer_fwd_cuda.launches, port_trm.trm_layer_bwd_cuda.launches)
    y = port_trm.trm_layer(x, params, valid, **kw)
    (y * dy).sum().backward()
    assert (port_trm.trm_layer_fwd_cuda.launches,
            port_trm.trm_layer_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    masks = port_trm.trm_dropout_masks_cuda(seed, B, H, L, D, 0.5, 0.5)
    xr = x.detach().clone().requires_grad_(True)
    pr = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    ref = port_trm.trm_layer_torch(xr, pr, valid, masks, n_heads=H, causal=True, bf16=bf16)
    (ref * dy).sum().backward()
    if not bf16:
        torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-5)
    tol = 1e-2 if bf16 else 2e-4
    floor = 1e-2 * max(float(v.grad.abs().max()) for v in pr.values())
    pairs = [("y", y.detach(), ref.detach(), 0.0), ("x", x.grad, xr.grad, 0.0)]
    for name, a, b, least in pairs + [(k, params[k].grad, pr[k].grad, floor) for k in params]:
        assert a is not None and torch.isfinite(a).all(), name
        err = float((a - b).abs().max()) / max(float(b.abs().max()), least, 1e-30)
        assert err <= tol, (name, err)
    with pytest.raises(ValueError, match="seed"):
        port_trm.trm_layer(x, params, valid, n_heads=H, causal=True, dropout=0.5)
    # the working set is the built library's own figure, held to the card's limit
    smem = port_trm._lib().trm_layer_smem_bytes
    assert smem(50, 64, 256, 1) == 114112 <= port_trm.MAX_SMEM_BYTES < smem(200, 64, 256, 1)
    smem_bf16 = port_trm._lib().trm_layer_smem_bytes_bf16
    assert smem_bf16(50, 64, 256, 1) == 105312 < port_trm.MAX_SMEM_BYTES \
        < smem_bf16(200, 64, 256, 1)
    wide, wparams, wvalid, _ = _trm_inputs(2, 200, 64, 256, 6, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        port_trm.trm_layer(wide, wparams, wvalid, n_heads=2, causal=True)
    odd, oparams, ovalid, _ = _trm_inputs(2, 8, 18, 32, 6, cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        port_trm.trm_layer(odd, oparams, ovalid, n_heads=2, causal=True)


# ------------------------------------------------- the packed-bit row and column kernels

def _bit_inputs(n_major, nbytes, R, D, seed, device, kind="random"):
    """Packed rows, picked rows with repeats, and bf16 operands for both
    products. ``kind``: "random" bytes; "sparse", about 28 set bits a row as
    at the Yelp shape; "power", power-law columns with a hot 32-column word
    (columns 32-63) set in most rows, as popular items are in a user batch;
    "repeat", sparse rows with one picked row repeated through the batch;
    "hot10", sparse rows picked once each but one row of 14,000 set bits (the
    Yelp item side's top row) picked 10 times; "same", every pick that row;
    "heavy", sparse rows and a row of 60,000 set bits (far more than the row
    kernel's pieces can share at 256 a piece) picked 3 times."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        bits = rng.randint(0, 256, (n_major, nbytes)).astype(np.uint8)
    else:
        n_cols = nbytes * 8 - 100
        if kind == "power":
            cols = np.floor(n_cols * rng.random_sample((n_major, 28)) ** 3).astype(np.int64)
        else:
            cols = rng.randint(0, n_cols, (n_major, 28))
        bits = np.zeros((n_major, nbytes), np.uint8)
        np.bitwise_or.at(bits, (np.repeat(np.arange(n_major), 28), cols.ravel() // 8),
                         (1 << (cols.ravel() % 8)).astype(np.uint8))
        if kind == "power":
            hot = (rng.random_sample((n_major, 1)) < 0.9) & (rng.random_sample((n_major, 4)) < 0.7)
            bits[:, 4:8] |= (hot * rng.randint(1, 256, (n_major, 4))).astype(np.uint8)
        dense = {"hot10": 14_000, "same": 14_000, "heavy": 60_000}.get(kind)
        if dense:
            on = rng.choice(n_cols, min(dense, n_cols), replace=False)
            np.bitwise_or.at(bits[7], on // 8, (1 << (on % 8)).astype(np.uint8))
    rows = rng.randint(0, n_major, R).astype(np.int64)
    if R > 2:
        rows[1] = rows[0]
    if kind == "repeat":
        rows[rng.random_sample(R) < 0.5] = rows[0]
    if kind in ("hot10", "heavy"):
        rows = rng.choice(np.delete(np.arange(n_major), 7), R, replace=R > n_major - 1)
        rows[rng.choice(R, min(R, 10 if kind == "hot10" else 3), replace=False)] = 7
    if kind == "same":
        rows[:] = 7
    v = rng.randn(nbytes * 8 - 100, D).astype(np.float32)
    g = rng.randn(R, D).astype(np.float32)

    def dev(a, dtype=None):
        t = torch.from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)

    return dev(bits), dev(rows), dev(v, torch.bfloat16), dev(g, torch.bfloat16)


def _bit_counts(bits):
    """Each packed row's set bits, (n_major,) int32 on the rows' device."""
    return torch.from_numpy(np.unpackbits(bits.cpu().numpy(), axis=1).sum(axis=1)
                            .astype(np.int32)).to(bits.device)


def _bit_close(out, ref, magnitude):
    """Within 1e-5 of the sum of the terms' magnitudes, plus 1e-7."""
    return bool(((out - ref).abs() <= 1e-5 * magnitude + 1e-7).all())


def test_bit_launchers_refuse_cpu_tensors_and_dispatch_stays_plain():
    bits, rows, v, g = _bit_inputs(40, 64, 9, 16, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        port_bits.bit_rows_matmul_cuda(bits, rows, v)
    with pytest.raises(ValueError, match="CUDA"):
        port_bits.bit_cols_matmul_cuda(bits, rows, g)
    before = (port_bits.bit_rows_matmul_cuda.launches, port_bits.bit_cols_matmul_cuda.launches)
    out = port_bits.bit_rows_matmul(bits, rows, v)
    cols = port_bits.bit_cols_matmul(bits, rows, g)
    assert (port_bits.bit_rows_matmul_cuda.launches,
            port_bits.bit_cols_matmul_cuda.launches) == before
    dense = port_bits.unpack_bits(bits[rows]).float().numpy()
    np.testing.assert_allclose(out.numpy(), dense[:, :v.shape[0]] @ v.float().numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cols.numpy(), dense.T @ g.float().numpy(), rtol=1e-5, atol=1e-4)


# (R, kind, D, nbytes): the Yelp sides' batch sizes, a ragged batch and R = 1
# on random bytes and sparse rows; power-law images with a hot word, one row
# repeated through the batch, R = 0 and a small ragged R, D 16 and 128, D 6
# (g copied in 4-byte pieces, the sums stored in pairs) and ml-100k's 256
# bytes a row (8 strips: the widest clusters); for the row kernel, a row of
# 14,000 set bits picked 10 times among single picks at the Yelp widths,
# every pick that row, a row of 60,000 set bits (pieces many times the split's
# 256 bits) picked 3 times, and R past the plan block's 1,024 picks a pass
# and its split slots (70,000 picks of 3,000 rows, each id about 23 times)
BIT_CASES = ([(R, kind, 64, 12544 if R == 2048 else 12800)
              for kind in ("sparse", "random") for R in (2048, 4096, 1864, 1)]
             + [(2048, "power", 64, 12544), (4096, "power", 64, 12800),
                (4096, "repeat", 64, 12800), (0, "sparse", 64, 12800), (37, "power", 64, 12800),
                (2048, "power", 16, 12544), (2048, "power", 128, 12544),
                (1864, "random", 128, 12800), (1, "sparse", 16, 12800),
                (1864, "power", 6, 12800), (2048, "power", 64, 256), (4096, "repeat", 128, 256),
                (2048, "hot10", 64, 12800), (4096, "same", 64, 12800),
                (2048, "heavy", 128, 12800), (70_000, "repeat", 16, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("R,kind,D,nbytes", BIT_CASES)
def test_bit_kernels_match_plain_on_card(cuda_device, R, kind, D, nbytes):
    """Both kernels against their plain versions: within 1e-5 of the sum of
    the terms' magnitudes plus 1e-7; one call counted each, the row kernel's
    two kernel launches (none at R = 0); two runs bit-identical; every pick
    of an id gets the same row."""
    bits, rows, v, g = _bit_inputs(3000, nbytes, R, D, R + D, cuda_device, kind)
    counts = _bit_counts(bits)
    before = (port_bits.bit_rows_matmul_cuda.launches, port_bits.bit_cols_matmul_cuda.launches,
              port_bits.bit_rows_matmul_cuda.kernel_launches)
    out = port_bits.bit_rows_matmul_cuda(bits, rows, v, counts)
    cols = port_bits.bit_cols_matmul_cuda(bits, rows, g)
    assert (port_bits.bit_rows_matmul_cuda.launches, port_bits.bit_cols_matmul_cuda.launches,
            port_bits.bit_rows_matmul_cuda.kernel_launches) == (
                before[0] + (R > 0), before[1] + 1, before[2] + 2 * (R > 0))
    torch.cuda.synchronize()
    assert out.shape == (R, D) and cols.shape == (nbytes * 8, D)
    assert torch.equal(out, port_bits.bit_rows_matmul_cuda(bits, rows, v, counts))
    assert torch.equal(cols, port_bits.bit_cols_matmul_cuda(bits, rows, g))
    plan = port_bits.bit_cols_plan(R, nbytes, D, *port_bits.cols_occupancy(cols.device, D))
    assert port_bits.bit_cols_matmul_cuda.last_grid == {"blocks": plan["blocks"],
                                                        "cluster": plan["cluster"]}
    assert _bit_close(out, port_bits.bit_rows_matmul_torch(bits, rows, v),
                      port_bits.bit_rows_matmul_torch(bits, rows, v.abs()))
    assert _bit_close(cols, port_bits.bit_cols_matmul_torch(bits, rows, g),
                      port_bits.bit_cols_matmul_torch(bits, rows, g.abs()))
    if R:
        first = {}
        for r, m in enumerate(rows.tolist()):
            first.setdefault(m, r)
        assert torch.equal(out, out[torch.tensor([first[m] for m in rows.tolist()],
                                                 device=cuda_device)])
        plan = port_bits.rows_counters()
        assert (plan["unsplit walkers"] + plan["split walkers"], plan["copies"],
                plan["picks outside"], plan["picks resolved"]) == (len(first), R - len(first), 0, R)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,R,nbytes", [("hot10", 2048, 12800), ("heavy", 2048, 12800),
                                           ("power", 2048, 12544), ("random", 1864, 12800)])
def test_bit_rows_counts_move_only_the_split_on_card(cuda_device, kind, R, nbytes):
    """The row kernel's counts only balance its work: the image's counts,
    none, all zero (every row walked whole) and all huge (every row cut into
    the most pieces, the cuts past the real set bits) each give the plain
    version's rows within tolerance, and the zero and huge counts' rows agree
    within it too."""
    bits, rows, v, _ = _bit_inputs(3000, nbytes, R, 64, 11, cuda_device, kind)
    exact = _bit_counts(bits)
    ref = port_bits.bit_rows_matmul_torch(bits, rows, v)
    mag = port_bits.bit_rows_matmul_torch(bits, rows, v.abs())
    outs = {}
    for label, counts in (("exact", exact), ("none", None), ("zero", torch.zeros_like(exact)),
                          ("huge", torch.full_like(exact, 2 ** 30))):
        outs[label] = port_bits.bit_rows_matmul_cuda(bits, rows, v, counts)
        assert _bit_close(outs[label], ref, mag), label
    plan = port_bits.rows_counters()
    assert plan["split walkers"] >= 1  # huge counts split at least one row
    assert _bit_close(outs["zero"], outs["huge"], mag)
    assert torch.equal(outs["zero"], outs["none"])


@pytest.mark.cuda
def test_bit_cols_nan_for_ids_outside_on_card(cuda_device):
    """A picked id outside the matrix makes every output row NaN, at every
    cluster size the plan takes (the Yelp sides' and ml-100k's widths)."""
    for nbytes, R in ((12800, 4096), (12544, 2048), (256, 2048)):
        bits, rows, _, g = _bit_inputs(500, nbytes, R, 64, 5, cuda_device, "sparse")
        rows[R // 3] = 500
        assert bool(torch.isnan(port_bits.bit_cols_matmul_cuda(bits, rows, g)).all())


@pytest.mark.cuda
def test_bit_rows_nan_for_ids_outside_on_card(cuda_device):
    """The row kernel gives each pick of an id outside the matrix (past it,
    picked twice, and -1) a NaN row, and every other pick its row, copies of
    a popular row among them."""
    bits, rows, v, _ = _bit_inputs(500, 12800, 2048, 64, 6, cuda_device, "hot10")
    bad = [5, 900, 1500]
    rows[bad] = torch.tensor([500, 500, -1], device=cuda_device)
    out = port_bits.bit_rows_matmul_cuda(bits, rows, v, _bit_counts(bits))
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[bad]).all())
    keep = torch.ones(2048, dtype=torch.bool, device=cuda_device)
    keep[bad] = False
    good = rows[keep]
    assert _bit_close(out[keep], port_bits.bit_rows_matmul_torch(bits, good, v),
                      port_bits.bit_rows_matmul_torch(bits, good, v.abs()))
    plan = port_bits.rows_counters()
    assert plan["picks outside"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("D", [65, 256])
def test_bit_dispatchers_route_any_width_on_card(cuda_device, D):
    """Widths the kernels refuse run through the dispatchers: an odd D
    padded by a zero column (one launch a product), D 256 as two slices of
    128 columns (two); both products against the plain version at D."""
    bits, rows, v, g = _bit_inputs(300, 256, 700, D, 9, cuda_device, kind="sparse")
    before = (port_bits.bit_rows_matmul_cuda.launches, port_bits.bit_cols_matmul_cuda.launches)
    out_r = port_bits.bit_rows_matmul(bits, rows, v, _bit_counts(bits))
    out_c = port_bits.bit_cols_matmul(bits, rows, g)
    calls = 1 if D <= 128 else 2
    assert (port_bits.bit_rows_matmul_cuda.launches - before[0],
            port_bits.bit_cols_matmul_cuda.launches - before[1]) == (calls, calls)
    ref_r = port_bits.bit_rows_matmul_torch(bits, rows, v)
    ref_c = port_bits.bit_cols_matmul_torch(bits, rows, g)
    assert out_r.shape == ref_r.shape == (700, D) and out_c.shape == ref_c.shape
    assert _bit_close(out_r, ref_r, port_bits.bit_rows_matmul_torch(bits, rows, v.abs()))
    assert _bit_close(out_c, ref_c, port_bits.bit_cols_matmul_torch(bits, rows, g.abs()))


@pytest.mark.cuda
def test_bit_kernels_limits_on_card(cuda_device):
    """Shapes beyond the built library's limits raise; nothing falls back."""
    bits, rows, v, g = _bit_inputs(50, 64, 5, 16, 1, cuda_device)
    limits = port_bits._lib().limits
    with pytest.raises(ValueError, match="multiple"):
        port_bits.bit_rows_matmul_cuda(bits[:, :limits["nbytes_multiple"] - 16].contiguous(),
                                       rows, v[:8])
    for D in (limits["max_d"] + limits["d_multiple"], limits["d_multiple"] + 1):
        with pytest.raises(ValueError, match="D <="):
            port_bits.bit_cols_matmul_cuda(bits, rows, torch.zeros(
                (5, D), dtype=torch.bfloat16, device=cuda_device))
    with pytest.raises(TypeError, match="int64"):
        port_bits.bit_rows_matmul_cuda(bits, rows.int(), v)


# ------------------------------------------------------ the GRU recurrence kernels

def _gru_inputs(B, L, H, seed, device, bf16, h0=True):
    rng = np.random.RandomState(seed)
    xi = torch.from_numpy(rng.randn(B, L, 3 * H).astype(np.float32)).to(device)
    if bf16:
        xi = xi.to(torch.bfloat16)
    lim = np.sqrt(6.0 / (4 * H))
    wh = torch.from_numpy(rng.uniform(-lim, lim, (H, 3 * H)).astype(np.float32)).to(device)
    bh = torch.from_numpy((0.1 * rng.randn(3 * H)).astype(np.float32)).to(device)
    hinit = torch.from_numpy(((0.5 if h0 else 0.0) * rng.randn(B, H)).astype(np.float32))
    dout = torch.from_numpy(rng.randn(B, L, H).astype(np.float32)).to(device).to(xi.dtype)
    return xi, hinit.to(device), wh, bh, dout


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,L,H", [(2048, 50, 128), (1001, 50, 128), (7, 13, 24)])
def test_fused_gru_kernels_match_plain_on_card(cuda_device, bf16, B, L, H):
    """fused_gru_fwd and fused_gru_bwd against the plain version on the same
    inputs (nonzero h0): out, dxi, dh0, dwh, dbh each within 1e-4 (fp32
    instance: the same fp32 arithmetic in another order) or 1e-2 (bf16
    instance: a sum that lands on the other side of a rounding boundary
    moves a stored h_t or dxi by one bf16 step) of the tensor's largest
    value; one launch each; two runs bit-identical."""
    xi, h0, wh, bh, dout = _gru_inputs(B, L, H, 2 + bf16, cuda_device, bf16)
    fwd, bwd = port_gru.fused_gru_fwd_cuda, port_gru.fused_gru_bwd_cuda

    def counts():
        return (fwd.launches, bwd.launches, fwd.launches_tc, bwd.launches_tc,
                fwd.launches_tf32, bwd.launches_tf32)

    before = counts()
    out = port_gru.fused_gru_fwd_cuda(xi, h0, wh, bh)
    grads = port_gru.fused_gru_bwd_cuda(xi, h0, wh, bh, out, dout)
    # the bf16 instance on the one-block tensor-core route, the fp32 one on
    # the one-block 3xTF32 route
    assert counts() == tuple(n + d for n, d in zip(
        before, (1, 1, bf16, bf16, not bf16, not bf16)))
    torch.cuda.synchronize()
    assert torch.equal(out, port_gru.fused_gru_fwd_cuda(xi, h0, wh, bh))
    again = port_gru.fused_gru_bwd_cuda(xi, h0, wh, bh, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref_out = port_gru.fused_gru_torch_fwd(xi, h0, wh, bh, bf16)
    # the backward of both from the kernel's own forward output
    ref = port_gru.fused_gru_torch_bwd(xi, h0, wh, bh, out, dout, bf16)
    assert out.dtype == xi.dtype and grads[0].dtype == xi.dtype
    assert grads[3].shape == (3 * H,)
    tol = 1e-2 if bf16 else 1e-4
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), (out, *grads), (ref_out, *ref)):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("L", [1, 50])
@pytest.mark.parametrize("B", [1, 17, 2048])
@pytest.mark.parametrize("H", [4, 12, 64, 100, 128])
def test_fused_gru_tc_route_matches_plain_on_card(cuda_device, H, B, L, h0):
    """The bf16 instance up to H 128 runs the one-block tensor-core kernels
    (route 4, units padded to 16 inside the kernel): out, dxi, dh0, dwh and
    dbh against the plain version within 1e-2 of each tensor's largest value
    (as test_fused_gru_kernels_match_plain_on_card), h0 zero and not; each
    call counted once in ``launches_tc``; two runs bit-identical. The fp32
    instance at the same H takes the 3xTF32 kernels (route 5) instead."""
    lib = port_gru._lib()
    assert lib.fused_gru_route(H, 1) == 4 and port_gru.tc_route(H, True)
    assert lib.fused_gru_route(H, 0) == 5 and not port_gru.tc_route(H, False)
    xi, hinit, wh, bh, dout = _gru_inputs(B, L, H, 40 + H + B + L, cuda_device, True, h0)
    fwd, bwd = port_gru.fused_gru_fwd_cuda, port_gru.fused_gru_bwd_cuda
    before = (fwd.launches, bwd.launches, fwd.launches_tc, bwd.launches_tc)
    out = fwd(xi, hinit, wh, bh)
    grads = bwd(xi, hinit, wh, bh, out, dout)
    assert (fwd.launches, bwd.launches, fwd.launches_tc, bwd.launches_tc) == tuple(
        n + 1 for n in before)
    torch.cuda.synchronize()
    assert torch.equal(out, fwd(xi, hinit, wh, bh))
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd(xi, hinit, wh, bh, out, dout)))
    ref = (port_gru.fused_gru_torch_fwd(xi, hinit, wh, bh, True),
           *port_gru.fused_gru_torch_bwd(xi, hinit, wh, bh, out, dout, True))
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), (out, *grads), ref):
        assert a.shape == b.shape and torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= 1e-2, (name, _rel(a, b))
    # the fp32 instance does not take the route
    x32 = xi.float()
    before = (fwd.launches_tc, bwd.launches_tc, fwd.launches_fp32, fwd.launches_tf32)
    y32 = fwd(x32, hinit, wh, bh)
    bwd(x32, hinit, wh, bh, y32, dout.float())
    assert (fwd.launches_tc, bwd.launches_tc, fwd.launches_fp32, fwd.launches_tf32) == (
        before[0], before[1], before[2] + 1, before[3] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("L", [1, 50])
@pytest.mark.parametrize("B", [1, 17, 2048])
@pytest.mark.parametrize("H", [4, 12, 64, 100, 128])
def test_fused_gru_tf32_route_matches_plain_on_card(cuda_device, H, B, L, h0):
    """The fp32 instance up to H 128 runs the one-block 3xTF32 kernels
    (route 5, units padded to 16 inside the kernel, the products on mma.sync
    tf32 as hi + lo): out, dxi, dh0, dwh and dbh against the plain version
    within 1e-4 of each tensor's largest value (GRU_TOL[False], the fp32
    instance's bound), h0 zero and not; each call counted once in
    ``launches_tf32`` and not in ``launches_tc``; two runs bit-identical."""
    lib = port_gru._lib()
    assert lib.fused_gru_route(H, 0) == 5 and port_gru.tf32_route(H, False)
    assert not port_gru.tf32_route(H, True)
    xi, hinit, wh, bh, dout = _gru_inputs(B, L, H, 70 + H + B + L, cuda_device, False, h0)
    fwd, bwd = port_gru.fused_gru_fwd_cuda, port_gru.fused_gru_bwd_cuda

    def counts():
        return (fwd.launches, bwd.launches, fwd.launches_tf32, bwd.launches_tf32,
                fwd.launches_tc, bwd.launches_tc)

    before = counts()
    out = fwd(xi, hinit, wh, bh)
    grads = bwd(xi, hinit, wh, bh, out, dout)
    assert counts() == tuple(n + d for n, d in zip(before, (1, 1, 1, 1, 0, 0)))
    torch.cuda.synchronize()
    assert torch.equal(out, fwd(xi, hinit, wh, bh))
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd(xi, hinit, wh, bh, out, dout)))
    ref = (port_gru.fused_gru_torch_fwd(xi, hinit, wh, bh, False),
           *port_gru.fused_gru_torch_bwd(xi, hinit, wh, bh, out, dout, False))
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), (out, *grads), ref):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.cuda
def test_fused_gru_autograd_and_limits_on_card(cuda_device):
    """The dispatcher on CUDA tensors goes through FusedGru (one forward and
    one backward launch); hidden sizes beyond the kernel's limits raise and
    nothing falls back."""
    xi, h0, wh, bh, dout = _gru_inputs(5, 6, 16, 9, cuda_device, False)
    xi.requires_grad_(True)
    wh.requires_grad_(True)
    before = (port_gru.fused_gru_fwd_cuda.launches, port_gru.fused_gru_bwd_cuda.launches)
    out = port_gru.fused_gru(xi, h0, wh, bh)
    (out * dout).sum().backward()
    assert (port_gru.fused_gru_fwd_cuda.launches,
            port_gru.fused_gru_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, port_gru.fused_gru_torch(xi.detach(), h0, wh.detach(), bh),
                               rtol=1e-4, atol=1e-5)
    assert torch.isfinite(xi.grad).all() and torch.isfinite(wh.grad).all()
    lib = port_gru._lib()
    assert lib.fused_gru_max_shared_hidden() == 128 and lib.fused_gru_max_hidden() == 7264
    assert lib.fused_gru_max_cluster_hidden() == 384
    # the fp32 instance: the one-block 3xTF32 route (5) up to 128, wh in fp32
    # once (196,608 bytes at 128) beside two h buffers forward, one h buffer
    # and the dhh rows backward; device memory above
    assert [lib.fused_gru_route(H, 0) for H in (4, 128, 132)] == [5, 5, 2]
    assert (lib.fused_gru_smem_bytes(128, 0, 0), lib.fused_gru_smem_bytes(128, 1, 0)) == (
        212992, 229888)
    for H in (128, 132, 384, 388, 700, 704, 1348, 1352, 7264):
        for bf16 in (0, 1):
            assert lib.fused_gru_smem_bytes(H, 1, bf16) <= port_gru.MAX_SMEM_BYTES
    # scratch (the rounded wh and its transpose) only on the device-memory
    # route: the fp32 instance above 128, the bf16 one above the cluster limit
    assert lib.fused_gru_scratch_floats(128, 1) == 0 and lib.fused_gru_scratch_floats(132, 1) == 0
    assert lib.fused_gru_scratch_floats(132, 0) > 0 and lib.fused_gru_scratch_floats(388, 1) > 0
    # the global route's blocks own 16, 8, ... 1 sequences: its backward's
    # dbh partials, one row a block, say how many
    for H, rows in ((700, 16), (704, 8), (1348, 8), (1352, 4), (4468, 2), (4472, 1),
                    (7264, 1)):
        assert lib.fused_gru_bwd_blocks(33, 5, H, 0) == -(-33 // rows), H
    # past 7,264 no sequence's backward rows fit a block: they lie in a
    # device-memory scratch (route 3), the forward's too past 19,368, and
    # the kernels run on (test_fused_gru_global_rows_match_plain_on_card)
    for bf16 in (0, 1):
        assert lib.fused_gru_route(7264, bf16) == 2 and lib.fused_gru_route(7268, bf16) == 3
        assert lib.fused_gru_rows_floats(33, 7264, 1, bf16) == 0
        assert lib.fused_gru_rows_floats(33, 7268, 1, bf16) == 33 * 8 * 7268
        assert lib.fused_gru_rows_floats(33, 19368, 0, bf16) == 0
        assert lib.fused_gru_rows_floats(33, 19372, 0, bf16) == 33 * 3 * 19372
        assert lib.fused_gru_smem_bytes(7268, 1, bf16) == 0
        assert lib.fused_gru_bwd_blocks(33, 5, 7268, bf16) == 33
    args = _gru_inputs(2, 3, 7265, 1, cuda_device, False)[:4]
    before = port_gru.fused_gru_fwd_cuda.launches
    out = port_gru.fused_gru(*args)
    assert port_gru.fused_gru_fwd_cuda.launches == before + 1
    assert out.shape == (2, 3, 7265) and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,L,H", [(2048, 50, 256), (301, 9, 132), (257, 50, 10), (64, 7, 30)])
def test_fused_gru_wide_and_padded_match_plain_on_card(cuda_device, bf16, B, L, H):
    """Hidden sizes the shared-memory route does not take: above 128 the
    cluster kernels (bf16) or the global-memory ones (fp32, wh read from
    device memory), and H not a multiple of 4 zero-padded by the dispatcher. Through ``fused_gru`` and
    autograd: out and the gradients of xi, h0, wh and bh against the plain
    version's, within 1e-4 (fp32) or 1e-2 (bf16) of each tensor's largest
    value; one launch each way; two runs bit-identical."""
    xi, h0, wh, bh, dout = _gru_inputs(B, L, H, 20 + bf16, cuda_device, bf16)

    def run(fn):
        args = [t.clone().requires_grad_(True) for t in (xi, h0, wh, bh)]
        out = fn(*args)
        (out.float() * dout.float()).sum().backward()
        return [out.detach()] + [a.grad for a in args]

    before = (port_gru.fused_gru_fwd_cuda.launches, port_gru.fused_gru_bwd_cuda.launches)
    got = run(port_gru.fused_gru)
    assert (port_gru.fused_gru_fwd_cuda.launches,
            port_gru.fused_gru_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    again = run(port_gru.fused_gru)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = run(lambda *a: port_gru.fused_gru_torch(*a, bf16=bf16))
    assert got[0].shape == (B, L, H) and got[0].dtype == xi.dtype
    tol = 1e-2 if bf16 else 1e-4
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), got, ref):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("width", ["704", "1352", "limit", "limit + 4", "19372"])
def test_fused_gru_global_rows_match_plain_on_card(cuda_device, bf16, width):
    """Hidden sizes past 700, where the global route's blocks own fewer
    than 16 sequences: 704 (8), 1352 (4) and the limit of rows in shared
    memory (1, H 7,264); past it one sequence a block with its rows in
    device memory: the backward's at 7,268, both ways' at 19,372. Through
    fused_gru and autograd against the plain version, within 1e-4 (fp32) or
    1e-2 (bf16) of each tensor's largest value; one launch each way; two
    runs bit-identical."""
    limit = port_gru._lib().fused_gru_max_hidden()
    H = {"limit": limit, "limit + 4": limit + 4}.get(width) or int(width)
    B, L = (5, 3) if H >= limit else (37, 6)
    if H > 10000:
        B, L = 2, 2
    xi, h0, wh, bh, dout = _gru_inputs(B, L, H, 30 + bf16, cuda_device, bf16)

    def run(fn):
        args = [t.clone().requires_grad_(True) for t in (xi, h0, wh, bh)]
        out = fn(*args)
        (out.float() * dout.float()).sum().backward()
        return [out.detach()] + [a.grad for a in args]

    before = (port_gru.fused_gru_fwd_cuda.launches, port_gru.fused_gru_bwd_cuda.launches)
    got = run(port_gru.fused_gru)
    assert (port_gru.fused_gru_fwd_cuda.launches,
            port_gru.fused_gru_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    again = run(port_gru.fused_gru)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = run(lambda *a: port_gru.fused_gru_torch(*a, bf16=bf16))
    tol = 1e-2 if bf16 else 1e-4
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), got, ref):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [50, 1])
@pytest.mark.parametrize("B", [2048, 1001, 7])
@pytest.mark.parametrize("width", ["132", "256", "limit", "limit + 4"])
def test_fused_gru_cluster_kernels_match_plain_on_card(cuda_device, width, B, L):
    """The bf16 instance above the shared-memory route: H 132, 256 and the
    cluster limit take the cluster kernels (wh split over a thread-block
    cluster, the recurrent products on the tensor cores), the limit + 4 the
    global-memory ones. out, dxi, dh0, dwh and dbh against the plain version
    within 1e-2 of each tensor's largest value (the file's bf16 bound); one
    launch each way, counted in the route's share; two runs bit-identical."""
    limit = port_gru._lib().fused_gru_max_cluster_hidden()
    H = {"132": 132, "256": 256, "limit": limit, "limit + 4": limit + 4}[width]
    cluster = width != "limit + 4"
    assert port_gru.cluster_route(H, True) == cluster
    xi, h0, wh, bh, dout = _gru_inputs(B, L, H, 40 + L, cuda_device, True)
    fwd, bwd = port_gru.fused_gru_fwd_cuda, port_gru.fused_gru_bwd_cuda

    def counts():
        return fwd.launches, bwd.launches, fwd.launches_cluster, bwd.launches_cluster

    before = counts()
    out = fwd(xi, h0, wh, bh)
    grads = bwd(xi, h0, wh, bh, out, dout)
    assert counts() == tuple(b + d for b, d in zip(before, (1, 1, cluster, cluster)))
    torch.cuda.synchronize()
    assert torch.equal(out, fwd(xi, h0, wh, bh))
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd(xi, h0, wh, bh, out, dout)))
    ref_out = port_gru.fused_gru_torch_fwd(xi, h0, wh, bh, True)
    ref = port_gru.fused_gru_torch_bwd(xi, h0, wh, bh, out, dout, True)
    assert out.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    for name, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"), (out, *grads), (ref_out, *ref)):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= 1e-2, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H", [(2048, 50, 128), (1001, 50, 256), (7, 13, 132)])
def test_fused_gru_bf16_dwh_matches_plain_on_card(cuda_device, B, L, H):
    """The bf16 instance's dwh alone (``gru_dwh_tc_kernel``: dhh enters the
    tensor cores as two bf16 terms, hi + lo) against the plain version's
    sum over (b, t) of round(h_{t-1})^T dhh, here in float64, on the same
    bf16 out, h0 and fp32 dhh: within 1e-4 of the largest value, since
    h_{t-1} is exact in bf16 and hi + lo carries dhh to about 2^-17 of
    itself, which leaves the fp32 summation order; two runs bit-identical."""
    rng = np.random.RandomState(B + H)
    out = torch.from_numpy(rng.randn(B, L, H).astype(np.float32)).to(cuda_device)
    out = out.to(torch.bfloat16)
    h0 = torch.from_numpy((0.5 * rng.randn(B, H)).astype(np.float32)).to(cuda_device)
    dhh = torch.from_numpy(rng.randn(B, L, 3 * H).astype(np.float32)).to(cuda_device)
    got = port_gru.fused_gru_dwh_cuda(out, h0, dhh)
    torch.cuda.synchronize()
    assert torch.equal(got, port_gru.fused_gru_dwh_cuda(out, h0, dhh))
    hp = torch.cat([h0.to(torch.bfloat16)[:, None], out[:, :-1]], dim=1).double()
    ref = torch.einsum("blk,blc->kc", hp, dhh.double())
    assert got.shape == (H, 3 * H) and torch.isfinite(got).all()
    assert _rel(got.double(), ref) <= 1e-4, _rel(got.double(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H", [(2048, 50, 128), (1001, 50, 256), (7, 13, 132), (5, 1, 12),
                                   (2048, 50, 388)])
def test_fused_gru_fp32_dwh_matches_plain_on_card(cuda_device, B, L, H):
    """The fp32 instance's dwh alone (``gru_dwh_tf32_kernel``: h_{t-1} and
    dhh both split into a tf32 hi and its exact remainder, three mma a
    k-step) against the sum over (b, t) of h_{t-1}^T dhh in float64 on the
    same fp32 out, h0 and dhh: within 1e-5 of the largest value. 3xTF32
    keeps a product to about 2^-19 of itself, and each pass of 32 rows is
    added to the chunk's sum by fp32 adds, since the tensor cores' own fp32
    accumulation drifts down a chunk (summed in the mma accumulators: 1.6e-5
    at H 256, 1.0e-4 at H 388 on an H100; an fp32 library product 1e-6 and
    1.6e-6). H 388 takes the longest chunks (4 of 25,600 rows). Two runs
    bit-identical."""
    rng = np.random.RandomState(B + H + 1)
    out = torch.from_numpy(rng.randn(B, L, H).astype(np.float32)).to(cuda_device)
    h0 = torch.from_numpy((0.5 * rng.randn(B, H)).astype(np.float32)).to(cuda_device)
    dhh = torch.from_numpy(rng.randn(B, L, 3 * H).astype(np.float32)).to(cuda_device)
    got = port_gru.fused_gru_dwh_cuda(out, h0, dhh)
    torch.cuda.synchronize()
    assert torch.equal(got, port_gru.fused_gru_dwh_cuda(out, h0, dhh))
    hp = torch.cat([h0[:, None], out[:, :-1]], dim=1).double()
    ref = torch.einsum("blk,blc->kc", hp, dhh.double())
    assert got.shape == (H, 3 * H) and torch.isfinite(got).all()
    assert _rel(got.double(), ref) <= 1e-5, _rel(got.double(), ref)


# ------------------------------------------------- the attention-only kernels

def _attn_inputs(B, L, H, hd, seed, device, empty_row=True):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, L, H, hd).astype(np.float32)).to(device)
                   for _ in range(4))
    lens = rng.randint(1, L + 1, B)
    if empty_row:
        lens[0] = 0
    valid = torch.from_numpy((np.arange(L)[None, :] < lens[:, None]).astype(np.int32))
    return q, k, v, valid.to(device), do


def _attn_launches():
    """The forward's and the backward's launch counts: (all, whole-sequence
    route, key-tiled route)."""
    return np.array([[fn.launches, fn.launches_whole, fn.launches_tiled]
                     for fn in (port_attn.fused_attention_fwd_cuda,
                                port_attn.fused_attention_bwd_cuda)])


def test_attention_route_follows_length_and_width():
    """The route is chosen from (L, hd) before any launch: the whole
    sequence up to L 64 while the backward's block (q, k, v, dO rows, two
    L x L matrices, keep bytes) fits a Hopper block's shared memory, the key
    tiles beyond; SASRec's default shape takes the whole route with room for
    four blocks' shared memory an SM."""
    route = port_attn.fused_attention_route
    assert [route(L, 32) for L in (1, 50, 63, 64, 65, 200)] == ["whole"] * 4 + ["tiled"] * 2
    assert [route(64, hd) for hd in (8, 32, 64, 129, 132, 188, 192, 256)] == \
        ["whole"] * 6 + ["tiled"] * 2
    assert route(50, 192) == "whole" and route(50, 256) == "tiled"
    for L in (1, 50, 64):
        for hd in (8, 32, 129):
            fwd, bwd = (port_attn.whole_smem_bytes(L, hd, b) for b in (False, True))
            assert 0 < fwd < bwd <= port_attn.MAX_SMEM_BYTES
    assert port_attn.whole_smem_bytes(50, 32, True) == 55136
    assert 4 * (port_attn.whole_smem_bytes(50, 32, True) + 1024) <= 233472


def test_attention_launchers_refuse_cpu_tensors_and_dispatch_stays_plain():
    q, k, v, valid, do = _attn_inputs(3, 5, 2, 4, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        port_attn.fused_attention_fwd_cuda(q, k, v, valid)
    with pytest.raises(ValueError, match="CUDA"):
        port_attn.fused_attention_bwd_cuda(q, k, v, valid, do)
    before = (port_attn.fused_attention_fwd_cuda.launches,
              port_attn.fused_attention_bwd_cuda.launches)
    q.requires_grad_(True)
    out = port_attn.fused_attention(q, k, v, valid, causal=False)
    (out * do).sum().backward()
    assert (port_attn.fused_attention_fwd_cuda.launches,
            port_attn.fused_attention_bwd_cuda.launches) == before
    assert torch.equal(out, port_attn.fused_attention_torch(q, k, v, valid, False))
    assert torch.isfinite(q.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fused_attention_kernels_match_plain_on_card(cuda_device, causal, rate):
    """fused_attention_fwd and _bwd at SASRec's head shape (L 50, H 2, hd
    32), a ragged batch with a sequence that has no valid key, against the
    plain version fed the masks the kernels draw: o, dq, dk, dv within 1e-4
    of the tensor's largest value (fp32 sums and exp in another order); one
    launch each; two runs bit-identical."""
    B, L, H, hd = 257, 50, 2, 32
    q, k, v, valid, do = _attn_inputs(B, L, H, hd, 4, cuda_device)
    seed = torch.tensor([1234], dtype=torch.int64, device=cuda_device)
    kw = dict(causal=causal, rate=rate, layer=1)
    before = _attn_launches()
    o, stats = port_attn.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
    grads = port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats, **kw)
    # SASRec's length takes the whole-sequence route: one launch each way
    assert stats is None
    assert (_attn_launches() - before).tolist() == [[1, 1, 0], [1, 1, 0]]
    torch.cuda.synchronize()
    assert torch.equal(o, port_attn.fused_attention_fwd_cuda(q, k, v, valid, seed, **kw))
    again = port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    masks = (port_attn.fused_attention_dropout_masks_cuda(seed, B, H, L, rate, layer=1)
             if rate else None)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = port_attn.fused_attention_torch(tq, tk, tv, valid, causal, rate, masks=masks)
    (ref * do).sum().backward()
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads), (ref, tq.grad, tk.grad, tv.grad)):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.cuda
def test_fused_attention_autograd_masks_and_limits_on_card(cuda_device):
    """The dispatcher on CUDA tensors goes through FusedAttention, its
    dropout keyed by the seed; the keep masks are those of the whole-layer
    kernels' attention sites for the same seed and layer, keep about half at
    rate 0.5, and differ between layers; every route's block fits a Hopper
    block's shared memory, and head width 132 runs and matches the plain
    version."""
    from recbole_tpu_torch.ops import trm_layer as port_trm
    B, L, H, hd = 64, 50, 2, 32
    q, k, v, valid, do = _attn_inputs(B, L, H, hd, 5, cuda_device)
    seed = torch.tensor([77], dtype=torch.int64, device=cuda_device)
    q.requires_grad_(True)
    before = port_attn.fused_attention_bwd_cuda.launches
    out = port_attn.fused_attention(q, k, v, valid, causal=True, rate=0.5, seed=seed, layer=3)
    (out * do).sum().backward()
    assert port_attn.fused_attention_bwd_cuda.launches == before + 1
    masks = port_attn.fused_attention_dropout_masks_cuda(seed, B, H, L, 0.5, layer=3)
    ref = port_attn.fused_attention_torch(q.detach(), k, v, valid, True, 0.5, masks=masks)
    assert _rel(out.detach(), ref) <= 1e-4
    trm = port_trm.trm_dropout_masks_cuda(seed, B, H, L, 8, 0.5, 0.5, layer=3)["attn"]
    assert torch.equal(masks, trm)
    assert abs(float((masks > 0).float().mean()) - 0.5) < 0.01
    other = port_attn.fused_attention_dropout_masks_cuda(seed, B, H, L, 0.5, layer=4)
    assert not torch.equal(masks, other)
    with pytest.raises(ValueError, match="seed"):
        port_attn.fused_attention(q, k, v, valid, rate=0.5)
    for L, hd in ((50, 32), (64, 132), (65, 132), (200, 1024)):
        for backward in (0, 1):
            assert port_attn._lib().fused_attention_smem_bytes(L, hd, backward) <= \
                port_attn.MAX_SMEM_BYTES
    # head width 132 (past the 128 a tile held before hd was cut into chunks)
    # runs and matches the plain version, forward and backward
    wq, wk, wv, wvalid, wdo = _attn_inputs(2, 9, 1, 132, 6, cuda_device)
    wq.requires_grad_(True)
    before = _attn_launches()
    out = port_attn.fused_attention(wq, wk, wv, wvalid)
    (out * wdo).sum().backward()
    assert (_attn_launches() - before).tolist() == [[1, 1, 0], [1, 1, 0]]
    tq = wq.detach().clone().requires_grad_(True)
    ref = port_attn.fused_attention_torch(tq, wk, wv, wvalid, True)
    (ref * wdo).sum().backward()
    assert _rel(out.detach(), ref) <= 1e-4 and _rel(wq.grad, tq.grad) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B,L,H,hd", [(64, 200, 2, 32), (33, 97, 1, 128), (40, 65, 4, 16)])
def test_fused_attention_key_tiles_match_plain_on_card(cuda_device, causal, rate, B, L, H, hd):
    """Lengths past the whole-sequence route (L > 64) and head widths up to
    128, with a sequence that has no valid key: the tiled forward (online
    softmax) and the two backward kernels against the plain version fed the
    kernels' masks, within 1e-4 of each tensor's largest value; two runs
    bit-identical."""
    q, k, v, valid, do = _attn_inputs(B, L, H, hd, 7 + L, cuda_device)
    seed = torch.tensor([99], dtype=torch.int64, device=cuda_device)
    kw = dict(causal=causal, rate=rate, layer=2)
    before = _attn_launches()
    o, stats = port_attn.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
    grads = port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats, **kw)
    assert (_attn_launches() - before).tolist() == [[1, 0, 1], [1, 0, 1]]
    torch.cuda.synchronize()
    again = port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    masks = (port_attn.fused_attention_dropout_masks_cuda(seed, B, H, L, rate, layer=2)
             if rate else None)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = port_attn.fused_attention_torch(tq, tk, tv, valid, causal, rate, masks=masks)
    (ref * do).sum().backward()
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads), (ref, tq.grad, tk.grad, tv.grad)):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


# (B, L, H, hd): L 1, 50, 63, 64 on the whole-sequence route, 65 and 200 on
# the key tiles; head widths 8 to 256 (129: not a multiple of 4, so no
# 16-byte loads; 132 and 256 in two chunks of the tiled route, 256 also past
# the whole route's shared memory at L 50 and 64)
ATTN_ROUTE_CASES = [(9, 1, 2, 8), (64, 50, 2, 32), (33, 63, 4, 8), (17, 64, 1, 64),
                    (11, 50, 1, 129), (7, 64, 2, 132), (5, 50, 1, 256), (19, 65, 2, 32),
                    (6, 200, 1, 129), (5, 65, 4, 132), (4, 200, 2, 256), (3, 64, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B,L,H,hd", ATTN_ROUTE_CASES)
def test_fused_attention_routes_match_plain_on_card(cuda_device, causal, rate, B, L, H, hd):
    """Each route against the plain version fed the kernels' masks, with a
    sequence that has no valid key: o, dq, dk, dv within 1e-4 of each
    tensor's largest value; one launch each way, counted on the route
    fused_attention_route names; two runs bit-identical."""
    q, k, v, valid, do = _attn_inputs(B, L, H, hd, 11 + L + hd, cuda_device)
    seed = torch.tensor([4321 + hd], dtype=torch.int64, device=cuda_device)
    kw = dict(causal=causal, rate=rate, layer=L % 3)
    route = port_attn.fused_attention_route(L, hd)
    assert port_attn.ROUTES[port_attn._lib().fused_attention_route(L, hd)] == route

    def run():
        o, stats = port_attn.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True,
                                                      **kw)
        out = (o, *port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o,
                                                      stats=stats, **kw))
        torch.cuda.synchronize()
        return out

    before = _attn_launches()
    got = run()
    one = [1, 1, 0] if route == "whole" else [1, 0, 1]
    assert (_attn_launches() - before).tolist() == [one, one]
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    masks = (port_attn.fused_attention_dropout_masks_cuda(seed, B, H, L, rate, layer=L % 3)
             if rate else None)
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = port_attn.fused_attention_torch(tq, tk, tv, valid, causal, rate, masks=masks)
    (ref * do).sum().backward()
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, (ref, tq.grad, tk.grad, tv.grad)):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.cuda
def test_fused_attention_route_copy_matches_library_on_card(cuda_device):
    """The Python copy of the whole route's shared-memory formula, which
    names the route before any launch, gives the built library's bytes and
    route; SASRec's shape holds at least two whole-route blocks an SM each
    way; a tensor that is not 16-byte aligned (4-byte loads) gives the
    same bits as an aligned copy."""
    lib = port_attn._lib()
    for L in (1, 4, 17, 50, 63, 64, 65, 200):
        for hd in (1, 8, 30, 32, 64, 129, 132, 188, 192, 256, 1024):
            assert port_attn.ROUTES[lib.fused_attention_route(L, hd)] == \
                port_attn.fused_attention_route(L, hd), (L, hd)
            if port_attn.fused_attention_route(L, hd) == "whole":
                for backward in (0, 1):
                    assert lib.fused_attention_smem_bytes(L, hd, backward) == \
                        port_attn.whole_smem_bytes(L, hd, bool(backward)), (L, hd, backward)
    for backward in (False, True):
        assert port_attn.fused_attention_blocks_per_sm(50, 32, True, backward) >= 2
    B, L, H, hd = 5, 50, 2, 32
    q, k, v, valid, do = _attn_inputs(B, L, H, hd, 12, cuda_device)
    shifted = torch.empty(B * L * H * hd + 1, device=cuda_device)[1:].view(B, L, H, hd)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(port_attn.fused_attention_fwd_cuda(shifted, k, v, valid),
                       port_attn.fused_attention_fwd_cuda(q, k, v, valid))


@pytest.mark.cuda
def test_trm_layer_smem_copy_matches_library_on_card(cuda_device):
    """The Python copies of the whole-layer kernel's shared-memory formulas,
    the fp32 instance's (3xTF32) and the bf16 instance's, give the built
    library's bytes, at shapes the route takes and beyond; SASRec's default
    shape takes the kernel, L 58 / D 64, L 200 and D 128 take the attention
    path."""
    lib = port_trm._lib()
    for L, D, I in ((50, 64, 256), (57, 64, 256), (58, 64, 256), (200, 64, 256),
                    (50, 128, 256), (8, 16, 32), (100, 32, 64), (1, 16, 260), (147, 4, 4),
                    (13, 16, 36), (33, 24, 68), (20, 20, 44), (1, 6400, 256), (21, 256, 256)):
        for backward in (0, 1):
            assert port_trm.smem_bytes_fp32(L, D, I, backward) == \
                lib.trm_layer_smem_bytes(L, D, I, backward), (L, D, I, backward)
            assert port_trm.smem_bytes_bf16(L, D, I, backward) == \
                lib.trm_layer_smem_bytes_bf16(L, D, I, backward), (L, D, I, backward)
    assert port_trm.layer_route(50, 64, 256) == "layer"
    assert {port_trm.layer_route(*s) for s in ((58, 64, 256), (200, 64, 256),
                                                (50, 128, 256))} == {"attention"}


@pytest.mark.cuda
def test_sasrec_at_head_width_25_takes_the_attention_path_on_card(cuda_device, tmp_path):
    """SASRec at hidden 50 with 2 heads (head width 25, inner 200) under
    fused_attention "layer2" on the card: layer_route sends the widths that
    are not multiples of 4 to the attention path before any launch, so a
    training step launches the attention kernels and no whole-layer kernel;
    the loss agrees with the same model on the CPU (plain versions) at rtol
    2e-4 in fp32, and every gradient is finite."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    assert port_trm.layer_route(20, 50, 200, 2) == "attention"
    _make_synth(tmp_path)
    cfg = {"data_path": str(tmp_path / "data"), "state": "ERROR",
           "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
           "valid_full_to_uni1000": False, "MAX_ITEM_LIST_LENGTH": 20, "hidden_size": 50,
           "n_heads": 2, "inner_size": 200, "fused_attention": "layer2",
           "compute_dtype": "float32", "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0}
    losses = {}
    for dev in ("cpu", "cuda"):
        config = Config("SASRec", "synth", config_dict={**cfg, "device": dev},
                        _parse_cmd_line=False)
        train = data_preparation(config, create_dataset(config))[0]
        torch.manual_seed(0)
        model = get_model("SASRec")(config, train.dataset)
        if dev == "cpu":
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        cols = train.columns()
        batch = {f: torch.as_tensor(v[:128]).long().to(dev) for f, v in cols.items()}
        before = (port_attn.fused_attention_fwd_cuda.launches,
                  port_attn.fused_attention_bwd_cuda.launches,
                  port_trm.trm_layer_fwd_cuda.launches)
        loss = model.calculate_loss(batch)
        loss.backward()
        losses[dev] = loss.item()
        if dev == "cuda":
            torch.cuda.synchronize()
            n = model.n_layers
            assert (port_attn.fused_attention_fwd_cuda.launches,
                    port_attn.fused_attention_bwd_cuda.launches,
                    port_trm.trm_layer_fwd_cuda.launches) == (before[0] + n, before[1] + n,
                                                              before[2])
            assert all(torch.isfinite(p.grad).all() for p in model.parameters()
                       if p.grad is not None)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-4)


# ------------------------------------------------------- the rel_apply kernels

def _rel_inputs(N, D, NR, seed, device, skew=None, empty=None, outside=0):
    """v, rel, R, dy; ``skew``: that share of the rows on relation 0;
    ``empty``: a relation with no rows; ``outside``: rows with a relation
    id outside [0, NR)."""
    rng = np.random.RandomState(seed)
    rel = rng.randint(0, NR, N)
    if skew:
        rel[rng.random_sample(N) < skew] = 0
    if empty is not None:
        rel[rel == empty] = (empty + 1) % NR
    if outside:
        rel[rng.choice(N, outside, replace=False)] = NR
    v = rng.randn(N, D).astype(np.float32)
    R = (rng.randn(NR, D, D) / np.sqrt(D)).astype(np.float32)
    dy = rng.randn(N, D).astype(np.float32)
    return (torch.from_numpy(v).to(device), torch.from_numpy(rel.astype(np.int32)).to(device),
            torch.from_numpy(R).to(device), torch.from_numpy(dy).to(device))


REL_CASES = {"step": dict(N=131072, D=64, NR=53), "ragged": dict(N=1001, D=64, NR=53, empty=7),
             "skew": dict(N=20000, D=64, NR=53, skew=0.9), "one": dict(N=777, D=64, NR=1),
             "many": dict(N=30000, D=64, NR=200, outside=5), "wide": dict(N=5000, D=128, NR=24),
             "d20": dict(N=3001, D=20, NR=7, outside=3), "d36": dict(N=4099, D=36, NR=11, empty=2),
             "d4": dict(N=2500, D=4, NR=5), "all_one": dict(N=9000, D=64, NR=53, skew=1.0),
             "nr_max": dict(N=3000, D=16, NR=16383, outside=4)}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", sorted(REL_CASES))
def test_rel_apply_kernels_match_plain_on_card(cuda_device, bf16, case):
    """rel_apply_fwd and rel_apply_bwd against the plain version on the same
    inputs: y, dv and dR within rtol 2e-4 of each tensor's largest value in
    the fp32 instance (fp32 sums in another order), within 2e-2 of it in the
    bf16 instance (the bound the JAX kernel is held to against the XLA loop,
    tests/test_round5_fixes.py:163-195); one call each, 3 kernels forward
    and 4 backward (it buckets again); two runs bit-identical. The cases:
    RippleNet's step, the edges, D = 4 mod 8 (k padded with zeros), D 4,
    every row in one relation, and the most relations with few rows."""
    c = dict(REL_CASES[case])
    N, D, NR = c.pop("N"), c.pop("D"), c.pop("NR")
    v, rel, R, dy = _rel_inputs(N, D, NR, 31 + N, cuda_device, **c)
    fwd, bwd = port_rel.rel_apply_fwd_cuda, port_rel.rel_apply_bwd_cuda
    before = (fwd.launches, bwd.launches, fwd.kernel_launches, bwd.kernel_launches)
    y = port_rel.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
    dv, dR = port_rel.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
    assert (fwd.launches, bwd.launches, fwd.kernel_launches, bwd.kernel_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 3, before[3] + 4)
    torch.cuda.synchronize()
    assert torch.equal(y, port_rel.rel_apply_fwd_cuda(v, rel, R, bf16=bf16))
    dv2, dR2 = port_rel.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
    assert torch.equal(dv, dv2) and torch.equal(dR, dR2)
    ref_y = port_rel.rel_apply_torch(v, rel, R, bf16)
    ref_dv, ref_dR = port_rel.rel_apply_torch_bwd(v, rel, R, dy, bf16)
    tol = 2e-2 if bf16 else 2e-4
    for name, a, b in (("y", y, ref_y), ("dv", dv, ref_dv), ("dR", dR, ref_dR)):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= tol, (name, _rel(a, b))
    if "outside" in c:
        bad = (rel < 0) | (rel >= NR)
        assert float(y[bad].abs().max()) == 0.0 and float(dv[bad].abs().max()) == 0.0
    if "empty" in c:
        assert float(dR[c["empty"]].abs().max()) == 0.0


@pytest.mark.cuda
def test_rel_apply_autograd_and_limits_on_card(cuda_device):
    """The dispatcher on CUDA tensors goes through RelApply (one forward and
    one backward launch), int64 ids included; widths the kernels do not take
    raise and launch nothing."""
    v, rel, R, dy = _rel_inputs(300, 16, 5, 3, cuda_device)
    v.requires_grad_(True)
    R.requires_grad_(True)
    before = (port_rel.rel_apply_fwd_cuda.launches, port_rel.rel_apply_bwd_cuda.launches)
    y = port_rel.rel_apply(v, rel.long(), R, bf16=False)
    (y * dy).sum().backward()
    assert (port_rel.rel_apply_fwd_cuda.launches,
            port_rel.rel_apply_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    ref_dv, ref_dR = port_rel.rel_apply_torch_bwd(v.detach(), rel, R.detach(), dy)
    assert _rel(v.grad, ref_dv) <= 2e-4 and _rel(R.grad, ref_dR) <= 2e-4
    lib = port_rel._lib()
    assert lib.rel_apply_max_width() == 128
    assert lib.rel_apply_max_relations() == 16383
    for D in (18, 132):
        args = _rel_inputs(10, D, 3, 4, cuda_device)[:3]
        with pytest.raises(ValueError, match="multiple of 4"):
            port_rel.rel_apply_fwd_cuda(*args, bf16=False)
    assert port_rel.rel_apply_fwd_cuda.launches == before[0] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [18, 256])
def test_rel_apply_dispatcher_routes_any_width_on_card(cuda_device, bf16, D):
    """Widths the kernels refuse run through the dispatcher: D 18 zero-padded
    to 20 (one forward and one backward call), D 256 as two square blocks of
    128 composed (four of each); y, dv and dR against the plain version at
    D within the instance's tolerance (fp32 2e-4; bf16 2e-2, each block's y
    rounded before the blocks add)."""
    v, rel, R, dy = _rel_inputs(20000, D, 53, 8, cuda_device, outside=5)
    fwd, bwd = port_rel.rel_apply_fwd_cuda, port_rel.rel_apply_bwd_cuda
    vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)
    before = (fwd.launches, bwd.launches)
    y = port_rel.rel_apply(vg, rel, Rg, bf16=bf16)
    y.backward(dy)
    calls = 1 if D <= 128 else 4
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (calls, calls)
    tol = 2e-2 if bf16 else 2e-4
    ref_dv, ref_dR = port_rel.rel_apply_torch_bwd(v, rel, R, dy, bf16)
    assert _rel(y, port_rel.rel_apply_torch(v, rel, R, bf16)) <= tol
    assert _rel(vg.grad, ref_dv) <= tol and _rel(Rg.grad, ref_dR) <= tol
    assert y.shape == (20000, D) and float(y.detach()[rel == 53].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [64, 36])
def test_rel_apply_autograd_reuses_the_forwards_buckets_on_card(cuda_device, bf16, D):
    """Under autograd the backward takes the forward's bucket tables: at most
    3 kernels forward and 2 backward (none of them a bucketing kernel), and
    the same bits as the standalone launchers, which bucket for themselves;
    under no_grad the forward keeps nothing for a backward."""
    v, rel, R, dy = _rel_inputs(20000, D, 53, 5, cuda_device, outside=6)
    fwd, bwd = port_rel.rel_apply_fwd_cuda, port_rel.rel_apply_bwd_cuda
    vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)
    k0 = (fwd.kernel_launches, bwd.kernel_launches)
    y = port_rel.rel_apply(vg, rel, Rg, bf16=bf16)
    k1 = (fwd.kernel_launches, bwd.kernel_launches)
    y.backward(dy)
    k2 = (fwd.kernel_launches, bwd.kernel_launches)
    assert k1[0] - k0[0] <= 3 and k1[1] == k0[1]
    assert k2[0] == k1[0] and k2[1] - k1[1] <= 2
    torch.cuda.synchronize()
    y_alone = port_rel.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
    dv_alone, dR_alone = port_rel.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
    assert torch.equal(y.detach(), y_alone)
    assert torch.equal(vg.grad, dv_alone) and torch.equal(Rg.grad, dR_alone)
    with torch.no_grad():
        out = port_rel.rel_apply(vg, rel, Rg, bf16=bf16)
    assert out.grad_fn is None and torch.equal(out, y_alone)
