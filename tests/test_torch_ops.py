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
    p, m, v, g = (torch.from_numpy(a) for a in _adam_inputs((4, 4), seed=2))
    before = fused_adam.adam_leaf_triton.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.adam_leaf_triton(p, m, v, g, 1.0, 1.0, b1=B1, b2=B2, lr=LR, eps=EPS)
    assert fused_adam.adam_leaf_triton.launches == before


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


@pytest.mark.parametrize("fn", [port_eg.onehot_matmul_grad_torch, port_eg.windowed_grad_torch])
def test_embed_grad_plain_edge_cases(fn):
    """No rows at all, one row, every id equal, a (B, fs) column block with
    an id base, and writing into a row range of a larger table."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6041, 64), (3707, 64)])
def test_adam_kernel_matches_plain_on_card(cuda_device, shape):
    """Three steps of the Triton kernel against the plain version: rtol 1e-6
    of each element plus 1e-6 of the tensor's largest magnitude (the kernel
    contracts b*m + (1-b)*g into one FMA; where the terms cancel, the error
    stays an ulp of the terms)."""
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


# cotangents are summed in fp32 in the order of r by the kernels and in any
# order by index_add_: |diff| <= 1e-5 * sum|g| + 1e-7 elementwise
def _grad_close(out, ref, ids, g, V):
    bound = 1e-5 * _abs_sums(ids, g, V) + 1e-7
    return bool((np.abs(out.cpu().numpy() - ref.cpu().numpy()) <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,D", [(34816, 35692, 11), (2048 * 8, 2700, 11), (5000, 900, 1),
                                   (1, 17, 11), (0, 9, 4), (3000, 700, 64)])
def test_onehot_grad_kernel_matches_plain_on_card(cuda_device, R, V, D):
    ids, g = _grad_inputs(R, V, D, seed=R + D)
    tid, tg = torch.from_numpy(ids).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    before = port_eg.onehot_matmul_grad_cuda.launches
    out = port_eg.onehot_matmul_grad(tid, tg, V)
    assert port_eg.onehot_matmul_grad_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert _grad_close(out, port_eg.onehot_matmul_grad_torch(tid, tg, V), ids, g, V)
    assert torch.equal(out, port_eg.onehot_matmul_grad(tid, tg, V))   # deterministic
    same = torch.zeros_like(tid)
    out = port_eg.onehot_matmul_grad(same, tg, V)
    assert _grad_close(out, port_eg.onehot_matmul_grad_torch(same, tg, V),
                       np.zeros_like(ids), g, V)
    bf = tg.to(torch.bfloat16)
    assert _grad_close(port_eg.onehot_matmul_grad(tid, bf, V),
                       port_eg.onehot_matmul_grad_torch(tid, bf, V), ids, g, V)


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
    """Told each column's id range, a block scans only the columns that meet
    its rows: the same bits as the full scan, whatever the block's offset."""
    spec, V, ids, table, w = _field_case(4, 11)
    tid = torch.from_numpy(ids).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device)
    for f0, f1 in ((0, 2), (3, 4), (0, 4)):
        off, rows = spec[f0][0], sum(v for _, v in spec[f0:f1])
        col_off = torch.tensor([o for o, _ in spec[f0:f1]] + [off + rows], device=cuda_device)
        full = port_eg.onehot_matmul_grad(tid[:, f0:f1], tw[:, f0:f1], rows, id_base=off)
        ranged = port_eg.onehot_matmul_grad(tid[:, f0:f1], tw[:, f0:f1], rows, id_base=off,
                                            col_off=col_off)
        assert torch.equal(full, ranged)
        ref = port_eg.onehot_matmul_grad_torch(tid[:, f0:f1], tw[:, f0:f1], rows, id_base=off)
        # on the card the plain version is index_add_, whose atomics add in
        # an order that changes from run to run: the magnitude-relative
        # bound of the other one-hot tests
        assert _grad_close(ranged, ref, ids[:, f0:f1].reshape(-1) - off,
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


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_trm_layer_kernels_match_plain_on_card(cuda_device, bf16, causal, rate):
    """trm_layer_fwd and trm_layer_bwd at SASRec's widths against the plain
    version fed the masks the kernels draw: y, dx and the 16 gradients, each
    within 2e-4 (fp32 instance) or 2e-2 (bf16 instance: one bf16 step where an
    fp32 sum crosses a rounding boundary) of the tensor's largest value, a
    gradient that is 0 but for rounding (bk) within that of 1% of the largest
    gradient; one launch each; two runs bit-identical."""
    B, L, D, H, I = 257, 50, 64, 2, 256
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
    tol = 2e-2 if bf16 else 2e-4
    floor = 1e-2 * max(float(v.abs().max()) for v in ref_g.values())
    for name, a, b, least in [("y", y, ref_y, 0.0), ("dx", dx, ref_dx, 0.0)] + [
            (k, g[k], ref_g[k], floor) for k in g]:
        err = float((a - b).abs().max()) / max(float(b.abs().max()), least, 1e-30)
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_trm_layer_autograd_and_limits_on_card(cuda_device):
    """The dispatcher on CUDA tensors goes through TrmLayer (one forward and
    one backward launch), its dropout keyed by the seed; widths beyond the
    kernel's limits raise and nothing falls back."""
    B, L, D, H, I = 7, 8, 16, 2, 32
    x, params, valid, dy = _trm_inputs(B, L, D, I, 5, cuda_device)
    for p in params.values():
        p.requires_grad_(True)
    seed = torch.tensor([7], dtype=torch.int64, device=cuda_device)
    kw = dict(n_heads=H, causal=True, dropout=0.5, attn_dropout=0.5, seed=seed, bf16=False)
    before = (port_trm.trm_layer_fwd_cuda.launches, port_trm.trm_layer_bwd_cuda.launches)
    y = port_trm.trm_layer(x, params, valid, **kw)
    (y * dy).sum().backward()
    assert (port_trm.trm_layer_fwd_cuda.launches,
            port_trm.trm_layer_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    masks = port_trm.trm_dropout_masks_cuda(seed, B, H, L, D, 0.5, 0.5)
    ref = port_trm.trm_layer_torch(x, {k: v.detach() for k, v in params.items()}, valid,
                                   masks, n_heads=H, causal=True, bf16=False)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-5)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params.values())
    with pytest.raises(ValueError, match="seed"):
        port_trm.trm_layer(x, params, valid, n_heads=H, causal=True, dropout=0.5)
    # the working set is the built library's own figure, held to the card's limit
    smem = port_trm._lib().trm_layer_smem_bytes
    assert smem(50, 64, 256, 1) == 198200 <= port_trm.MAX_SMEM_BYTES < smem(200, 64, 256, 1)
    wide, wparams, wvalid, _ = _trm_inputs(2, 200, 64, 256, 6, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        port_trm.trm_layer(wide, wparams, wvalid, n_heads=2, causal=True)
    odd, oparams, ovalid, _ = _trm_inputs(2, 8, 18, 32, 6, cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        port_trm.trm_layer(odd, oparams, ovalid, n_heads=2, causal=True)


# ------------------------------------------------- the packed-bit row and column kernels

def _bit_inputs(n_major, nbytes, R, D, seed, device, dense=True):
    """Packed rows (random bytes, or about 28 set bits a row as at the Yelp
    shape), picked rows with repeats, and bf16 operands for both products."""
    rng = np.random.RandomState(seed)
    if dense:
        bits = rng.randint(0, 256, (n_major, nbytes)).astype(np.uint8)
    else:
        bits = np.zeros((n_major, nbytes), np.uint8)
        cols = rng.randint(0, nbytes * 8 - 100, (n_major, 28))
        np.bitwise_or.at(bits, (np.repeat(np.arange(n_major), 28), cols.ravel() // 8),
                         (1 << (cols.ravel() % 8)).astype(np.uint8))
    rows = rng.randint(0, n_major, R).astype(np.int64)
    if R > 2:
        rows[1] = rows[0]
    v = rng.randn(nbytes * 8 - 100, D).astype(np.float32)
    g = rng.randn(R, D).astype(np.float32)

    def dev(a, dtype=None):
        t = torch.from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)

    return dev(bits), dev(rows), dev(v, torch.bfloat16), dev(g, torch.bfloat16)


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


@pytest.mark.cuda
@pytest.mark.parametrize("R", [2048, 4096, 1864, 1])
@pytest.mark.parametrize("dense", [False, True])
def test_bit_kernels_match_plain_on_card(cuda_device, R, dense):
    """Both kernels against their plain versions at the Yelp sides' batch
    sizes, a ragged batch and R = 1, on random bytes and on sparse rows:
    within 1e-5 of the sum of the terms' magnitudes plus 1e-7; one launch
    each; two runs bit-identical."""
    bits, rows, v, g = _bit_inputs(3000, 12800 if R != 2048 else 12544, R, 64, R, cuda_device,
                                   dense)
    before = (port_bits.bit_rows_matmul_cuda.launches, port_bits.bit_cols_matmul_cuda.launches)
    out = port_bits.bit_rows_matmul_cuda(bits, rows, v)
    cols = port_bits.bit_cols_matmul_cuda(bits, rows, g)
    assert (port_bits.bit_rows_matmul_cuda.launches,
            port_bits.bit_cols_matmul_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(out, port_bits.bit_rows_matmul_cuda(bits, rows, v))
    assert torch.equal(cols, port_bits.bit_cols_matmul_cuda(bits, rows, g))
    assert _bit_close(out, port_bits.bit_rows_matmul_torch(bits, rows, v),
                      port_bits.bit_rows_matmul_torch(bits, rows, v.abs()))
    assert _bit_close(cols, port_bits.bit_cols_matmul_torch(bits, rows, g),
                      port_bits.bit_cols_matmul_torch(bits, rows, g.abs()))


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
    before = (port_gru.fused_gru_fwd_cuda.launches, port_gru.fused_gru_bwd_cuda.launches)
    out = port_gru.fused_gru_fwd_cuda(xi, h0, wh, bh)
    grads = port_gru.fused_gru_bwd_cuda(xi, h0, wh, bh, out, dout)
    assert (port_gru.fused_gru_fwd_cuda.launches,
            port_gru.fused_gru_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
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
    assert lib.fused_gru_max_shared_hidden() == 128 and lib.fused_gru_max_hidden() == 700
    for H in (128, 132, 700):
        assert lib.fused_gru_smem_bytes(H, 1) <= port_gru.MAX_SMEM_BYTES
    assert lib.fused_gru_scratch_floats(128) == 0 and lib.fused_gru_scratch_floats(132) > 0
    for H in (704, 701):
        args = _gru_inputs(2, 3, H, 1, cuda_device, False)[:4]
        before = port_gru.fused_gru_fwd_cuda.launches
        with pytest.raises(ValueError, match="at most 700"):
            port_gru.fused_gru(*args)
        assert port_gru.fused_gru_fwd_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,L,H", [(2048, 50, 256), (301, 9, 132), (257, 50, 10), (64, 7, 30)])
def test_fused_gru_wide_and_padded_match_plain_on_card(cuda_device, bf16, B, L, H):
    """Hidden sizes the shared-memory instance does not take: above 128 the
    global-memory instance (wh read from device memory), and H not a
    multiple of 4 zero-padded by the dispatcher. Through ``fused_gru`` and
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
    before = (port_attn.fused_attention_fwd_cuda.launches,
              port_attn.fused_attention_bwd_cuda.launches)
    o, stats = port_attn.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
    grads = port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats, **kw)
    assert (port_attn.fused_attention_fwd_cuda.launches,
            port_attn.fused_attention_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
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
    rate 0.5, and differ between layers; widths beyond the shared memory
    raise and nothing falls back."""
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
    assert port_attn._lib().fused_attention_max_head_width() == 128
    assert port_attn._lib().fused_attention_smem_bytes(128, 1) <= port_attn.MAX_SMEM_BYTES
    wide = _attn_inputs(2, 9, 1, 132, 6, cuda_device)
    before = port_attn.fused_attention_fwd_cuda.launches
    with pytest.raises(ValueError, match="head width"):
        port_attn.fused_attention(*wide[:4])
    assert port_attn.fused_attention_fwd_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B,L,H,hd", [(64, 200, 2, 32), (33, 97, 1, 128), (40, 33, 4, 16)])
def test_fused_attention_key_tiles_match_plain_on_card(cuda_device, causal, rate, B, L, H, hd):
    """Lengths past one 32-key tile and head widths up to 128, with a
    sequence that has no valid key: the tiled forward (online softmax) and
    the two backward kernels against the plain version fed the kernels'
    masks, within 1e-4 of each tensor's largest value; two runs bit-identical."""
    q, k, v, valid, do = _attn_inputs(B, L, H, hd, 7 + L, cuda_device)
    seed = torch.tensor([99], dtype=torch.int64, device=cuda_device)
    kw = dict(causal=causal, rate=rate, layer=2)
    o, stats = port_attn.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
    grads = port_attn.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats, **kw)
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


@pytest.mark.cuda
def test_trm_layer_smem_copy_matches_library_on_card(cuda_device):
    """The Python copy of the whole-layer kernel's shared-memory formula,
    which routes a layer before any launch, gives the built library's
    bytes; SASRec's default shape takes the kernel, L 58 / D 64, L 200 and
    D 128 take the attention path."""
    lib = port_trm._lib()
    for L, D, I in ((50, 64, 256), (57, 64, 256), (58, 64, 256), (200, 64, 256),
                    (50, 128, 256), (8, 16, 32), (100, 32, 64)):
        for backward in (0, 1):
            assert 4 * port_trm.smem_floats(L, D, I, backward) == \
                lib.trm_layer_smem_bytes(L, D, I, backward), (L, D, I, backward)
    assert port_trm.layer_route(50, 64, 256) == "layer"
    assert {port_trm.layer_route(*s) for s in ((58, 64, 256), (200, 64, 256),
                                                (50, 128, 256))} == {"attention"}


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
             "many": dict(N=30000, D=64, NR=200, outside=5), "wide": dict(N=5000, D=128, NR=24)}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", sorted(REL_CASES))
def test_rel_apply_kernels_match_plain_on_card(cuda_device, bf16, case):
    """rel_apply_fwd and rel_apply_bwd against the plain version on the same
    inputs: y, dv and dR within rtol 2e-4 of each tensor's largest value in
    the fp32 instance (fp32 sums in another order), within 2e-2 of it in the
    bf16 instance (the bound the JAX kernel is held to against the XLA loop,
    tests/test_round5_fixes.py:163-195); one launch each; two runs
    bit-identical."""
    c = dict(REL_CASES[case])
    N, D, NR = c.pop("N"), c.pop("D"), c.pop("NR")
    v, rel, R, dy = _rel_inputs(N, D, NR, 31 + N, cuda_device, **c)
    before = (port_rel.rel_apply_fwd_cuda.launches, port_rel.rel_apply_bwd_cuda.launches)
    y = port_rel.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
    dv, dR = port_rel.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
    assert (port_rel.rel_apply_fwd_cuda.launches,
            port_rel.rel_apply_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
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
    for D in (18, 132):
        args = _rel_inputs(10, D, 3, 4, cuda_device)[:3]
        with pytest.raises(ValueError, match="multiple of 4"):
            port_rel.rel_apply(*args, bf16=False)
    assert port_rel.rel_apply_fwd_cuda.launches == before[0] + 1
