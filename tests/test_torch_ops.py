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
from recbole_tpu_torch.ops import embed_grad as port_eg
from recbole_tpu_torch.ops import fused_adam, masked_topk as port_topk
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
        torch.testing.assert_close(ranged, ref, rtol=1e-5, atol=1e-6)


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
