"""The masked top-k kernel's launch plan and arithmetic against the JAX
package, on the CPU.

The kernel (``recbole_tpu_torch/csrc/masked_topk.cu``) splits the item axis
into the plan's slices, keeps each slice's top k a row, and merges the
slices' lists by rank in (score desc, id asc); its scores are 3xTF32
products on the tensor cores, and the k ids it keeps a row get their values
again as fp32 dot products. Here the plan is checked as pure Python, the
split-and-merge is run on the plain version's per-slice lists and held
against ``masked_topk_xla`` and ``masked_topk_pallas`` (interpret mode), and
the 3xTF32 scores and the fp32 values are emulated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from recbole_tpu.ops.masked_topk import masked_topk_pallas, masked_topk_xla
from recbole_tpu_torch.ops import masked_topk as port_topk

SMEM_CAP = 227 * 1024  # a block's shared memory on the H100
SENTINEL = (-np.inf, np.iinfo(np.int32).max)


def _inputs(B, N, D, seed, history=40, integer=False):
    """Queries, items and a history mask. ``integer``: small integer values,
    so that every product and sum is exact in fp32 in any order and equal
    items tie exactly."""
    rng = np.random.RandomState(seed)
    if integer:
        q = rng.randint(-3, 4, size=(B, D)).astype(np.float32)
        items = rng.randint(-3, 4, size=(N, D)).astype(np.float32)
    else:
        q = rng.randn(B, D).astype(np.float32)
        items = rng.randn(N, D).astype(np.float32)
    mask = np.zeros((B, N), np.int8)
    mask[:, 0] = 1
    for b in range(B):
        mask[b, rng.choice(N, min(history, N // 4), replace=False)] = 1
    return q, items, mask


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("B,N,D,k", [(4096, 3707, 64, 10), (1944, 3707, 64, 10),
                                     (943, 1683, 64, 10), (1, 3707, 64, 10),
                                     (37, 100, 20, 10), (8, 300, 16, 128),
                                     (5, 128, 4, 128), (20000, 98409, 512, 50),
                                     (3, 7, 8, 7)])
def test_plan_slices_cover_the_items_once(B, N, D, k):
    plan = port_topk.masked_topk_plan(B, N, D, k)
    cuts = plan.slice_items(N)
    assert len(cuts) == plan.slices >= 1
    assert cuts[0][0] == 0 and cuts[-1][1] == N
    for (lo, hi), (nlo, _) in zip(cuts, cuts[1:]):
        assert hi == nlo
    assert all(lo < hi and lo % port_topk.TN == 0 for lo, hi in cuts)
    assert plan.slices * k <= port_topk.MAX_MERGE and plan.slices <= port_topk.MAX_SLICES
    assert plan.row_tiles == -(-B // (16 * plan.mt))


@pytest.mark.parametrize("B,N", [(4096, 3707), (1944, 3707), (943, 1683)])
def test_plan_fills_the_card_in_one_wave(B, N):
    """One wave of one block an SM (768 or 1,024 threads each) covers at
    least 85% of the card's 132 SMs, with at most 4 slices; the taller
    blocks go to the larger batches."""
    plan = port_topk.masked_topk_plan(B, N, 64, 10, sms=132)
    blocks = plan.row_tiles * plan.slices
    assert 0.85 * 132 <= blocks <= 132
    assert 1 < plan.slices <= 4
    assert plan.mt == {4096: 4, 1944: 4, 943: 2}[B]
    assert plan.row_tiles == -(-B // (16 * plan.mt))


@pytest.mark.parametrize("D", [0, 4, 20, 64, 128, 512])
@pytest.mark.parametrize("k", [1, 128])
def test_plan_shared_memory_fits(D, k):
    """The block fits; at B 4,096 the plan takes 64 rows unless their
    shared memory does not fit, and then 32, which always fit."""
    plan = port_topk.masked_topk_plan(4096, 3707, D, k)
    assert plan.smem == port_topk.masked_topk_smem(plan.mt, D, k) <= SMEM_CAP
    assert port_topk.masked_topk_smem(2, D, k) <= SMEM_CAP
    assert plan.mt == (4 if port_topk.masked_topk_smem(4, D, k) <= SMEM_CAP else 2)


def test_launcher_loads_the_library_once(monkeypatch):
    """The launcher reads and hashes the source once, not every call."""
    calls = []

    class Fn:
        argtypes = restype = None

    class Lib:
        # the fp32 and bf16-operand instances
        masked_topk_f32, masked_topk_bf16 = Fn(), Fn()

    def load(name):
        calls.append(name)
        return Lib()

    monkeypatch.setattr(port_topk, "_LIB", None)
    monkeypatch.setattr(port_topk.cuda_build, "load", load)
    first = port_topk._lib()
    assert port_topk._lib() is first and port_topk._lib() is first
    assert calls == ["masked_topk"]


# ------------------------------------------------------- split and merge

def _slice_lists(q, items, mask, k, cuts):
    """Each slice's top k a row as the kernel's blocks leave it: the plain
    version on the slice, ids made global, padded with (-inf, INT_MAX)."""
    vals = np.full((len(cuts), q.shape[0], k), SENTINEL[0], np.float32)
    ids = np.full((len(cuts), q.shape[0], k), SENTINEL[1], np.int64)
    for s, (lo, hi) in enumerate(cuts):
        kk = min(k, hi - lo)
        v, i = port_topk.masked_topk_torch(torch.from_numpy(q), torch.from_numpy(items[lo:hi]),
                                           torch.from_numpy(mask[:, lo:hi]), kk)
        vals[s, :, :kk] = v.numpy()
        ids[s, :, :kk] = i.numpy() + lo
    return vals, ids


def _merge(vals, ids, k):
    """The kernel's merge: an entry's place is its position in its list plus
    the count of entries of each other list that beat it in (score desc, id
    asc); it is written when the place is below k."""
    S, B, _ = vals.shape
    out_v = np.full((B, k), np.nan, np.float32)
    out_i = np.full((B, k), -1, np.int64)
    lists = np.repeat(np.arange(S), k)
    for b in range(B):
        v, i = vals[:, b].reshape(-1), ids[:, b].reshape(-1)
        beats = (v[:, None] > v[None, :]) | ((v[:, None] == v[None, :]) & (i[:, None] < i[None, :]))
        beats &= lists[:, None] != lists[None, :]
        rank = np.tile(np.arange(k), S) + beats.sum(0)
        keep = rank < k
        assert np.bincount(rank[keep], minlength=k).max() == 1, "two entries took one place"
        out_v[b, rank[keep]], out_i[b, rank[keep]] = v[keep], i[keep]
    assert not np.isnan(out_v).any() and (out_i >= 0).all()
    return out_v, out_i


def _against_jax(q, items, mask, k, slices):
    """The split-and-merge at ``slices`` slices (the kernel's cut) against
    the XLA reference and the Pallas kernel: ids exact, values at rtol 1e-6
    / atol 1e-6 (the matmuls sum in different orders). Where a row runs out
    of unmasked items the Pallas kernel's -1e15 picks all name one id, so
    its ids are held only where the value lies above -1e15."""
    N = items.shape[0]
    plan = port_topk.MaskedTopkPlan(1, 1, slices, 0)
    cuts = plan.slice_items(N)
    vals, ids = _slice_lists(q, items, mask, k, cuts)
    v, i = _merge(vals, ids, k)
    assert (i < N).all()
    v_xla, i_xla = masked_topk_xla(jnp.asarray(q), jnp.asarray(items), jnp.asarray(mask), k)
    v_pl, i_pl = masked_topk_pallas(jnp.asarray(q), jnp.asarray(items), jnp.asarray(mask), k,
                                    tile_n=128, interpret=True)
    np.testing.assert_array_equal(i, np.asarray(i_xla))
    unmasked = v > np.float32(-1e15)
    np.testing.assert_array_equal(i[unmasked], np.asarray(i_pl)[unmasked])
    for v_ref in (v_xla, v_pl):
        np.testing.assert_allclose(v, np.asarray(v_ref), rtol=1e-6, atol=1e-6)
    return cuts, v, i


@pytest.mark.parametrize("slices", [1, 3, 5])
def test_split_merge_matches_jax(slices):
    q, items, mask = _inputs(6, 300, 16, seed=21)
    _against_jax(q, items, mask, 10, slices)


def test_split_merge_exact_duplicates_across_slices():
    """Integer data: many exact ties, duplicate rows copied into other
    slices; the lower id comes first across slice boundaries."""
    q, items, mask = _inputs(6, 300, 8, seed=22, history=5, integer=True)
    items[200] = items[3]
    items[130] = items[3]
    items[64] = items[63]  # either side of the first cut at 3 slices
    cuts, v, i = _against_jax(q, items, mask, 20, 3)
    assert cuts[0][1] == 64 and cuts[1][1] == 192
    for b in range(6):
        row = list(i[b])
        if 3 in row and 130 in row:
            assert row.index(3) < row.index(130)


def test_split_merge_wholly_masked_slice():
    """Every item of the middle slice masked in some rows: its list is all
    -1e15, which must not push out an unmasked item; a row masked almost
    everywhere still gets k entries, the masked ones ordered by id."""
    q, items, mask = _inputs(5, 320, 16, seed=23)
    mask[:3, 128:192] = 1
    mask[4, :] = 1
    mask[4, [5, 250]] = 0
    cuts, v, i = _against_jax(q, items, mask, 12, 4)
    assert cuts[2] == (128, 192)
    assert not np.isin(i[:3], np.arange(128, 192)).any()
    assert set(i[4, :2]) == {5, 250}
    assert (v[4, 2:] == np.float32(-1e15)).all() and (np.diff(i[4, 2:]) > 0).all()


def test_split_merge_k_above_a_slice():
    """k 40 over slices of 64 items with 50 of them masked: each list holds
    14 unmasked entries and 26 masked ones."""
    q, items, mask = _inputs(4, 256, 12, seed=24, history=0)
    for lo in range(0, 256, 64):
        mask[:, lo:lo + 50] = 1
    _against_jax(q, items, mask, 40, 4)


def test_split_merge_k128():
    """k 128 over slices shorter than k (N 300 in 4 slices of 64-128
    items), the plan's cut at B 8."""
    q, items, mask = _inputs(3, 300, 8, seed=25)
    plan = port_topk.masked_topk_plan(3, 300, 8, 128)
    assert plan.slices == 4
    cuts, _, _ = _against_jax(q, items, mask, 128, plan.slices)
    assert min(hi - lo for lo, hi in cuts) < 128


# --------------------------------------------------- 3xTF32 scores

def _tf32_parts(x):
    """x = hi + lo as the kernel splits it: hi is x rounded to its top 19
    bits (nearest, ties away from zero: an add of 2^12 and a mask on the
    int32 view), lo the exact remainder, of which the tensor cores read the
    top 19 bits (the mask). tests/test_torch_gru.py's split, with hi
    rounded in place of cut."""
    mask = torch.tensor(-8192, dtype=torch.int32)  # 0xffffe000
    hi = ((x.contiguous().view(torch.int32) + 4096) & mask).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def _mm_3xtf32(a, b):
    """a @ b as three tf32 products in fp32 sums, the small terms first
    (a_lo b_lo dropped): each product of two tf32 values is exact in fp32."""
    ah, al = _tf32_parts(a)
    bh, bl = _tf32_parts(b)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("D", [64, 20])
def test_3xtf32_scores_topk_matches_jax(D):
    """The kernel's arithmetic, emulated: the top k of the 3xTF32 scores
    against masked_topk_xla at B 64, N 1,683 (ml-100k's items): values at
    rtol 1e-5 / atol 1e-6, and any id that differs a near tie within that
    tolerance. One plain TF32 product is shown not to hold that bar."""
    q, items, mask = _inputs(64, 1683, D, seed=26, history=60)
    k = 10
    qt, it = torch.from_numpy(q), torch.from_numpy(items)
    scores = _mm_3xtf32(qt, it.T)
    scores = torch.where(torch.from_numpy(mask) > 0, torch.tensor(-1e15), scores)
    v, i = torch.sort(scores, dim=1, descending=True, stable=True)
    v, i = v[:, :k].numpy(), i[:, :k].numpy()
    v_xla, i_xla = (np.asarray(a) for a in masked_topk_xla(
        jnp.asarray(q), jnp.asarray(items), jnp.asarray(mask), k))
    np.testing.assert_allclose(v, v_xla, rtol=1e-5, atol=1e-6)
    exact = np.where(mask > 0, -1e15, q.astype(np.float64) @ items.T.astype(np.float64))
    differ = i != i_xla
    a = np.take_along_axis(exact, i, 1)[differ]
    b = np.take_along_axis(exact, i_xla.astype(np.int64), 1)[differ]
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert not np.take_along_axis(mask, i, 1).any()
    # one tf32 product drifts beyond the tolerance
    hi_q, _ = _tf32_parts(qt)
    hi_i, _ = _tf32_parts(it)
    one = (hi_q @ hi_i.T).numpy()  # one tf32 product, rounded operands
    ref = q.astype(np.float64) @ items.T.astype(np.float64)
    assert (np.abs(one - ref) > 1e-6 + 1e-5 * np.abs(ref)).any()


def _fma_dot(a, b):
    """a @ b.T as one fused multiply-add a coordinate, in order from 0, each
    rounded to fp32 (the product of two fp32 values is exact in fp64)."""
    v = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for d in range(a.shape[1]):
        v = (np.multiply.outer(a[:, d].astype(np.float64), b[:, d].astype(np.float64))
             + v).astype(np.float32)
    return v


@pytest.mark.parametrize("N", [10, 64, 65, 128])
def test_3xtf32_choice_with_fp32_values_matches_jax_at_k_equals_n(N):
    """The kernel's output, emulated, at k = N and unit scale, where the
    scores near 0 come out and the tolerance is its atol: the ids that the
    3xTF32 scores choose, their values taken again as fp32 dot products and
    each row ordered again, against masked_topk_xla at rtol 1e-5 / atol
    1e-6; ids equal or near ties."""
    q, items, mask = _inputs(70, N, 16, seed=33, history=N // 5)
    k = N
    s3 = _mm_3xtf32(torch.from_numpy(q), torch.from_numpy(items).T).numpy()
    s3 = np.where(mask > 0, np.float32(-1e15), s3)
    ids = np.argsort(-s3.astype(np.float64), axis=1, kind="stable")[:, :k]
    vals = np.where(mask > 0, np.float32(-1e15), _fma_dot(q, items))
    v = np.take_along_axis(vals, ids, 1)
    again = np.lexsort((ids, -v.astype(np.float64)), axis=1)
    v, ids = np.take_along_axis(v, again, 1), np.take_along_axis(ids, again, 1)
    v_xla, i_xla = (np.asarray(a) for a in masked_topk_xla(
        jnp.asarray(q), jnp.asarray(items), jnp.asarray(mask), k))
    np.testing.assert_allclose(v, v_xla, rtol=1e-5, atol=1e-6)
    differ = ids != i_xla
    a = np.take_along_axis(vals, ids, 1)[differ]
    b = np.take_along_axis(vals, i_xla.astype(np.int64), 1)[differ]
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert (np.sort(ids, axis=1) == np.arange(N)).all()
