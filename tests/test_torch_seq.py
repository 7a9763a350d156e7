"""The port's sequential slice against the JAX package's: the whole-layer
transformer's plain version against the Pallas kernels run in interpret mode
and against ``transformer_apply``; the sequential dataset, loaders and
transform; SASRec's loss and gradients; five trainer steps and full-sort
metrics; end-to-end runs and checkpoint resume. Inputs come from a numpy
seed, parameters from the JAX initialisers through ``convert``."""

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
from recbole_tpu.ops.fused_attention import attention_xla, fused_attention as jax_attention
from recbole_tpu.ops.fused_transformer import fused_transformer_layer as jax_layer_fp32
from recbole_tpu.ops.trm_layer import fused_transformer_layer2 as jax_layer_bf16
from recbole_tpu.trainer.trainer import Trainer as JaxTrainer
from recbole_tpu.utils.utils import init_seed as jax_init_seed
from recbole_tpu_torch import run_recbole
from recbole_tpu_torch.config.configurator import Config
from recbole_tpu_torch.convert import export_params, flatten_tree, load_jax_params
from recbole_tpu_torch.data.utils import create_dataset, data_preparation
from recbole_tpu_torch.models import get_model, layers
from recbole_tpu_torch.ops import fused_attention as fa
from recbole_tpu_torch.ops import trm_layer as tl
from recbole_tpu_torch.ops.fused_transformer import fused_transformer_layer_torch
from recbole_tpu_torch.trainer.trainer import Trainer, get_trainer, invalid_item_mask
from recbole_tpu_torch.utils.utils import init_seed

B, L, D, H, I = 8, 8, 16, 2, 32

# plain version, bf16 instance, against the Pallas kernel in interpret mode:
# both round the same operands at the same places and differ in the order of
# the fp32 sums, in erf (the kernel's rational form, 1.5e-7) and where a sum
# crosses a bf16 rounding boundary. Largest |difference| over the tensor's
# largest |value|; tests/test_round5_fixes.py allows 2e-2 / 3e-2 between the
# kernel and the XLA path.
BF16_KERNEL_TOL = 5e-3
# against transformer_apply(compute_dtype=bfloat16), which rounds at other
# places (activation in bf16, bf16 cotangents): the JAX test's own bound.
# The key bias's true gradient is 0 (a softmax does not see a constant added
# to every key's score), so what both packages return for it is rounding
# noise: it is measured against 5% of the layer's largest gradient there, the
# other leaves against their own largest value or 1% of that
BF16_XLA_TOL = 3e-2
BF16_XLA_FLOOR = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layer_inputs(seed, empty_row=False):
    """x, a cotangent, key validity and one layer's parameters (JAX init,
    with the biases and LayerNorm leaves moved off 0 and 1)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jax_layers.transformer_init(
        jax.random.key(seed), 1, H, D, I))[0]
    for k, v in params.items():
        if v.ndim == 1:
            params[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    x = (0.5 * rng.randn(B, L, D)).astype(np.float32)
    dy = rng.randn(B, L, D).astype(np.float32)
    lens = rng.randint(1, L + 1, B)
    if empty_row:
        lens[0] = 0
    valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return x, dy, valid, params


def _jax_grads(fn, params, x, dy):
    """y and the gradients of sum(y * dy) w.r.t. (params, x)."""
    y = fn(params, x)
    gp, gx = jax.grad(lambda p, x: jnp.sum(fn(p, x) * dy), argnums=(0, 1))(params, x)
    return np.asarray(y), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _torch_grads(fn, params, x, dy):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = fn(tp, tx)
    (y * torch.as_tensor(dy)).sum().backward()
    return y.detach().numpy(), {k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy()


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err)


def _all_close(got, ref, tol, floor=0.0):
    """y, x gradient and all 16 parameter gradients, each relative to its
    own largest value (or ``floor`` times the largest gradient, for leaves
    whose true gradient is about 0)."""
    (y, gp, gx), (ry, rgp, rgx) = got, ref
    _close(y, ry, tol, "y")
    gscale = max(float(np.abs(v).max()) for v in rgp.values())
    assert set(gp) == set(rgp) == set(tl.PARAM_KEYS)
    for k in rgp:
        denom = max(float(np.abs(rgp[k]).max()), floor * gscale, 1e-30)
        err = float(np.abs(gp[k] - rgp[k]).max()) / denom
        assert err <= tol, (k, err)
    _close(gx, rgx, tol, "dx")


# ------------------------------------------------------------ (a), (b): layer

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("act", ["gelu", "relu", "swish", "tanh", "sigmoid"])
def test_plain_bf16_layer_matches_pallas_layer2_interpret(causal, act):
    """(a) trm_layer_torch, bf16 instance, against
    fused_transformer_layer2(interpret=True): y and all 17 gradients."""
    x, dy, valid, params = _layer_inputs(1 + causal)
    seed = jnp.zeros((1,), jnp.int32)
    ref = _jax_grads(lambda p, x: jax_layer_bf16(x, p, jnp.asarray(valid), seed, n_heads=H,
                                                 causal=causal, act=act, interpret=True),
                     params, jnp.asarray(x), jnp.asarray(dy))
    got = _torch_grads(lambda p, x: tl.trm_layer_torch(x, p, torch.as_tensor(valid), None,
                                                       n_heads=H, causal=causal, act=act,
                                                       bf16=True), params, x, dy)
    _all_close(got, ref, BF16_KERNEL_TOL, floor=1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_layer_matches_transformer_apply_bf16(causal):
    """(a) the same against the XLA path transformer_apply(compute_dtype=
    bfloat16), and the port's own non-fused bf16 path against it too."""
    x, dy, valid, params = _layer_inputs(3 + causal)
    ref = _jax_grads(lambda p, x: jax_layers.transformer_apply(
        [p], x, None, H, act="gelu", compute_dtype=jnp.bfloat16,
        mask_spec=(jnp.asarray(valid), causal)), params, jnp.asarray(x), jnp.asarray(dy))
    got = _torch_grads(lambda p, x: tl.trm_layer_torch(x, p, torch.as_tensor(valid), None,
                                                       n_heads=H, causal=causal, bf16=True),
                       params, x, dy)
    _all_close(got, ref, BF16_XLA_TOL, floor=BF16_XLA_FLOOR)
    plain = _torch_grads(lambda p, x: layers.transformer_apply(
        [p], x, None, H, act="gelu", compute_dtype=torch.bfloat16,
        mask_spec=(torch.as_tensor(valid), causal), fused=False), params, x, dy)
    _all_close(plain, ref, BF16_XLA_TOL, floor=BF16_XLA_FLOOR)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("oracle", ["transformer_apply", "pallas_layer_interpret"])
def test_plain_fp32_layer_matches_jax(causal, oracle):
    """(b) the fp32 instance against transformer_apply(compute_dtype=None)
    and fused_transformer_layer(interpret=True), at rtol 2e-4 of each
    tensor's largest value; a sequence with no valid key in the non-causal
    case (a uniform softmax over all keys in both packages)."""
    x, dy, valid, params = _layer_inputs(5 + causal, empty_row=not causal)
    jv = jnp.asarray(valid)
    if oracle == "transformer_apply":
        fn = lambda p, x: jax_layers.transformer_apply(
            [p], x, None, H, act="gelu", compute_dtype=None, mask_spec=(jv, causal))
    else:
        fn = lambda p, x: jax_layer_fp32(x, p, jv, jnp.zeros((1,), jnp.int32), n_heads=H,
                                         causal=causal, interpret=True)
    ref = _jax_grads(fn, params, jnp.asarray(x), jnp.asarray(dy))
    got = _torch_grads(lambda p, x: fused_transformer_layer_torch(
        x, p, torch.as_tensor(valid), None, n_heads=H, causal=causal), params, x, dy)
    _all_close(got, ref, 2e-4, floor=1e-3)
    # the hand-written backward is the gradient of the forward: autograd
    # through the port's non-fused path gives the same
    auto = _torch_grads(lambda p, x: layers.transformer_apply(
        [p], x, None, H, act="gelu", mask_spec=(torch.as_tensor(valid), causal),
        fused=False), params, x, dy)
    _all_close(got, auto, 2e-4, floor=1e-3)


@pytest.mark.parametrize("fused,cdt,bf16", [("layer2", torch.bfloat16, True),
                                            ("layer2", None, False),
                                            ("layer2", torch.float32, False),
                                            ("layer", None, False)])
def test_transformer_apply_dispatch_follows_the_config_rule(fused, cdt, bf16):
    """fused_attention and compute_dtype choose the instance: on a CPU tensor
    the dispatcher's result is the plain version's, layer after layer."""
    x, _, valid, params = _layer_inputs(7)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    tv = torch.as_tensor(valid)
    out = layers.transformer_apply([tp, tp], torch.as_tensor(x), None, H, compute_dtype=cdt,
                                   mask_spec=(tv, True), fused=fused)
    ref = torch.as_tensor(x)
    for _ in range(2):
        ref = tl.trm_layer_torch(ref, tp, tv, None, n_heads=H, causal=True, bf16=bf16)
    assert torch.equal(out, ref)


def test_transformer_apply_unported_and_invalid_paths_raise():
    x, _, valid, params = _layer_inputs(8)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    args = ([tp], torch.as_tensor(x), None, H)
    spec = (torch.as_tensor(valid), True)
    with pytest.raises(NotImplementedError, match="float32 whole-layer"):
        layers.transformer_apply(*args, mask_spec=spec, fused="layer",
                                 compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mask_spec"):
        layers.transformer_apply(*args, fused="layer2")
    with pytest.raises(ValueError, match="activation"):
        tl.trm_layer(torch.as_tensor(x), tp, spec[0], n_heads=H, causal=True, act="leakyrelu")


# ------------------------------------------- (b'): the attention-only kernel

def _attn_inputs(seed, Ba=8, La=9, Ha=2, hd=8):
    """q, k, v, a cotangent (B, L, H, hd) and ragged key validity with one
    sequence that has no valid key (row 2)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(Ba, La, Ha, hd).astype(np.float32) for _ in range(4))
    lens = rng.randint(1, La + 1, Ba)
    lens[2] = 0
    valid = (np.arange(La)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, do, valid


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_pallas_interpret_and_xla(causal):
    """fused_attention_torch (rate 0) against fused_attention(interpret=True)
    and attention_xla: the output and dq, dk, dv at 1e-5, the JAX test's
    bound. The sequence with no valid key comes out uniform in all three;
    its dq and dk are held against attention_xla only: the Pallas backward
    adds -1e9 and passes a cotangent to masked scores there, where the mask
    is a select in attention_xla and in the port."""
    q, k, v, do, valid = _attn_inputs(20 + causal)
    jv = jnp.asarray(valid)
    fns = {"interpret": lambda q, k, v: jax_attention(q, k, v, jv, jnp.zeros((1,), jnp.int32),
                                                      causal=causal, interpret=True),
           "xla": lambda q, k, v: attention_xla(q, k, v, jv, causal=causal)}
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.fused_attention_torch(tq, tk, tv, torch.as_tensor(valid), causal)
    (out * torch.as_tensor(do)).sum().backward()
    empty = np.arange(q.shape[0]) == 2
    uniform = v[2].mean(axis=0)
    np.testing.assert_allclose(out.detach().numpy()[2], np.broadcast_to(uniform, out.shape[1:]),
                               rtol=1e-5, atol=1e-5)
    for name, fn in fns.items():
        y, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
        for what, t, g in zip("qkv", (tq, tk, tv), vjp(jnp.asarray(do))):
            keep = ~empty if name == "interpret" and what != "v" else slice(None)
            np.testing.assert_allclose(t.grad.numpy()[keep], np.asarray(g)[keep], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} d{what}")


def test_plain_attention_dropout_from_masks_and_generator():
    """Keep masks scale the probabilities (an all-ones mask is no dropout; a
    dropped weight contributes nothing); without masks the dispatcher draws
    them from the generator it is given on a CPU tensor, the same state
    giving the same result, and raises without one."""
    q, k, v, _, valid = _attn_inputs(22)
    args = tuple(torch.as_tensor(a) for a in (q, k, v, valid))
    Ba, La, Ha, _ = q.shape
    base = fa.fused_attention_torch(*args, True)
    assert torch.equal(fa.fused_attention_torch(*args, True, 0.5,
                                                masks=torch.ones(Ba, Ha, La, La)), base)
    drop = torch.ones(Ba, Ha, La, La)
    drop[:, :, :, 0] = 0.0
    got = fa.fused_attention_torch(*args, True, 0.5, masks=drop)
    # query 0 sees key 0 only: dropping it leaves a zero context (but in
    # sequence 2, which has no valid key and attends to all keys uniformly)
    assert float(got[torch.arange(Ba) != 2, 0].abs().max()) == 0.0
    assert float(got[2, 0].abs().max()) > 0.0
    gen = lambda s: torch.Generator().manual_seed(s)
    a = fa.fused_attention(*args, causal=True, rate=0.5, generator=gen(3))
    b = fa.fused_attention(*args, causal=True, rate=0.5, generator=gen(3))
    c = fa.fused_attention(*args, causal=True, rate=0.5, generator=gen(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    masks = tl.plain_dropout_masks(gen(3), Ba, Ha, La, q.shape[-1], 0.5, 0.0, "cpu")["attn"]
    assert torch.equal(a, fa.fused_attention_torch(*args, True, 0.5, masks=masks))
    assert set(masks.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="generator"):
        fa.fused_attention(*args, causal=True, rate=0.5)


def test_transformer_apply_attention_only_path_is_the_plain_path_on_cpu():
    """fused True: q, k, v from the projections through the attention-only
    dispatcher, the rest of the layer as on the plain path; with fp32
    operands and no dropout it equals the plain path, and a bf16 compute
    dtype still runs the attention in fp32."""
    x, dy, valid, params = _layer_inputs(23)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    spec = (torch.as_tensor(valid), True)
    got = layers.transformer_apply([tp, tp], torch.as_tensor(x), None, H, mask_spec=spec,
                                   fused=True)
    ref = layers.transformer_apply([tp, tp], torch.as_tensor(x), None, H, mask_spec=spec,
                                   fused=False)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    bf = layers.transformer_apply([tp], torch.as_tensor(x), None, H, mask_spec=spec,
                                  fused=True, compute_dtype=torch.bfloat16)
    assert bf.dtype == torch.float32 and torch.isfinite(bf).all()
    with pytest.raises(ValueError, match="mask_spec"):
        layers.transformer_apply([tp], torch.as_tensor(x), None, H, fused=True)


# ------------------------------------------------------------- (c): dropout

@pytest.mark.parametrize("bf16", [True, False])
def test_plain_layer_with_explicit_masks(bf16):
    """(c) keep masks as arguments: an all-ones mask is no dropout; a masked
    attention weight, attention-output element or FFN-output element
    contributes nothing (the result equals the one computed with that
    element's upstream value changed); kept elements are scaled by
    1 / (1 - rate); the backward is the gradient of that forward."""
    x, dy, valid, params = _layer_inputs(9)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    tx, tv = torch.as_tensor(x), torch.as_tensor(valid)
    kw = dict(n_heads=H, causal=True, bf16=bf16)
    ones = {"attn": torch.ones(B, H, L, L), "attn_out": torch.ones(B, L, D),
            "ffn": torch.ones(B, L, D)}
    base = tl.trm_layer_torch(tx, tp, tv, None, **kw)
    assert torch.equal(tl.trm_layer_torch(tx, tp, tv, ones, **kw), base)

    gen = torch.Generator().manual_seed(0)
    masks = tl.plain_dropout_masks(gen, B, H, L, D, 0.5, 0.25, "cpu")
    assert set(masks) == {"attn", "attn_out", "ffn"}
    assert set(masks["attn"].unique().tolist()) == {0.0, 2.0}
    assert bool(((masks["ffn"] == 0) | ((masks["ffn"] - 1.0 / 0.75).abs() < 1e-6)).all())
    assert abs(float((masks["attn"] > 0).float().mean()) - 0.5) < 4 * (0.25 / masks["attn"].numel()) ** 0.5
    assert tl.plain_dropout_masks(gen, B, H, L, D, 0.0, 0.0, "cpu") is None

    # scale: with every FFN output kept at 1 / (1 - rate) = 2, the sum that
    # enters LayerNorm 2 is a1 + 2 f2
    o1 = tl._forward_core(tx, tv, tp, None, H, True, "gelu", 1e-12, bf16)
    scaled = dict(ones, ffn=torch.full((B, L, D), 2.0))
    o2 = tl._forward_core(tx, tv, tp, scaled, H, True, "gelu", 1e-12, bf16)
    assert not torch.allclose(o1["y"], o2["y"])
    assert torch.equal(o1["a1"], o2["a1"])
    centred = lambda o: o["xhat2"] / o["inv2"]         # a1 + f2 minus its row mean
    f2 = centred(o1) - (o1["a1"] - o1["a1"].mean(-1, keepdim=True))
    f2_scaled = centred(o2) - (o2["a1"] - o2["a1"].mean(-1, keepdim=True))
    assert torch.allclose(f2_scaled, 2.0 * f2, atol=1e-4)

    # dropped elements contribute nothing
    drop = {k: v.clone() for k, v in ones.items()}
    drop["ffn"][:, 3, :] = 0.0
    drop["attn"][:, :, 5, :] = 0.0
    tdy = torch.as_tensor(dy)
    dx, g = tl.trm_layer_torch_bwd(tx, tp, tv, drop, tdy, H, True, "gelu", 1e-12, bf16)
    o = tl._forward_core(tx, tv, tp, drop, H, True, "gelu", 1e-12, bf16)
    # position 5 attends to nothing, so its context is exactly 0
    assert float(o["ctx"][:, 5].abs().max()) == 0.0
    # position 3's FFN output is dropped: y there is LN2(a1) alone
    ln = tl._ln_fwd(o["a1"], tp["ln2_g"], tp["ln2_b"], 1e-12)[0]
    assert torch.allclose(o["y"][:, 3], ln[:, 3], atol=1e-6)
    assert torch.isfinite(dx).all() and all(torch.isfinite(v).all() for v in g.values())
    if not bf16:
        # with fp32 operands the hand-written backward equals autograd of a
        # forward that applies the same masks
        px = tx.clone().requires_grad_(True)
        pp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        y = tl._forward_core(px, tv, pp, drop, H, True, "gelu", 1e-12, False)["y"]
        (y * tdy).sum().backward()
        _close(dx.numpy(), px.grad.numpy(), 2e-4, "dx")
        gscale = max(float(v.grad.abs().max()) for v in pp.values())
        for k in g:      # bk's true gradient is 0: held to 1e-2 of the largest
            err = float((g[k] - pp[k].grad).abs().max())
            assert err <= 2e-4 * max(float(pp[k].grad.abs().max()), 1e-2 * gscale), k


def test_dispatcher_draws_cpu_masks_from_the_generator():
    """On a CPU tensor the dispatcher draws its masks from the generator it
    is given: the same generator state gives the same result, another state
    another one; without a generator it raises."""
    x, _, valid, params = _layer_inputs(10)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    args = (torch.as_tensor(x), tp, torch.as_tensor(valid))
    kw = dict(n_heads=H, causal=True, dropout=0.5, attn_dropout=0.5, bf16=False)
    a = tl.trm_layer(*args, generator=torch.Generator().manual_seed(3), **kw)
    b = tl.trm_layer(*args, generator=torch.Generator().manual_seed(3), **kw)
    c = tl.trm_layer(*args, generator=torch.Generator().manual_seed(4), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        tl.trm_layer(*args, **kw)


# ------------------------------------------------------- (d): data and loaders

def _seq_cfg(tmp_path, data_path=None, **extra):
    cfg = {"epochs": 2, "train_batch_size": 256, "eval_batch_size": 512,
           "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log"),
           "state": "ERROR", "valid_full_to_uni1000": False, "device": "cpu",
           "MAX_ITEM_LIST_LENGTH": L, "n_layers": 2, "n_heads": H, "hidden_size": D,
           "inner_size": I, **extra}
    if data_path:
        cfg["data_path"] = data_path
    return cfg


@pytest.mark.parametrize("dataset", ["synth", "ml-100k"])
def test_sequential_dataset_loaders_and_transform_match_jax(dataset, synth_dataset_dir,
                                                            tmp_path):
    """(d) splits, the materialised (N, L) train matrix, the eval batches
    and the device transform's sequences, exact."""
    cfg = _seq_cfg(tmp_path, synth_dataset_dir if dataset == "synth" else None)
    jc = JaxConfig("SASRec", dataset, config_dict=cfg, _parse_cmd_line=False)
    pc = Config("SASRec", dataset, config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    for jl, pl in zip(jloaders, ploaders):
        assert type(jl).__name__ == type(pl).__name__
        js, ps = jl.dataset, pl.dataset
        np.testing.assert_array_equal(js.item_stream, ps.item_stream)
        for attr in ("uid", "start", "length", "target"):
            np.testing.assert_array_equal(getattr(js, attr), getattr(ps, attr))
    jtrain, ptrain = jloaders[0], ploaders[0]
    jcols, pcols = jtrain.columns(), ptrain.columns()
    assert set(jcols) == set(pcols) and "seq_start" not in pcols
    for f in jcols:
        np.testing.assert_array_equal(jcols[f], pcols[f], err_msg=f)
    assert pcols["item_id_list"].shape == (ptrain.n, L)
    for phase in ("train", "valid", "test"):
        np.testing.assert_array_equal(jtrain.phase_history.history[phase],
                                      ptrain.phase_history.history[phase])
    for jl, pl in zip(jloaders[1:], ploaders[1:]):
        assert pl.mask_history is False
        assert (jl.batch_size, jl.n, len(jl)) == (pl.batch_size, pl.n, len(pl))
        jconsts = jl.device_transform.consts
        pconsts = pl.device_transform.consts("cpu")
        for jb, pb in zip(jl, pl):
            assert set(jb) == set(pb)
            for k in jb:
                np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
            jt = jl.device_transform({k: jnp.asarray(v) for k, v in jb.items()}, jconsts)
            pt = pl.device_transform({k: torch.as_tensor(v).long() for k, v in pb.items()},
                                     pconsts)
            assert set(jt) == set(pt) and "seq_start" not in pt
            for k in jt:
                np.testing.assert_array_equal(np.asarray(jt[k]), pt[k].numpy(), err_msg=k)
    # the lazy transform builds the rows of the materialised matrix
    raw = dict(ptrain._columns)
    idx = np.arange(min(64, ptrain.n))
    lazy = ptrain.device_transform({k: torch.as_tensor(v[idx]).long() for k, v in raw.items()},
                                   ptrain.device_transform.consts("cpu"))
    np.testing.assert_array_equal(lazy["item_id_list"].numpy(), pcols["item_id_list"][idx])


def test_unported_sequential_paths_raise(synth_dataset_dir, tmp_path):
    cfg = _seq_cfg(tmp_path, synth_dataset_dir)
    pc = Config("SASRec", "synth", config_dict={**cfg, "valid_full_to_uni1000": True},
                _parse_cmd_line=False)
    init_seed(pc["seed"])
    with pytest.raises(NotImplementedError, match="sampled evaluation of sequential"):
        data_preparation(pc, create_dataset(pc))
    pc = Config("SASRec", "synth", config_dict={**cfg, "eval_setting": "RO_RS,full"},
                _parse_cmd_line=False)
    with pytest.raises(ValueError, match="leave-one-out"):
        data_preparation(pc, create_dataset(pc))
    with pytest.raises(ValueError, match="not found"):
        get_model("GRU4RecF")


# --------------------------------------------------- (e): SASRec loss and grads

def _sasrec_pair(synth_dataset_dir, tmp_path, **extra):
    cfg = _seq_cfg(tmp_path, synth_dataset_dir, **extra)
    jc = JaxConfig("SASRec", "synth", config_dict=cfg, _parse_cmd_line=False)
    pc = Config("SASRec", "synth", config_dict=cfg, _parse_cmd_line=False)
    jax_init_seed(jc["seed"])
    jloaders = jax_data_preparation(jc, jax_create_dataset(jc))
    init_seed(pc["seed"])
    ploaders = data_preparation(pc, create_dataset(pc))
    jmodel = jax_get_model("SASRec")(jc, jloaders[0].dataset)
    params = jmodel.init_params(jax.random.key(0))
    # move the zero biases and unit gains off their initial values
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda v: v + 0.05 * rng.randn(*v.shape).astype(np.float32)
                          if v.ndim == 1 else v, params)
    pmodel = get_model("SASRec")(pc, ploaders[0].dataset)
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))
    return jc, pc, jloaders, ploaders, jmodel, params, pmodel


def _train_batch(ptrain, rows, n_items, seed=0):
    cols = ptrain.columns()
    batch = {f: v[rows] for f, v in cols.items()}
    batch["neg_item_id"] = np.random.RandomState(seed).randint(1, n_items, len(rows))
    return batch


@pytest.mark.parametrize("loss_type", ["CE", "BPR"])
@pytest.mark.parametrize("path", ["plain_fp32", "layer2_fp32", "layer2_bf16"])
def test_sasrec_loss_and_gradients_match_jax(synth_dataset_dir, tmp_path, loss_type, path):
    """(e) SASRec.calculate_loss and its gradients, dropout off. The fp32
    paths (the non-fused one, and layer2 under compute_dtype float32) against
    the JAX model with fused_attention False in fp32, at rtol 2e-4 of each
    leaf's largest value; layer2 with bf16 operands against the JAX model
    under compute_dtype bfloat16, at the stated bf16 bound."""
    port = {"plain_fp32": {"fused_attention": False, "compute_dtype": "float32"},
            "layer2_fp32": {"fused_attention": "layer2", "compute_dtype": "float32"},
            "layer2_bf16": {"fused_attention": "layer2", "compute_dtype": "bfloat16"}}[path]
    extra = {"loss_type": loss_type,
             "training_neg_sample_num": 1 if loss_type == "BPR" else 0}
    _, pc, _, ploaders, jmodel, params, pmodel = _sasrec_pair(
        synth_dataset_dir, tmp_path, fused_attention=False,
        compute_dtype="bfloat16" if path == "layer2_bf16" else "float32", **extra)
    pmodel2 = get_model("SASRec")(Config("SASRec", "synth", _parse_cmd_line=False,
                                         config_dict={**pc.final, **port}),
                                  ploaders[0].dataset)
    load_jax_params(pmodel2, jax.tree.map(np.asarray, params))
    assert pmodel2.cdt == (torch.bfloat16 if path == "layer2_bf16" else None)
    batch = _train_batch(ploaders[0], np.arange(96), pmodel2.n_items)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jbatch))(params)
    tbatch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    loss = pmodel2.calculate_loss(tbatch)
    loss.backward()
    tol = BF16_XLA_TOL if path == "layer2_bf16" else 2e-4
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    gscale = max(float(np.abs(v).max()) for v in ref.values())
    floor = BF16_XLA_FLOOR if path == "layer2_bf16" else 1e-2
    for name, p in pmodel2.named_parameters():
        denom = max(float(np.abs(ref[name]).max()), floor * gscale)
        err = float(np.abs(p.grad.numpy() - ref[name]).max()) / denom
        assert err <= tol, (name, err)
    with torch.no_grad():
        _close(pmodel2.full_sort_predict(tbatch).numpy(),
               np.asarray(jmodel.full_sort_predict(params, jbatch)), tol, "full_sort_predict")
        _close(pmodel2.predict(tbatch).numpy(),
               np.asarray(jmodel.predict(params, jbatch)), tol, "predict")


@pytest.mark.parametrize("loss_type", ["CE", "BPR"])
def test_sasrec_attention_only_loss_and_gradients_match_jax(synth_dataset_dir, tmp_path,
                                                            loss_type):
    """(e) SASRec with fused_attention True under compute_dtype float32, in
    both packages (the JAX model takes its XLA attention on the CPU, the
    same fp32 function as its kernel): loss and every leaf's gradient at
    rtol 2e-4 of the leaf's largest value, dropout off."""
    extra = {"loss_type": loss_type, "training_neg_sample_num": 1 if loss_type == "BPR" else 0,
             "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0}
    _, _, _, ploaders, jmodel, params, pmodel = _sasrec_pair(
        synth_dataset_dir, tmp_path, fused_attention=True, compute_dtype="float32", **extra)
    assert pmodel.config["fused_attention"] is True and pmodel.cdt is None
    batch = _train_batch(ploaders[0], np.arange(96), pmodel.n_items)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jbatch))(params)
    loss = pmodel.calculate_loss({k: torch.as_tensor(v).long() for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    ref = flatten_tree(jax.tree.map(np.asarray, jgrads))
    gscale = max(float(np.abs(v).max()) for v in ref.values())
    for name, p in pmodel.named_parameters():
        denom = max(float(np.abs(ref[name]).max()), 1e-2 * gscale)
        err = float(np.abs(p.grad.numpy() - ref[name]).max()) / denom
        assert err <= 2e-4, (name, err)


def test_sasrec_init_and_compute_dtype_rule(synth_dataset_dir, tmp_path):
    """The port's own initialisation: [PAD] row zero, normal(0.02) tables,
    xavier-uniform encoder weights, names equal to the JAX tree's paths;
    compute_dtype auto is bfloat16 for the family, float32 opts out."""
    _, pc, _, ploaders, _, params, pmodel = _sasrec_pair(synth_dataset_dir, tmp_path)
    assert set(dict(pmodel.named_parameters())) == set(flatten_tree(params))
    fresh = get_model("SASRec")(pc, ploaders[0].dataset)
    assert pc["compute_dtype"] == "auto" and fresh.cdt == torch.bfloat16
    assert torch.count_nonzero(fresh.item_embedding[0]) == 0
    assert abs(float(fresh.item_embedding[1:].std()) - 0.02) < 4e-3
    lim = np.sqrt(6.0 / (D + I))
    w = dict(fresh.named_parameters())["encoder.1.ff1_w"]
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.8 * lim
    assert len(export_params(fresh)["encoder"]) == 2
    assert len(export_params(fresh)["encoder"][0]) == 16
    f32 = get_model("SASRec")(Config("SASRec", "synth", _parse_cmd_line=False, config_dict={
        **pc.final, "compute_dtype": "float32"}), ploaders[0].dataset)
    assert f32.cdt is None and f32.compute_dtype == torch.float32


# ------------------------------------------------------ (f): trainer and eval

@pytest.mark.parametrize("loss_type", ["CE", "BPR"])
def test_sasrec_five_steps_and_full_sort_metrics_match_jax(synth_dataset_dir, tmp_path,
                                                           loss_type):
    """(f) five steps on the same rows (dropout off, negatives injected,
    fp32, the whole-layer path in the port against the JAX model's plain
    path): loss at rtol 2e-4, parameters at rtol 2e-4 / atol 2e-5 for at
    least 99.5% of every leaf's elements and every element within 2.5e-4 (a
    quarter of one Adam step at lr 1e-3: where a gradient element is a
    cancelling sum near zero, Adam's normalised update turns the two
    packages' fp32 sum orders into steps that differ by a fraction of lr).
    The key biases are the extreme of that: their true gradient is 0 (a
    softmax does not see a constant added to every key's score), so each
    package steps them by its own rounding noise, normalised to about lr a
    step; they are held within 5 steps of lr. Row 0 of item_embedding stays exactly zero. Then full-sort metrics on
    the valid and test splits from the same weights agree within 1e-6."""
    extra = {"loss_type": loss_type, "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0,
             "training_neg_sample_num": 1 if loss_type == "BPR" else 0,
             "compute_dtype": "float32"}
    jc, pc, jloaders, ploaders, jmodel, params, _ = _sasrec_pair(
        synth_dataset_dir, tmp_path, fused_attention=False, **extra)
    pc = Config("SASRec", "synth", _parse_cmd_line=False,
                config_dict={**pc.final, "fused_attention": "layer2"})
    pmodel = get_model("SASRec")(pc, ploaders[0].dataset)
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))
    assert get_trainer(pc["MODEL_TYPE"], "SASRec") is Trainer
    jtrainer, ptrainer = JaxTrainer(jc, jmodel), Trainer(pc, pmodel)
    jtrain, ptrain = jloaders[0], ploaders[0]

    jtrainer._fused_adam = True
    opt_state = jtrainer._fused_adam_init(params)
    ident = lambda batch, rng, consts: batch
    jstep = jtrainer._make_step_core(ident, jmodel.calculate_loss)
    ptrainer.opt_state = ptrainer._fused_adam_init()
    pstep = ptrainer._make_step_core(ident, pmodel.calculate_loss)
    key = jax.random.key(1)
    for step in range(5):
        batch = _train_batch(ptrain, np.arange(step * 128, (step + 1) * 128),
                             pmodel.n_items, seed=step)
        params, opt_state, key, jloss, _ = jstep(
            params, opt_state, key, {k: jnp.asarray(v) for k, v in batch.items()}, {})
        ploss = pstep({k: torch.as_tensor(v).long() for k, v in batch.items()}, {})
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-4)
        assert not pmodel.training
    got = flatten_tree(export_params(pmodel))
    for name, ref in flatten_tree(jax.tree.map(np.asarray, params)).items():
        diff = np.abs(got[name] - ref)
        if name.endswith(".bk"):
            assert diff.max() <= 5 * 1e-3 * (1 + 1e-3), (name, diff.max())
            continue
        assert np.mean(diff <= 2e-5 + 2e-4 * np.abs(ref)) >= 0.995, name
        assert diff.max() <= 2.5e-4, (name, diff.max())
    assert float(np.abs(got["item_embedding"][0]).max()) == 0.0
    assert float(ptrainer.opt_state["mu"]["item_embedding"][0].abs().max()) == 0.0

    jtrainer.params = params
    load_jax_params(pmodel, jax.tree.map(np.asarray, params))
    for jdata, pdata in zip(jloaders[1:], ploaders[1:]):
        jres = jtrainer.evaluate(jdata, load_best_model=False)
        pres = ptrainer.evaluate(pdata, load_best_model=False)
        assert set(jres) == set(pres)
        for k in jres:
            assert abs(jres[k] - pres[k]) <= 1e-6, (k, jres[k], pres[k])


def test_eval_mask_of_a_sequential_split_holds_only_pad(synth_dataset_dir, tmp_path):
    """With mask_history False only [PAD] is masked, as the JAX fused eval
    step does (trainer.py:984-985); a general split still masks history."""
    users = torch.tensor([1, 2, 3])
    got = invalid_item_mask(users, None, None, 7)
    assert got.dtype == torch.int8 and got.tolist() == [[1, 0, 0, 0, 0, 0, 0]] * 3
    _, pc, _, ploaders, _, _, pmodel = _sasrec_pair(synth_dataset_dir, tmp_path)
    trainer = Trainer(pc, pmodel)
    _, consts = trainer._make_full_sort_eval_step(ploaders[1], ("recall",), 10)
    assert consts["hist"] is None and "item_stream" in consts


@pytest.mark.parametrize("k", [1, 3])
def test_sequential_augment_samples_repeatable_negatives(synth_dataset_dir, tmp_path, k):
    """The BPR branch for a sequential model: the device transform runs,
    then k negatives per row drawn without exclusion from 1..n_items-1."""
    _, pc, _, ploaders, _, _, _ = _sasrec_pair(
        synth_dataset_dir, tmp_path, loss_type="BPR", training_neg_sample_num=k)
    pmodel = get_model("SASRec")(pc, ploaders[0].dataset)
    trainer = Trainer(pc, pmodel)
    augment, consts = trainer._make_rec_augment(ploaders[0])
    assert "hist" not in consts and "item_stream" in consts
    tables = trainer._upload_table(ploaders[0].columns())
    batch = trainer._take_batch(tables, torch.arange(50))
    out = augment(batch, trainer.generator, consts)
    assert out["neg_item_id"].shape == (50 * k,)
    assert out["item_id_list"].shape == (50 * k, L)
    assert int(out["neg_item_id"].min()) >= 1 and int(out["neg_item_id"].max()) < pmodel.n_items
    assert torch.equal(out["item_id"], batch["item_id"].repeat_interleave(k))


# ------------------------------------------------------------ (g): end to end

@pytest.mark.parametrize("extra", [
    {}, {"loss_type": "BPR", "training_neg_sample_num": 1},
    {"fused_attention": "layer", "compute_dtype": "float32"},
    {"fused_attention": False}, {"fused_attention": True}],
    ids=["CE-layer2-bf16", "BPR", "layer-fp32", "plain-bf16", "attention-only-bf16"])
def test_sasrec_end_to_end_on_cpu(synth_dataset_dir, tmp_path, extra):
    """(g) run_recbole(model="SASRec", device="cpu") on the synthetic
    dataset, dropout on (the defaults)."""
    result = run_recbole(model="SASRec", dataset="synth", config_dict=_seq_cfg(
        tmp_path, synth_dataset_dir, **extra), saved=True)
    tr = result["test_result"]
    assert set(tr) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(0.0 <= v <= 1.0 for v in tr.values())
    assert set(result["best_valid_result"]) == set(tr)


def test_sasrec_resume_matches_straight_run(synth_dataset_dir, tmp_path):
    """(g) with dropout on: two epochs, a checkpoint and two more equal four
    epochs straight, parameters, moments and loss curve."""
    def pipeline(sub, **extra):
        pc = Config("SASRec", "synth", _parse_cmd_line=False,
                    config_dict=_seq_cfg(tmp_path / sub, synth_dataset_dir, **extra))
        init_seed(pc["seed"])
        train, _, _ = data_preparation(pc, create_dataset(pc))
        model = get_model("SASRec")(pc, train.dataset)
        return Trainer(pc, model), model, train

    straight, smodel, strain = pipeline("a", epochs=4)
    assert smodel.hidden_dropout_prob == 0.5
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


@pytest.mark.parametrize("shape", [(200, 64, 256), (50, 128, 256)], ids=["L200", "D128"])
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_layer2_routes_shapes_beyond_one_block_to_the_attention_path(shape, cdt):
    """L 200 at D 64 and D 128 at L 50 (inner 256) do not fit the whole-layer
    kernel's block (the Python copy of its shared-memory formula says so
    before any launch): fused_attention "layer2" (and "layer" in fp32)
    builds the layer as fused_attention True does, at the same compute
    dtype. Two layers, output and gradients against the JAX package's
    transformer_apply with fused "layer2" (which takes XLA off a TPU) at
    rtol 2e-4 (fp32) or BF16_XLA_TOL (bf16)."""
    Lr, Dr, Ir = shape
    Br, Hr = 2, 2
    assert tl.layer_route(Lr, Dr, Ir) == "attention"
    assert 4 * tl.smem_floats(Lr, Dr, Ir, True) > tl.MAX_SMEM_BYTES
    rng = np.random.RandomState(Lr + Dr)
    layers_p = jax.tree.map(np.asarray, jax_layers.transformer_init(
        jax.random.key(Lr), 2, Hr, Dr, Ir))
    for p in layers_p:
        for k, v in p.items():
            if v.ndim == 1:
                p[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    x = (0.5 * rng.randn(Br, Lr, Dr)).astype(np.float32)
    dy = rng.randn(Br, Lr, Dr).astype(np.float32)
    valid = (np.arange(Lr)[None, :] < np.array([Lr, Lr // 3])[:, None]).astype(np.int32)
    jcdt = None if cdt is None else jnp.bfloat16
    tcdt = None if cdt is None else torch.bfloat16

    def jfn(p, x):
        return jax_layers.transformer_apply(p, x, None, Hr, act="gelu", compute_dtype=jcdt,
                                            mask_spec=(jnp.asarray(valid), True),
                                            fused="layer2")

    y = jfn(layers_p, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, x: jnp.sum(jfn(p, x) * dy), argnums=(0, 1))(layers_p,
                                                                          jnp.asarray(x))
    paths = ("layer2", True) + (("layer",) if cdt is None else ())
    outs = {}
    for fused in paths:
        tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in layers_p]
        tx = torch.tensor(x, requires_grad=True)
        out = layers.transformer_apply(tp, tx, None, Hr, act="gelu", compute_dtype=tcdt,
                                       mask_spec=(torch.as_tensor(valid), True), fused=fused)
        (out * torch.as_tensor(dy)).sum().backward()
        outs[fused] = (out.detach(), tx.grad, [{k: v.grad for k, v in p.items()} for p in tp])
    for fused in paths:
        assert torch.equal(outs[fused][0], outs[True][0]), fused
        assert torch.equal(outs[fused][1], outs[True][1]), fused
    tol = 2e-4 if cdt is None else BF16_XLA_TOL
    out, gxt, gpt = outs["layer2"]
    _close(out.numpy(), np.asarray(y), tol, "y")
    _close(gxt.numpy(), np.asarray(gx), tol, "dx")
    gscale = max(float(np.abs(np.asarray(v)).max()) for p in gp for v in p.values())
    floor = 1e-3 if cdt is None else BF16_XLA_FLOOR
    for li, (got, ref) in enumerate(zip(gpt, gp)):
        for k in tl.PARAM_KEYS:
            r = np.asarray(ref[k])
            err = float(np.abs(got[k].numpy() - r).max()) / max(float(np.abs(r).max()),
                                                                floor * gscale)
            assert err <= tol, (li, k, err)


def test_sasrec_logs_its_layer_route(synth_dataset_dir, tmp_path):
    """SASRec says once, at build, which path the whole-layer setting takes
    at its shape: the kernel at L 8, the attention path at L 128 (where the
    whole layer at D 16, inner 32 needs more than a block's shared memory).
    The port's logger does not propagate (init_logger), so the test listens
    on it directly."""
    import logging
    assert tl.layer_route(128, D, I) == "attention" and tl.layer_route(8, D, I) == "layer"

    class Grab(logging.Handler):
        def emit(self, record):
            said.append(record.getMessage())

    logger = logging.getLogger("recbole_tpu_torch")
    grab, level = Grab(), logger.level
    for max_len, path in ((8, "whole-layer kernel"), (128, "attention kernel")):
        cfg = _seq_cfg(tmp_path, synth_dataset_dir, MAX_ITEM_LIST_LENGTH=max_len)
        pc = Config("SASRec", "synth", config_dict=cfg, _parse_cmd_line=False)
        init_seed(pc["seed"])
        train = data_preparation(pc, create_dataset(pc))[0]
        said = []
        logger.addHandler(grab)
        logger.setLevel(logging.INFO)
        try:
            get_model("SASRec")(pc, train.dataset)
        finally:
            logger.removeHandler(grab)
            logger.setLevel(level)
        said = [m for m in said if "fused_attention" in m]
        assert len(said) == 1 and path in said[0] and f"L={max_len}" in said[0], said
