"""Shared layers.

Port of recbole_tpu/models/layers.py's ``xavier_normal``, ``xavier_uniform``,
``normal_init``, ``embedding_init`` (row 0 zeroed, :71-74), ``embed``,
``cast_compute``/``dot_c`` (:84-101), ``activation`` (:106-116), ``bn_apply``
(:119-134), the MLP (``mlp_init``/``mlp_apply``, :137-176, as the module
``MLPLayers``), ``dropout_apply`` (:179-194), ``fm_pairwise`` (:199-207),
the GRU (``gru_init`` :212 as the module ``GRU``, ``gru_apply`` :228-283),
the transformer encoder (``transformer_init`` :288 as the module
``TransformerEncoder``, ``layer_norm`` :310, ``transformer_apply`` :316-467)
and the attention-mask helpers (:470-490).
Randomness comes from an explicit torch.Generator on the tensor's device,
never from the global RNG. Linear weights keep the JAX package's (in, out)
layout, so ``x @ w + b`` is the same expression in both packages.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def xavier_normal(generator, shape, device, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=generator, device=device,
                             dtype=dtype)


def xavier_uniform(generator, shape, device, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return (2.0 * u - 1.0) * limit


def normal_init(generator, shape, device, std=0.01, dtype=torch.float32):
    return std * torch.randn(shape, generator=generator, device=device, dtype=dtype)


def embedding_init(generator, num, dim, device, dtype=torch.float32):
    table = xavier_normal(generator, (num, dim), device, dtype)
    # row 0 is [PAD]; zero it so padded lookups contribute nothing
    table[0] = 0.0
    return table


def embed(table, ids):
    """Gather rows; the gradient is a dense (V, D) index-add."""
    return torch.index_select(table, 0, ids)


# ---------------------------------------------------------- mixed precision

def cast_compute(compute_dtype, *tensors):
    """Round matmul operands to the compute dtype. Parameters stay float32
    in memory; ``None`` and float32 leave the tensors as they are."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(compute_dtype) for t in tensors)
    return out if len(out) > 1 else out[0]


def dot_c(x, w, compute_dtype=None):
    """``x @ w`` with both operands rounded to the compute dtype and a
    float32 result, as ``jnp.dot(..., preferred_element_type=float32)``
    gives. ``torch.matmul`` of two bfloat16 tensors returns bfloat16, so the
    rounded operands go back to float32 and the product runs in float32:
    every bf16 x bf16 term is then exact and the sum is float32."""
    x, w = cast_compute(compute_dtype, x, w)
    return x.to(torch.float32) @ w.to(torch.float32)


# ------------------------------------------------------------------------ MLP

def activation(name):
    if callable(name):
        return name
    return {
        "sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "leakyrelu": F.leaky_relu,
        # exact erf gelu, as the reference's layers.gelu (layers.py:283)
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "swish": F.silu, "none": lambda x: x, None: lambda x: x,
    }[name if name is None else name.lower()]


def bn_apply(x, g, b, w=None, eps=1e-5):
    """Batch normalization over dim 0 with BATCH statistics, in eval mode
    too, as the JAX package does (its documented deviation from the
    reference's running averages). ``w`` masks rows out of the statistics."""
    if w is None:
        mean = torch.mean(x, 0)
        var = torch.var(x, 0, unbiased=False)
    else:
        wc = w[:, None]
        n = torch.clamp(torch.sum(w), min=1.0)
        mean = torch.sum(x * wc, 0) / n
        var = torch.sum(((x - mean) ** 2) * wc, 0) / n
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def dropout_apply(generator, x, rate):
    """Inverted dropout whose mask comes from ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _Dense(nn.Module):
    def __init__(self, generator, in_dim, out_dim, device, bn, init=xavier_normal):
        super().__init__()
        self.w = nn.Parameter(init(generator, (in_dim, out_dim), device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))
        if bn:
            self.bn_g = nn.Parameter(torch.ones(out_dim, device=device))
            self.bn_b = nn.Parameter(torch.zeros(out_dim, device=device))


class MLPLayers(nn.ModuleList):
    """parity: MLPLayers (reference layers.py:30), xavier-normal weights
    (``init``: another initializer of this module, as ``mlp_init``'s
    ``init`` names one) and zero biases. Layer i's parameters are named ``<i>.w`` and ``<i>.b``
    (``<i>.bn_g``/``<i>.bn_b`` with ``bn=True``), the paths of the JAX
    package's list of layer dicts. Per layer: dropout -> linear ->
    [batch norm] -> activation. Dropout is applied only in train mode and
    only when a generator is given."""

    def __init__(self, generator, layer_dims, device, act="relu", dropout=0.0,
                 bn=False, final_act=True, init=xavier_normal):
        super().__init__(_Dense(generator, layer_dims[i], layer_dims[i + 1], device, bn, init)
                         for i in range(len(layer_dims) - 1))
        self.act = activation(act)
        self.dropout = float(dropout)
        self.final_act = final_act

    def forward(self, x, generator=None, bn_w=None):
        n = len(self)
        for i, layer in enumerate(self):
            if self.dropout > 0.0 and self.training and generator is not None:
                x = dropout_apply(generator, x, self.dropout)
            x = x @ layer.w + layer.b
            if hasattr(layer, "bn_g"):
                x = bn_apply(x, layer.bn_g, layer.bn_b, w=bn_w)
            if self.final_act or i < n - 1:
                x = self.act(x)
        return x


# ------------------------------------------------------------ factorization

def fm_pairwise(emb):
    """Second-order FM interaction 0.5 * ((sum v)^2 - sum v^2), summed over
    the embedding dim (parity: BaseFactorizationMachine, layers.py:147).
    emb (B, F, D) -> (B,)."""
    sum_sq = torch.square(torch.sum(emb, dim=1))
    sq_sum = torch.sum(torch.square(emb), dim=1)
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=-1)


# ------------------------------------------------------------------------ GRU

class _GRULayer(nn.Module):
    """The 4 leaves of one GRU layer, under the JAX param dict's names."""

    def __init__(self, generator, in_dim, hidden, device):
        super().__init__()
        # gru_init's draw order: wi, then wh
        self.wi = nn.Parameter(xavier_uniform(generator, (in_dim, 3 * hidden), device))
        self.wh = nn.Parameter(xavier_uniform(generator, (hidden, 3 * hidden), device))
        self.bi = nn.Parameter(torch.zeros(3 * hidden, device=device))
        self.bh = nn.Parameter(torch.zeros(3 * hidden, device=device))


class GRU(nn.ModuleList):
    """parity: ``gru_init`` (JAX layers.py:212-225), the reference's nn.GRU
    with gates ordered r, z, n: xavier-uniform weights and zero biases,
    (in, out) layout. Layer i's parameters are named ``<i>.wi``, ``<i>.wh``,
    ``<i>.bi``, ``<i>.bh``, the paths of the JAX package's list of layer
    dicts."""

    def __init__(self, generator, input_size, hidden_size, n_layers, device):
        super().__init__(_GRULayer(generator, input_size if i == 0 else hidden_size,
                                   hidden_size, device) for i in range(n_layers))


def gru_apply(gru, x, h0=None, compute_dtype=None):
    """x (B, L, D) -> the last layer's outputs (B, L, H), in the compute
    dtype (float32 when it is None). Per layer the input projection
    ``xi = x @ wi + bi`` is one plain product, as the JAX package leaves it
    to XLA, and the recurrence goes through ``ops/fused_gru.py``: under a
    bfloat16 compute dtype ``xi`` is stored in bfloat16 and the bf16
    instance rounds as ``gru_apply``'s scan does (JAX :265-278); otherwise
    the fp32 instance. The JAX package's ``fused=`` argument, which no
    caller passes, is gone: the device picks the path (the plain version on
    the CPU, the hand-written kernels on CUDA, nothing falling back)."""
    from ..ops.fused_gru import fused_gru
    bf16 = compute_dtype is not None and compute_dtype != torch.float32
    B = x.shape[0]
    for layer in gru:
        H = layer.wh.shape[0]
        h_init = (torch.zeros((B, H), dtype=torch.float32, device=x.device) if h0 is None
                  else h0.to(torch.float32))
        xi = dot_c(x, layer.wi, compute_dtype) + layer.bi
        if bf16:
            xi = xi.to(compute_dtype)
        x = fused_gru(xi, h_init, layer.wh, layer.bh)
    return x


# --------------------------------------------------------------- transformer

TRANSFORMER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
                    "ln1_g", "ln1_b", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
                    "ln2_g", "ln2_b")


class _TransformerLayer(nn.Module):
    """The 16 leaves of one layer, under the JAX param dict's names."""

    def __init__(self, generator, hidden, inner, device):
        super().__init__()

        def xu(*shape):
            return nn.Parameter(xavier_uniform(generator, shape, device))

        def const(n, value):
            return nn.Parameter(torch.full((n,), value, device=device))

        # weights in transformer_init's draw order
        self.wq, self.wk, self.wv, self.wo = (xu(hidden, hidden) for _ in range(4))
        self.bq, self.bk, self.bv, self.bo = (const(hidden, 0.0) for _ in range(4))
        self.ln1_g, self.ln1_b = const(hidden, 1.0), const(hidden, 0.0)
        self.ln2_g, self.ln2_b = const(hidden, 1.0), const(hidden, 0.0)
        self.ff1_w, self.ff1_b = xu(hidden, inner), const(inner, 0.0)
        self.ff2_w, self.ff2_b = xu(inner, hidden), const(hidden, 0.0)

    def leaves(self):
        return {k: getattr(self, k) for k in TRANSFORMER_KEYS}


class TransformerEncoder(nn.ModuleList):
    """parity: TransformerEncoder (reference layers.py:499) as
    ``transformer_init`` builds it: xavier-uniform weights, zero biases, unit
    LayerNorm gains. Layer i's parameters are named ``<i>.wq`` ...
    ``<i>.ln2_b``, the paths of the JAX package's list of layer dicts."""

    def __init__(self, generator, n_layers, n_heads, hidden, inner, device):
        super().__init__(_TransformerLayer(generator, hidden, inner, device)
                         for _ in range(n_layers))
        self.n_heads = n_heads

    def layer_params(self):
        return [layer.leaves() for layer in self]


def layer_norm(x, g, b, eps=1e-12):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def transformer_apply(params, x, attn_mask, n_heads, act="gelu", dropout=0.0,
                      attn_dropout=0.0, generator=None, compute_dtype=None,
                      mask_spec=None, fused=False):
    """x (B, L, D); params a list of layer dicts (``TransformerEncoder
    .layer_params()``); attn_mask (B, 1, L, L) additive, or None with
    ``mask_spec=(key_valid (B, L), causal)``. Post-LN residual blocks as the
    reference TransformerLayer (layers.py:469). Dropout is applied when a
    generator is given and a rate is positive.

    ``fused`` chooses the path (the config key ``fused_attention``):

    * ``"layer2"``: every layer through the whole-layer kernel
      (ops/trm_layer.py), its operands rounded to bfloat16 when
      ``compute_dtype`` is bfloat16 and kept float32 when it is None or
      float32. (The JAX package's layer2 path runs bf16 whatever
      ``compute_dtype`` says; the port honours the key.)
    * ``"layer"``: the float32 instance (ops/fused_transformer.py). Under
      a bfloat16 ``compute_dtype`` it takes the ``True`` path below, as the
      JAX package does: its whole-layer branch runs only without a compute
      dtype (JAX :361), and any truthy ``fused`` then reaches its
      attention-kernel branch (:390-394).

      For both, a shape whose whole layer does not fit one block, or whose
      hidden size, head width or inner size is not a multiple of 4
      (``trm_layer.layer_route`` from L, D, the inner size and the heads,
      decided before any launch), and an activation outside the kernel's
      five (``trm_layer.ACTS``) take the ``True`` path below instead, at
      the same compute dtype, as the JAX package takes another path when its
      kernel's support check fails (JAX :335-345, :384-394).
    * ``True``: the plain path below with its attention (mask, softmax,
      attention dropout, ``@ v``) through the attention-only kernel
      (ops/fused_attention.py, JAX :390-423): q, k, v are float32
      ``dot_c(x, w) + b`` reshaped to (B, L, H, hd), the kernel's context
      goes through ``wo``, the hidden dropout, add & LayerNorm and the FFN
      with ``compute_dtype`` honoured. Each layer's dropout stream is the
      Philox layer counter under one seed drawn per call.
    * ``False``: the plain path below, the kernels' oracle.

    On a CUDA tensor a fused path launches its kernel or raises; nothing
    falls back to the plain path."""
    fn = activation(act)
    dropping = generator is not None and (dropout > 0.0 or attn_dropout > 0.0)
    bf16 = compute_dtype is not None and compute_dtype != torch.float32
    if fused in ("layer2", "layer"):
        if mask_spec is None or callable(act):
            raise ValueError(f"fused_attention: {fused!r} needs mask_spec=(key_valid, "
                             "causal) and a named activation")
        from ..ops.trm_layer import ACTS, draw_seed, layer_route, trm_layer
        B, L, D = x.shape
        if (fused == "layer" and bf16) or str(act).lower() not in ACTS or (
                params and layer_route(L, D, params[0]["ff1_w"].shape[1],
                                       n_heads) == "attention"):
            fused = True
    if fused in ("layer2", "layer"):
        key_valid, causal = mask_spec
        seed = None
        if dropping and x.device.type != "cpu":
            seed = draw_seed(generator, x.device)
        for li, layer in enumerate(params):
            x = trm_layer(x, layer, key_valid, n_heads=n_heads, causal=causal,
                          act=str(act).lower(), dropout=dropout if dropping else 0.0,
                          attn_dropout=attn_dropout if dropping else 0.0, seed=seed,
                          generator=generator, layer=li, bf16=bf16)
        return x
    if fused is True:
        if mask_spec is None:
            raise ValueError("fused_attention: True needs mask_spec=(key_valid, causal)")
        from ..ops.fused_attention import fused_attention
        from ..ops.trm_layer import draw_seed
        key_valid, causal = mask_spec
        attn_rate = attn_dropout if generator is not None else 0.0
        seed = None
        if attn_rate > 0.0 and x.device.type != "cpu":
            seed = draw_seed(generator, x.device)
    elif fused:
        raise ValueError(f"fused_attention: {fused!r} is not a path; the port has "
                         '"layer2", "layer", True and False')
    elif attn_mask is None:
        key_valid, causal = mask_spec
        attn_mask = (causal_attention_mask_from_valid(key_valid) if causal
                     else bidirectional_attention_mask(key_valid > 0))
    for li, layer in enumerate(params):
        B, L, D = x.shape
        hd = D // n_heads

        def proj(w, b):
            return (dot_c(x, w, compute_dtype) + b).reshape(B, L, n_heads, hd)

        q = proj(layer["wq"], layer["bq"])
        k = proj(layer["wk"], layer["bk"])
        v = proj(layer["wv"], layer["bv"])
        if fused is True:
            ctx = fused_attention(q, k, v, key_valid, causal=causal, rate=attn_rate, seed=seed,
                                  generator=generator, layer=li).reshape(B, L, D)
        else:
            q, k = cast_compute(compute_dtype, q, k)
            scores = torch.einsum("blhd,bmhd->bhlm", q.to(torch.float32),
                                  k.to(torch.float32)) / math.sqrt(hd)
            scores = scores + attn_mask
            probs = torch.softmax(scores, dim=-1)
            if dropping and attn_dropout > 0.0:
                probs = dropout_apply(generator, probs, attn_dropout)
            probs, v = cast_compute(compute_dtype, probs, v)
            ctx = torch.einsum("bhlm,bmhd->blhd", probs.to(torch.float32),
                               v.to(torch.float32)).reshape(B, L, D)
        attn_out = dot_c(ctx, layer["wo"], compute_dtype) + layer["bo"]
        if dropping and dropout > 0.0:
            attn_out = dropout_apply(generator, attn_out, dropout)
        x = layer_norm(x + attn_out, layer["ln1_g"], layer["ln1_b"])

        h_in = dot_c(x, layer["ff1_w"], compute_dtype) + layer["ff1_b"]
        if bf16:
            # the activation runs in the compute dtype, as in the JAX package
            h_in = h_in.to(compute_dtype)
        h = dot_c(fn(h_in), layer["ff2_w"], compute_dtype) + layer["ff2_b"]
        if dropping and dropout > 0.0:
            h = dropout_apply(generator, h, dropout)
        x = layer_norm(x + h, layer["ln2_g"], layer["ln2_b"])
    return x


def causal_attention_mask(seq_len_1d, L):
    """(B, 1, L, L) additive mask: causal AND key padding (parity: SASRec
    get_attention_mask, sasrec.py:92-106)."""
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=seq_len_1d.device))
    key_valid = torch.arange(L, device=seq_len_1d.device)[None, :] < seq_len_1d[:, None]
    mask = causal[None, :, :] & key_valid[:, None, :]
    return torch.where(mask, 0.0, -1e9)[:, None, :, :]


def causal_attention_mask_from_valid(key_valid):
    """The same from a (B, L) validity mask."""
    L = key_valid.shape[1]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=key_valid.device))
    mask = causal[None, :, :] & (key_valid[:, None, :] > 0)
    return torch.where(mask, 0.0, -1e9)[:, None, :, :]


def bidirectional_attention_mask(seq_valid):
    """(B, 1, L, L) additive mask from a (B, L) bool validity mask
    (BERT4Rec style)."""
    mask = seq_valid[:, None, :] & seq_valid[:, :, None]
    return torch.where(mask, 0.0, -1e9)[:, None, :, :]
