"""Shared layers.

Port of recbole_tpu/models/layers.py's ``xavier_normal``, ``embedding_init``
(row 0 zeroed, :71-74), ``embed``, ``activation`` (:106-116), ``bn_apply``
(:119-134), the MLP (``mlp_init``/``mlp_apply``, :137-176, as the module
``MLPLayers``), ``dropout_apply`` (:179-194) and ``fm_pairwise`` (:199-207).
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


def embedding_init(generator, num, dim, device, dtype=torch.float32):
    table = xavier_normal(generator, (num, dim), device, dtype)
    # row 0 is [PAD]; zero it so padded lookups contribute nothing
    table[0] = 0.0
    return table


def embed(table, ids):
    """Gather rows; the gradient is a dense (V, D) index-add."""
    return torch.index_select(table, 0, ids)


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
    def __init__(self, generator, in_dim, out_dim, device, bn):
        super().__init__()
        self.w = nn.Parameter(xavier_normal(generator, (in_dim, out_dim), device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))
        if bn:
            self.bn_g = nn.Parameter(torch.ones(out_dim, device=device))
            self.bn_b = nn.Parameter(torch.zeros(out_dim, device=device))


class MLPLayers(nn.ModuleList):
    """parity: MLPLayers (reference layers.py:30), xavier-normal weights and
    zero biases. Layer i's parameters are named ``<i>.w`` and ``<i>.b``
    (``<i>.bn_g``/``<i>.bn_b`` with ``bn=True``), the paths of the JAX
    package's list of layer dicts. Per layer: dropout -> linear ->
    [batch norm] -> activation. Dropout is applied only in train mode and
    only when a generator is given."""

    def __init__(self, generator, layer_dims, device, act="relu", dropout=0.0,
                 bn=False, final_act=True):
        super().__init__(_Dense(generator, layer_dims[i], layer_dims[i + 1], device, bn)
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
