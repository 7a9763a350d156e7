"""The whole-layer transformer kernel with fp32 operands.

Port of recbole_tpu/ops/fused_transformer.py::fused_transformer_layer (:409).
The JAX package wrote this layer twice, once with fp32 operands (this
module's counterpart) and once with bf16 operands (ops/trm_layer.py), with
one signature. The port has one CUDA source, ``csrc/trm_layer.cu``, whose
layer body is instantiated for both; this module is the entry to the fp32
instance, ``trm_layer_tf32x3_fwd_kernel`` / ``trm_layer_tf32x3_bwd_kernel``:
fp32 operands, every product on the tensor cores as three TF32 products
(a_lo b_hi + a_hi b_lo + a_hi b_hi, hi and lo the two tf32 parts of an fp32
value), which keeps fp32's precision (the kernels are held to 2e-4 of each
tensor's largest value against the plain version). The plain version, the
launchers, the launch counts and the limits are those of
``ops/trm_layer.py``.
"""

from .trm_layer import trm_layer, trm_layer_torch


def fused_transformer_layer(x, layer_params, key_valid, *, n_heads, causal, act="gelu",
                            eps=1e-12, dropout=0.0, attn_dropout=0.0, seed=None,
                            generator=None, layer=0):
    """One reference TransformerLayer on (B, L, D) fp32 x, fp32 operands:
    the plain version for a CPU tensor, the kernels for a CUDA tensor."""
    return trm_layer(x, layer_params, key_valid, n_heads=n_heads, causal=causal, act=act,
                     eps=eps, dropout=dropout, attn_dropout=attn_dropout, seed=seed,
                     generator=generator, layer=layer, bf16=False)


def fused_transformer_layer_torch(x, layer_params, key_valid, masks=None, *, n_heads, causal,
                                  act="gelu", eps=1e-12):
    """The plain version of the fp32 instance."""
    return trm_layer_torch(x, layer_params, key_valid, masks, n_heads=n_heads, causal=causal,
                           act=act, eps=eps, bf16=False)
