"""xDeepFM: Compressed Interaction Network, deep tower and linear term.

Port of recbole_tpu/models/context/xdeepfm.py (parity target: the
reference's xDeepFM, recbole/model/context_aware_recommender/xdeepfm.py):
each CIN layer takes the outer product of its maps with the field
embeddings along the fields, then a 1 x 1 "convolution" over the maps, a
matmul; the layers' maps are summed over D and projected by ``cin_out_w``.
In the split variant (``direct: False``) every layer but the last keeps
half its maps and feeds the other half to the next, and odd sizes round
down. The deep tower's 1-unit projection sits inside the MLP, so its relu
follows it too (xdeepfm.py:68-69).

Under the default ``train_cin_weights: False`` the CIN weights are random
state the reference never hands its optimizer (a plain python list,
xdeepfm.py:57-61). The JAX package keeps them under ``_const``; the port
holds them as persistent buffers (``cin.<i>.w``, ``cin.<i>.b``), named in
``const_state_map()`` so that ``convert.py`` carries them both ways and the
checkpoint keeps them, and Adam never sees them. With ``True`` they are
parameters under the same names.

The regulariser reads the first-order bias column of the merged token
table (``token_embedding[:, -1]``), as the JAX model does.
"""

import torch
from torch import nn

from ..layers import MLPLayers, xavier_normal
from ..losses import bce_loss, fro_norm, reg_loss
from .. import register_model
from .context_base import ContextRecommender


class _CinLayer(nn.Module):
    """One CIN layer's (F x H_prev, H) weight and (H,) bias: parameters
    when trained, else persistent buffers."""

    def __init__(self, w, b, trained):
        super().__init__()
        if trained:
            self.w, self.b = nn.Parameter(w), nn.Parameter(b)
        else:
            self.register_buffer("w", w)
            self.register_buffer("b", b)


@register_model("xDeepFM")
class XDeepFM(ContextRecommender):
    default_config = {"embedding_size": 10, "mlp_hidden_size": [128, 128, 128],
                      "reg_weight": 5e-4, "dropout_prob": 0.2, "direct": False,
                      "cin_layer_size": [100, 100, 100],
                      "train_cin_weights": False}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mlp_hidden = list(config["mlp_hidden_size"])
        self.reg_weight = config["reg_weight"]
        self.dropout_prob = config["dropout_prob"]
        self.train_cin = bool(config["train_cin_weights"])
        self.direct = config["direct"]
        self.cin_sizes = list(config["cin_layer_size"])
        if not self.direct:
            self.cin_sizes = [s // 2 * 2 for s in self.cin_sizes]
        F, dev = self.num_fields, self.device
        gen = self.init_generator()
        self.init_context_params(gen)
        self.mlp = MLPLayers(gen, [F * self.embedding_size] + self.mlp_hidden + [1], dev,
                             act="relu", dropout=self.dropout_prob)
        layers, prev, final_maps = [], F, 0
        last = len(self.cin_sizes) - 1
        for li, size in enumerate(self.cin_sizes):
            layers.append(_CinLayer(xavier_normal(gen, (F * prev, size), dev),
                                    torch.zeros(size, device=dev), self.train_cin))
            keep = size if self.direct or li == last else size // 2
            final_maps += keep
            prev = keep
        self.cin = nn.ModuleList(layers)
        self.cin_out_w = nn.Parameter(xavier_normal(gen, (final_maps, 1), dev))

    def const_state_map(self):
        """{JAX ``_const`` leaf: state_dict name} of the frozen CIN
        weights (none when they train)."""
        if self.train_cin:
            return {}
        return {f"cin.{i}.{k}": f"cin.{i}.{k}" for i in range(len(self.cin)) for k in "wb"}

    def _cin(self, x0):
        """x0 (B, F, D) -> (B, sum of the kept maps), each map summed over
        D. The CIN's activation is the identity (xdeepfm.py:115-150)."""
        B, _, D = x0.shape
        x, outs = x0, []
        last = len(self.cin) - 1
        for li, layer in enumerate(self.cin):
            z = (x[:, :, None, :] * x0[:, None, :, :]).reshape(B, -1, D)      # (B, H F, D)
            h = torch.einsum("bmd,mn->bnd", z, layer.w) + layer.b[None, :, None]
            if self.direct or li == last:
                x = keep = h
            else:
                half = h.shape[1] // 2
                x, keep = h[:, :half], h[:, half:]
            outs.append(keep.sum(-1))
        return torch.cat(outs, dim=1)

    def _logits(self, batch, generator=None):
        emb, linear = self.embed_and_first_order(batch)
        cin = (self._cin(emb) @ self.cin_out_w)[:, 0]
        deep = self.mlp(emb.reshape(emb.shape[0], -1), generator=generator)[:, 0]
        return linear + cin + deep

    def calculate_loss(self, batch, generator=None):
        loss = bce_loss(self._logits(batch, generator), batch[self.LABEL],
                        batch.get("_weight"))
        # the MLP weights, the first-order tables and the CIN kernels, each
        # tensor's norm (xdeepfm.py:90-114)
        fo = [getattr(self, k) for k in ("float_weight", "seq_bias") if hasattr(self, k)]
        if self.token_fields:
            fo.append(self.token_embedding[:, -1])
        reg = (reg_loss([layer.w for layer in self.mlp]) + sum(fro_norm(t) for t in fo)
               + reg_loss([layer.w for layer in self.cin]))
        return loss + self.reg_weight * reg

    def predict(self, batch):
        return torch.sigmoid(self._logits(batch))
