"""RepeatNet: repeat-aware recommendation with repeat and explore decoders.

Port of recbole_tpu/models/sequential/repeatnet.py (parity target: the
reference's RepeatNet, recbole/model/sequential_recommender/repeatnet.py):
a GRU memory (the fp32 instance of the recurrence kernel); a repeat/explore
gate from attention over the memory; a repeat decoder whose softmax over
history positions is scattered onto the item vocabulary; an explore decoder,
a softmax over a vocabulary-sized projection with the history's items at
-inf. The distribution is the gated mixture, the loss its NLL, plus, with
``joint_train``, the gate's NLL against whether the target is in the
history. The [PAD] column is never in a history, so the explore softmax
always has a finite entry: a row whose history covers every item puts its
explore mass on column 0. RepeatNet defines ``full_sort_predict`` itself,
so its full-sort evaluation takes the trainer's non-fused step.
"""

import torch
from torch import nn

from ..base import SequentialRecommender
from ..layers import GRU, embedding_init, gru_apply, xavier_uniform
from ...utils.enums import InputType
from .. import register_model


@register_model("RepeatNet")
class RepeatNet(SequentialRecommender):
    pad_zero_params = ("item_embedding",)
    input_type = InputType.POINTWISE
    default_config = {"embedding_size": 64, "hidden_size": 64,
                      "joint_train": False, "dropout_prob": 0.5,
                      "training_neg_sample_num": 0}

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.hidden_size = config["hidden_size"]
        self.joint_train = config["joint_train"]
        D, H, N = self.embedding_size, self.hidden_size, self.n_items
        gen = self.init_generator()

        def xu(*shape):
            return nn.Parameter(xavier_uniform(gen, shape, self.device))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=self.device))

        self.item_embedding = nn.Parameter(embedding_init(gen, N, D, self.device))
        self.gru = GRU(gen, D, H, 1, self.device)
        # repeat/explore gate
        self.w_re, self.u_re, self.v_re = xu(H, H), xu(H, H), xu(H, 1)
        self.w_cre = xu(H, 2)
        # repeat decoder
        self.w_r, self.u_r, self.v_r = xu(H, H), xu(H, H), xu(H, 1)
        self.v_r_b = zeros(1)
        # explore decoder
        self.w_e, self.w_e_b = xu(H, H), zeros(H)
        self.u_e, self.u_e_b = xu(H, H), zeros(H)
        self.v_e, self.v_e_b = xu(H, 1), zeros(1)
        self.explore_proj = xu(2 * H, N)

    def _distribution(self, batch):
        """(B, n_items) probabilities and the (B, 2) gate."""
        seq = batch[self.ITEM_SEQ]
        B = seq.shape[0]
        mem = gru_apply(self.gru, self.embed_seq(seq))                  # (B, L, H)
        last = self.gather_last(mem, batch[self.ITEM_SEQ_LEN])          # (B, H)
        pad = seq == 0

        def attend(u, w, v, vb):
            e = torch.tanh(mem @ u + (last @ w)[:, None, :])
            sc = (e @ v)[:, :, 0] + vb
            return torch.softmax(torch.where(pad, -1e9, sc), dim=1)    # (B, L)

        # the gate: no pad mask (the reference's Repeat_Explore_Mechanism)
        e_g = torch.tanh(mem @ self.u_re + (last @ self.w_re)[:, None, :])
        a_g = torch.softmax((e_g @ self.v_re)[:, :, 0], dim=1)
        gate = torch.softmax(torch.sum(a_g[:, :, None] * mem, 1) @ self.w_cre, dim=-1)

        # repeat decoder: the positional softmax added onto the vocabulary
        a_r = attend(self.u_r, self.w_r, self.v_r, self.v_r_b)
        p_repeat = torch.zeros((B, self.n_items), device=seq.device).scatter_add(
            1, seq, torch.where(pad, 0.0, a_r))

        # explore decoder: a vocabulary softmax with the history masked out
        a_e = attend(self.u_e, self.w_e, self.v_e, self.v_e_b)
        ctx_e = torch.sum(a_e[:, :, None] * mem, 1)
        logits_e = torch.cat([ctx_e, last], -1) @ self.explore_proj
        in_hist = torch.zeros((B, self.n_items), device=seq.device).scatter_add(
            1, seq, (~pad).to(torch.float32)) > 0
        p_explore = torch.softmax(torch.where(in_hist, -torch.inf, logits_e), dim=-1)
        return p_repeat * gate[:, 0:1] + p_explore * gate[:, 1:2], gate

    def calculate_loss(self, batch, generator=None):
        prob, gate = self._distribution(batch)
        pos = batch[self.POS_ITEM_ID]
        w = batch.get("_weight")
        nll = -torch.log(torch.gather(prob, 1, pos[:, None])[:, 0] + 1e-8)
        keep = (pos != 0).to(torch.float32)
        weight = keep if w is None else keep * w
        denom = torch.clamp(torch.sum(weight), min=1.0)
        loss = torch.sum(nll * weight) / denom
        if self.joint_train:
            # the gate's target: "repeat" when the positive is in the history
            seq = batch[self.ITEM_SEQ]
            is_repeat = torch.any((seq == pos[:, None]) & (seq != 0), dim=1)
            g_nll = -torch.where(is_repeat, torch.log(gate[:, 0] + 1e-8),
                                 torch.log(gate[:, 1] + 1e-8))
            loss = loss + torch.sum(g_nll * weight) / denom
        return loss

    def full_sort_predict(self, batch):
        return self._distribution(batch)[0]

    def predict(self, batch):
        return torch.gather(self._distribution(batch)[0], 1, batch[self.ITEM_ID][:, None])[:, 0]

    def score_items(self, batch, items):
        return torch.gather(self._distribution(batch)[0], 1, items)
