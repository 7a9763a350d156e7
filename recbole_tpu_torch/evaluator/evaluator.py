"""Evaluator: per-batch metric partial sums + host-side aggregation.

Port of recbole_tpu/evaluator/evaluator.py's ``topk_metric_sums`` (:16),
``gauc_metric_sums`` (:37), ``TopKCollector`` and ``ValueCollector``
(:132). Each batch contributes per-metric (K,) partial sums over its valid
users, computed on the device (GAUC: a numerator and a denominator); the
trainer sums them there and moves them to the host once per evaluation.
The value metrics are computed on the device over the whole split and only
the scalars come back.
"""

import numpy as np
import torch

from .metrics import TOPK_METRIC_FNS, VALUE_METRIC_FNS


def topk_metric_sums(metrics, pos_index, pos_len, user_mask):
    """Per-batch device-side reduction for ranking metrics.

    Args:
        metrics: list of lowercase metric names.
        pos_index: (B, K) 0/1 relevance of each top-k slot.
        pos_len: (B,) ground-truth positive counts.
        user_mask: (B,) validity of each row (padding rows are 0).

    Returns:
        dict metric -> (K,) sum over valid users, plus "_count" scalar.
    """
    w = user_mask.to(torch.float32)[:, None]
    out = {}
    for name in metrics:
        mat = TOPK_METRIC_FNS[name](pos_index.to(torch.float32), pos_len)
        out[name] = torch.sum(mat * w, dim=0)
    out["_count"] = torch.sum(user_mask.to(torch.float32))
    return out


def gauc_metric_sums(scores, pos, pos_len, user_len, user_mask):
    """Per-batch GAUC partials (parity: gauc_metric_sums, :37-82; the
    reference's RankEvaluator average_rank + gauc_, evaluators.py:153-286).

    Args:
        scores: (B, C) float scores, invalid slots already at NEG_INF.
        pos: (B, C) 0/1 positives aligned with ``scores``.
        pos_len: (B,) positive counts.
        user_len: (B,) candidate-list lengths (padding slots included, as
            the reference's ranks include them).
        user_mask: (B,) row validity.

    Returns {"gauc_num", "gauc_den"}: the sum over valid users of user AUC
    times pos_len, and of pos_len. Ranks come from a stable descending sort
    (``jnp.argsort``'s order), ties at their average 1-based rank."""
    B, C = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    ss = torch.gather(scores, 1, order)
    pos_sorted = torch.gather(pos, 1, order)
    # a tie group: a run of equal sorted scores; its ranks' average
    obs = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=scores.device),
                     ss[:, 1:] != ss[:, :-1]], dim=1)
    grp = torch.cumsum(obs.to(torch.int64), dim=1)
    idx = torch.arange(1, C + 1, dtype=torch.float32, device=scores.device)[None, :].expand(B, C)
    gstart = torch.full((B, C + 1), float("inf"), device=scores.device).scatter_reduce(
        1, grp, idx, reduce="amin")
    gend = torch.zeros((B, C + 1), device=scores.device).scatter_reduce(
        1, grp, idx, reduce="amax")
    avg_rank = 0.5 * (torch.gather(gstart, 1, grp) + torch.gather(gend, 1, grp))
    pos_rank_sum = torch.sum(avg_rank * pos_sorted.to(torch.float32), dim=1)
    pos_len = pos_len.to(torch.float32)
    user_len = user_len.to(torch.float32)
    neg_len = user_len - pos_len
    valid = (pos_len > 0) & (neg_len > 0) & (user_mask > 0)
    pair_num = ((user_len + 1.0) * pos_len - pos_len * (pos_len + 1.0) / 2.0
                - pos_rank_sum)
    user_auc = torch.where(valid, pair_num / torch.clamp(neg_len * pos_len, min=1.0),
                           torch.zeros((), device=scores.device))
    w = torch.where(valid, pos_len, torch.zeros((), device=scores.device))
    return {"gauc_num": torch.sum(user_auc * w), "gauc_den": torch.sum(w)}


RANK_METRICS = {"gauc"}


class TopKCollector:
    """Host-side accumulator for ranking (top-k and rank) metrics."""

    def __init__(self, config):
        self.metrics = [m.lower() for m in config["metrics"]]
        unknown = [m for m in self.metrics
                   if m not in TOPK_METRIC_FNS and m not in RANK_METRICS]
        if unknown:
            raise NotImplementedError(f"metrics {unknown} are not ranking metrics of the port")
        self.topk_metrics = [m for m in self.metrics if m in TOPK_METRIC_FNS]
        self.rank_metrics = [m for m in self.metrics if m in RANK_METRICS]
        self.topk = list(config["topk"])
        if any(k <= 0 for k in self.topk):
            raise ValueError("topk must be positive")
        self.max_k = max(self.topk)
        self.decimals = config["metric_decimal_place"]
        self.reset()

    @property
    def needs_gauc(self):
        return "gauc" in self.rank_metrics

    def reset(self):
        self._sums = {m: np.zeros(self.max_k, dtype=np.float64)
                      for m in self.topk_metrics}
        self._count = 0.0
        self._gauc_num = 0.0
        self._gauc_den = 0.0

    def collect(self, batch_sums):
        for m in self.topk_metrics:
            self._sums[m] += np.asarray(batch_sums[m], dtype=np.float64)
        self._count += float(batch_sums["_count"])
        if "gauc_num" in batch_sums:
            self._gauc_num += float(batch_sums["gauc_num"])
            self._gauc_den += float(batch_sums["gauc_den"])

    def evaluate(self):
        result = {}
        for m in self.topk_metrics:
            means = self._sums[m] / max(self._count, 1.0)
            for k in self.topk:
                result[f"{m}@{k}"] = round(float(means[k - 1]), self.decimals)
        if self.needs_gauc:
            result["gauc"] = round(self._gauc_num / max(self._gauc_den, 1.0), self.decimals)
        return result


class ValueCollector:
    """Accumulator for individual (value) metrics: AUC/MAE/RMSE/LogLoss.

    The reference stacks all (true, pred) pairs and computes at the end
    (evaluators.py:289-367); so does this, on the tensors' device: AUC needs
    a global sort anyway. One host transfer brings back the scalars.
    """

    def __init__(self, config):
        self.metrics = [m.lower() for m in config["metrics"]]
        unported = [m for m in self.metrics if m not in VALUE_METRIC_FNS]
        if unported:
            raise NotImplementedError(f"metrics {unported} are not value metrics")
        self.decimals = config["metric_decimal_place"]
        self.reset()

    def reset(self):
        self._trues = []
        self._preds = []

    def collect(self, trues, preds, mask=None):
        trues = trues.reshape(-1).to(torch.float32)
        preds = preds.reshape(-1).to(torch.float32)
        if mask is not None:
            keep = mask.reshape(-1) > 0
            trues, preds = trues[keep], preds[keep]
        self._trues.append(trues)
        self._preds.append(preds)

    def evaluate(self):
        trues = torch.cat(self._trues)
        preds = torch.cat(self._preds)
        values = torch.stack([VALUE_METRIC_FNS[m](trues, preds)
                              for m in self.metrics]).cpu().tolist()
        return {m: round(float(v), self.decimals)
                for m, v in zip(self.metrics, values)}
