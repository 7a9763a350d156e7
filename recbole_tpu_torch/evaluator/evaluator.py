"""Evaluator: per-batch metric partial sums + host-side aggregation.

Port of recbole_tpu/evaluator/evaluator.py's ``topk_metric_sums`` (:16),
``TopKCollector`` and ``ValueCollector`` (:132). Each batch contributes
per-metric (K,) partial sums over its valid users, computed on the device;
the trainer sums them there and moves them to the host once per evaluation.
The value metrics are computed on the device over the whole split and only
the scalars come back. GAUC is not ported yet.
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


class TopKCollector:
    """Host-side accumulator for top-k ranking metrics."""

    def __init__(self, config):
        self.metrics = [m.lower() for m in config["metrics"]]
        unported = [m for m in self.metrics if m not in TOPK_METRIC_FNS]
        if unported:
            raise NotImplementedError(
                f"metrics {unported} are not ported yet (ROADMAP Queue 1, "
                "item 5)")
        self.topk_metrics = list(self.metrics)
        self.topk = list(config["topk"])
        if any(k <= 0 for k in self.topk):
            raise ValueError("topk must be positive")
        self.max_k = max(self.topk)
        self.decimals = config["metric_decimal_place"]
        self.reset()

    def reset(self):
        self._sums = {m: np.zeros(self.max_k, dtype=np.float64)
                      for m in self.topk_metrics}
        self._count = 0.0

    def collect(self, batch_sums):
        for m in self.topk_metrics:
            self._sums[m] += np.asarray(batch_sums[m], dtype=np.float64)
        self._count += float(batch_sums["_count"])

    def evaluate(self):
        result = {}
        for m in self.topk_metrics:
            means = self._sums[m] / max(self._count, 1.0)
            for k in self.topk:
                result[f"{m}@{k}"] = round(float(means[k - 1]), self.decimals)
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
