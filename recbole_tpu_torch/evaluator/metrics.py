"""Top-k ranking metrics as (B, K) tensor programs, and the value metrics.

Port of recbole_tpu/evaluator/metrics.py, with the same float32 arithmetic
(parity target: reference numpy metric fns,
recbole/evaluator/metrics.py:27-355). GAUC, a rank metric, is
``evaluator.gauc_metric_sums``.

All top-k fns take:
    pos_index: (B, K) 0/1 float — whether the item at rank k is a positive
    pos_len:   (B,)   — number of ground-truth positives of each user
and return a (B, K) matrix of the metric at every cutoff 1..K.
"""

import torch


def _arange(start, stop, like, dtype=None):
    return torch.arange(start, stop, device=like.device, dtype=dtype)


def hit_(pos_index, pos_len):
    return (torch.cumsum(pos_index, dim=1) > 0).to(torch.float32)


def mrr_(pos_index, pos_len):
    K = pos_index.shape[1]
    first = torch.argmax(pos_index, dim=1)                      # (B,)
    has_hit = torch.gather(pos_index, 1, first[:, None])[:, 0] > 0
    ranks = _arange(0, K, pos_index)[None, :]
    rr = torch.where((ranks >= first[:, None]) & has_hit[:, None],
                     1.0 / (first[:, None].to(torch.float32) + 1.0),
                     torch.zeros((), device=pos_index.device))
    return rr.to(torch.float32)


def precision_(pos_index, pos_len):
    K = pos_index.shape[1]
    return torch.cumsum(pos_index, dim=1) / _arange(1, K + 1, pos_index,
                                                    torch.float32)[None, :]


def recall_(pos_index, pos_len):
    denom = torch.clamp(pos_len, min=1)[:, None].to(torch.float32)
    return torch.cumsum(pos_index, dim=1) / denom


def map_(pos_index, pos_len):
    K = pos_index.shape[1]
    pre = precision_(pos_index, pos_len)
    sum_pre = torch.cumsum(pre * pos_index, dim=1)
    actual_len = torch.clamp(pos_len, max=K)
    # denominator at cutoff k is min(k, actual_len) (reference normalization)
    denom = torch.minimum(_arange(1, K + 1, pos_index)[None, :],
                          torch.clamp(actual_len, min=1)[:, None])
    return sum_pre / denom.to(torch.float32)


def ndcg_(pos_index, pos_len):
    K = pos_index.shape[1]
    gains = 1.0 / torch.log2(_arange(2, K + 2, pos_index, torch.float32))  # (K,)
    icum = torch.cumsum(gains, dim=0)                          # ideal DCG prefix
    idcg_len = torch.clamp(torch.clamp(pos_len, max=K), 1, K).long()
    # idcg at cutoff k = icum[min(k, idcg_len) - 1]
    idx = torch.minimum(_arange(1, K + 1, pos_index)[None, :],
                        idcg_len[:, None]) - 1
    idcg = icum[idx]
    dcg = torch.cumsum(pos_index * gains[None, :], dim=1)
    return dcg / idcg


TOPK_METRIC_FNS = {
    "hit": hit_,
    "mrr": mrr_,
    "map": map_,
    "recall": recall_,
    "ndcg": ndcg_,
    "precision": precision_,
}


# ---------------------------------------------------------------- value metrics
# trues and preds are (n,) float32 tensors on one device

def auc_(trues, preds):
    """Pairwise-rank AUC over the full prediction set; ties get their
    average rank (parity: reference auc_, metrics.py:224). A run of equal
    predictions holds consecutive ranks, so its mean is the midpoint of its
    first and last rank: no scatter is needed."""
    order = torch.argsort(preds)
    sorted_true = trues[order]
    sorted_pred = preds[order]
    n = preds.shape[0]
    idx = _arange(0, n, preds)
    edge = sorted_pred[1:] != sorted_pred[:-1]
    one = torch.ones(1, dtype=torch.bool, device=preds.device)
    first = torch.cummax(torch.where(torch.cat([one, edge]), idx, 0), dim=0).values
    last = torch.flip(torch.cummin(torch.flip(
        torch.where(torch.cat([edge, one]), idx, n - 1), [0]), dim=0).values, [0])
    avg_rank = (first + last).to(torch.float32) * 0.5 + 1.0
    n_pos = torch.sum(sorted_true)
    n_neg = n - n_pos
    rank_sum_pos = torch.sum(avg_rank * sorted_true)
    return (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / torch.clamp(n_pos * n_neg, min=1.0)


def mae_(trues, preds):
    return torch.mean(torch.abs(trues - preds))


def rmse_(trues, preds):
    return torch.sqrt(torch.mean((trues - preds) ** 2))


def log_loss_(trues, preds):
    eps = 1e-7  # float32-safe (1 - 1e-15 rounds to 1.0 in f32 -> nan)
    p = torch.clamp(preds, eps, 1.0 - eps)
    return -torch.mean(trues * torch.log(p) + (1.0 - trues) * torch.log(1.0 - p))


VALUE_METRIC_FNS = {
    "auc": auc_,
    "mae": mae_,
    "rmse": rmse_,
    "logloss": log_loss_,
}
