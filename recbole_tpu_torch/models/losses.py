"""Loss functions.

Port of recbole_tpu/models/losses.py's ``bpr_loss``, ``bce_loss``,
``ce_loss`` and ``mse_loss``. Each takes an optional per-row ``weight``; padding rows carry
weight 0 and the mean is taken over the weight sum.
"""

import torch


def _wmean(values, weight):
    if weight is None:
        return torch.mean(values)
    w = weight.to(values.dtype)
    return torch.sum(values * w) / torch.clamp(torch.sum(w), min=1.0)


def bpr_loss(pos_score, neg_score, weight=None, gamma=1e-10):
    """-log sigmoid(pos - neg)  (parity: BPRLoss, loss.py:23)."""
    return _wmean(-torch.log(gamma + torch.sigmoid(pos_score - neg_score)), weight)


def bce_loss(logits, labels, weight=None):
    """Numerically-stable binary cross entropy on logits."""
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return _wmean(loss, weight)


def ce_loss(logits, targets, weight=None):
    """Cross entropy over the item axis; targets are integer ids. Computed
    as logsumexp(logits) - logits[target], as the JAX package does (:31-41)."""
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.gather(logits, 1, targets[:, None])[:, 0]
    return _wmean(lse - pos, weight)


def mse_loss(preds, labels, weight=None):
    return _wmean(torch.square(preds - labels), weight)
