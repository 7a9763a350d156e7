"""Loss functions.

Port of recbole_tpu/models/losses.py's ``bpr_loss``, ``bce_loss``,
``ce_loss``, ``mse_loss``, ``mask_rows``, ``fro_norm``, ``emb_loss``,
``reg_loss`` and ``emb_margin_loss``. Each loss takes an optional per-row ``weight``; padding
rows carry weight 0 and the mean is taken over the weight sum.
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


def mask_rows(w, *tensors):
    """Zero the rows of weight 0 out of batch representations before a
    norm-based regularizer (parity: losses.py:56-63); the tensors as they
    are (a tuple) when ``w`` is None."""
    if w is None:
        return tensors
    return tuple(t * w.reshape((-1,) + (1,) * (t.dim() - 1)).to(t.dtype) for t in tensors)


def fro_norm(t):
    """Frobenius norm of a whole tensor, the sum of squares clamped at 1e-12
    before the root (parity: losses.py:65-68, the reference's
    ``weight.norm(2)`` regulariser)."""
    return torch.sqrt(torch.clamp(torch.sum(t ** 2), min=1e-12))


def emb_loss(*embeddings, norm=2):
    """Sum of each embedding's p-norm over its looked-up rows, divided by
    the last embedding's batch size (parity: EmbLoss, loss.py:70-84; each
    embedding contributes its own norm, not a pooled root)."""
    total = 0.0
    for e in embeddings:
        total = total + torch.clamp(torch.sum(torch.abs(e) ** norm), min=1e-12) ** (1.0 / norm)
    return total / max(embeddings[-1].shape[0], 1)


def reg_loss(params, norm=2):
    """Sum of each tensor's p-norm over all its elements (parity: RegLoss,
    loss.py:52; losses.py:82-87)."""
    total = 0.0
    for p in params:
        total = total + torch.linalg.vector_norm(p.reshape(-1), ord=norm)
    return total


def emb_margin_loss(*embeddings, power=2):
    """Sum over rows of max(sum |e|^power - 1, 0): rows whose power-norm
    passes 1 (parity: EmbMarginLoss, loss.py:85-101; losses.py:90-97)."""
    total = 0.0
    for e in embeddings:
        total = total + torch.sum(torch.clamp(torch.sum(e ** power, dim=-1) - 1.0, min=0.0))
    return total
