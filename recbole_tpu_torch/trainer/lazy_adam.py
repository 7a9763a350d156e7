"""Lazy (sparse) Adam: torch.optim.SparseAdam semantics over dense gradients.

Port of recbole_tpu/trainer/lazy_adam.py (``learner: sparse_adam``; parity
target: the reference's torch.optim.SparseAdam, recbole/trainer/
trainer.py:123). It differs from dense Adam in one way: a row that the step
did not touch keeps its moments undecayed and its value unstepped. A row
is touched when some entry of its gradient is nonzero (the leading axis of
a leaf of two or more dimensions; each element of a 1-D or 0-D leaf), as
the JAX package recovers it from its dense gradients (:52-61). Bias
correction uses the global step count: ``step = lr sqrt(1 - b2^t) /
(1 - b1^t)``, each power rounded to float32 as ``count.astype(float32)``
gives it.

Plain torch on every device: the JAX package runs it through optax,
outside any Pallas kernel. ``weight_decay`` is warned about and dropped by
the trainer's ``build_optimizer`` (decay would make every row's gradient
nonzero).
"""

import math

import numpy as np
import torch


def lazy_adam_step(params, grads, mu, nu, count, *, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One step over lists of leaves, in place: ``params``, their gradients
    (zero-filled, the [PAD] rows already zero), and the moments ``mu`` and
    ``nu``; ``count`` is the step's number (1 for the first)."""
    t = np.float32(count)
    bc1 = np.float32(1.0) - np.float32(b1) ** t
    bc2 = np.float32(1.0) - np.float32(b2) ** t
    step_size = float(np.float32(lr) * np.float32(math.sqrt(bc2)) / bc1)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            if g.dim() >= 2:
                touched = (g != 0).reshape(g.shape[0], -1).any(dim=1)
                touched = touched.reshape((-1,) + (1,) * (g.dim() - 1))
            else:
                touched = g != 0
            m2 = torch.where(touched, b1 * m + (1 - b1) * g, m)
            v2 = torch.where(touched, b2 * v + (1 - b2) * g * g, v)
            delta = torch.where(touched, -step_size * m2 / (torch.sqrt(v2) + eps),
                                torch.zeros((), dtype=p.dtype, device=p.device))
            p.add_(delta)
            m.copy_(m2)
            v.copy_(v2)
