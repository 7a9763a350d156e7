"""Negative sampling on the device.

Port of recbole_tpu/sampler/sampler.py. ``PhaseHistory`` is the same numpy
store of per-phase used-id tables; its ``device_tables`` returns torch
tensors. ``sample_negatives`` draws its candidate rounds from a
``torch.Generator`` on the device and hands them to ``first_non_colliding``,
which takes, for each (row, slot), the first round whose candidate is not
in the user's history. Split out this way, the choice can be fed the same
candidates as the JAX package's ``sample_negatives`` (sampler.py:111-120).
With R rounds the residual collision probability is density^R.
"""

import numpy as np
import torch


class PhaseHistory:
    """Per-phase used-ids tables as dense matrices.

    Phase 'train' excludes train positives; 'valid' excludes train+valid;
    'test' excludes train+valid+test (parity: sampler.py:206-227).
    """

    def __init__(self, n_users, n_items, splits, max_history_len=None):
        """splits: ordered dict phase -> (uids, iids) numpy arrays."""
        self.n_users = n_users
        self.n_items = n_items
        self.phases = list(splits)
        self.history = {}
        self.hist_len = {}
        self.pop_items = {}
        self._acc_pairs = {}
        acc_u, acc_i = [], []
        for phase, (uids, iids) in splits.items():
            acc_u.append(np.asarray(uids))
            acc_i.append(np.asarray(iids))
            u = np.concatenate(acc_u)
            i = np.concatenate(acc_i)
            hist, lens = _build_history(u, i, n_users, max_history_len)
            self.history[phase] = hist
            self.hist_len[phase] = lens
            # popularity distribution = observed item multiset (sampler.py:191-204)
            self.pop_items[phase] = i.astype(np.int32)
            self._acc_pairs[phase] = (u, i)

    def device_tables(self, phase, device):
        """(history (n_users, H) int64, hist_len (n_users,) int64) on ``device``."""
        return (torch.as_tensor(self.history[phase], dtype=torch.int64, device=device),
                torch.as_tensor(self.hist_len[phase], dtype=torch.int64, device=device))

    def assert_sampleable(self, phase):
        """Raise when some user has interacted with every item — masked
        resampling would silently return a known positive for them (parity:
        reference raises at used-ids construction, sampler.py:220-226)."""
        u, i = self._acc_pairs[phase]
        # count DISTINCT items per user (duplicate interactions are kept by
        # default, so raw history length over-counts)
        pairs = np.unique(u.astype(np.int64) * self.n_items + i)
        distinct = np.bincount(pairs // self.n_items,
                               minlength=self.n_users)
        # n_items includes the [PAD] id 0, which is never a candidate
        dense = np.flatnonzero(distinct >= self.n_items - 1)
        if dense.size:
            raise ValueError(
                f"{dense.size} user(s) (e.g. ids {dense[:5].tolist()}) have "
                f"interacted with all {self.n_items - 1} items; negative "
                f"sampling cannot exclude their history. Use repeatable "
                f"sampling or reduce filtering.")


def _build_history(uids, iids, n_users, max_len=None):
    from ..data.dataset import build_history_matrix
    return build_history_matrix(uids, iids, n_users, max_len)


def first_non_colliding(cand, user_ids, history, hist_len):
    """Pick, per (row, slot), the first round whose candidate is not in the
    row user's history; the first round when every round collides.

    Args:
        cand: (R, B, k) integer candidates.
        user_ids: (B,) integer user ids.
        history: (n_users, H) integer history, padded with 0.
        hist_len: (n_users,) history lengths.

    Returns:
        (B, k) chosen ids, of ``cand``'s dtype.
    """
    H = history.shape[1]
    user_hist = history[user_ids]                                  # (B, H)
    valid = (torch.arange(H, device=history.device)[None, :]
             < hist_len[user_ids][:, None])
    # collide[r, b, j] = candidate in the user's history
    collide = ((cand[:, :, :, None] == user_hist[None, :, None, :])
               & valid[None, :, None, :]).any(dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    first_ok = torch.argmax((~collide).to(torch.uint8), dim=0)     # (B, k)
    return torch.gather(cand, 0, first_ok[None]).squeeze(0)


def sample_negatives(generator, user_ids, history, hist_len, n_items, num_neg,
                     rounds=8, pop_items=None):
    """Draw ``num_neg`` negatives per user, excluding their history.

    Args:
        generator: torch.Generator on the device of ``user_ids``.
        user_ids: (B,) int64.
        history: (n_users, H) int64 padded with 0.
        hist_len: (n_users,) int64.
        n_items: vocab size incl. PAD at 0.
        num_neg: negatives per row.
        rounds: bounded resample rounds.
        pop_items: optional (M,) observed-item multiset for popularity
            sampling; None = uniform over [1, n_items).

    Returns:
        (B, num_neg) int64 item ids.
    """
    B = user_ids.shape[0]
    shape = (rounds, B, num_neg)
    device = user_ids.device
    if pop_items is None:
        cand = torch.randint(1, n_items, shape, generator=generator,
                             device=device)
    else:
        idx = torch.randint(0, pop_items.shape[0], shape, generator=generator,
                            device=device)
        cand = pop_items[idx].long()
    return first_non_colliding(cand, user_ids, history, hist_len)


def sample_negatives_unchecked(generator, shape, n_items, pop_items=None, device=None):
    """Uniform or popularity draw without exclusion (RepeatableSampler
    semantics, sampler.py:341-420: sequential models allow repeats)."""
    if pop_items is None:
        return torch.randint(1, n_items, shape, generator=generator, device=device)
    idx = torch.randint(0, pop_items.shape[0], shape, generator=generator,
                        device=pop_items.device)
    return pop_items[idx].long()
