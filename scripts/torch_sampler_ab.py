"""Time the sampler's collision test on one CUDA card: the port's binary
search in each user's sorted history (``sampler.first_non_colliding``)
against the JAX package's formula, every candidate compared with every
history entry, written out here as a plain PyTorch expression.

    python scripts/torch_sampler_ab.py [--iters 200]

The history is that of chip_smoke.py's ml-1m-shaped draw (6,040 users,
3,706 items, 1,000,209 interactions; the first 80% of each user's rows, the
training split), int64 on the card as ``PhaseHistory.device_arrays`` gives
it. The candidates are BPR's training draw (8 rounds, 2,048 rows, one
negative) and a uniform-100 eval draw (8 rounds, 512 rows, 100 negatives a
positive). For each it prints one JSON line: ms a call by CUDA events,
the host's ms to enqueue a call, and whether both pick the same ids. Exits
non-zero without a card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def all_pairs(torch, cand, user_ids, history, hist_len):
    """The JAX package's choice: collide[r, b, j] over every (r, b, j, h)."""
    H = history.shape[1]
    user_hist = history[user_ids]
    valid = torch.arange(H, device=history.device)[None, :] < hist_len[user_ids][:, None]
    collide = ((cand[:, :, :, None] == user_hist[None, :, None, :])
               & valid[None, :, None, :]).any(dim=-1)
    first_ok = torch.argmax((~collide).to(torch.uint8), dim=0)
    return torch.gather(cand, 0, first_ok[None]).squeeze(0)


def host_ms(torch, fn, iters):
    """The host's milliseconds a call to enqueue ``fn`` (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    import chip_smoke
    from recbole_tpu_torch.data.dataset import build_history_matrix
    from recbole_tpu_torch.sampler.sampler import first_non_colliding

    n_users, n_items, n_inter = chip_smoke.ML1M
    rng = np.random.RandomState(42)
    uids = rng.randint(1, n_users + 1, size=n_inter)
    iids = 1 + np.floor((n_items - 1) * rng.random_sample(n_inter) ** 2.2).astype(np.int64)
    # the first 80% of each user's rows (they are in time order)
    order = np.argsort(uids, kind="stable")
    counts = np.bincount(uids, minlength=n_users + 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n_inter) - starts[uids[order]]
    keep = order[pos < np.floor(0.8 * counts[uids[order]])]
    hist, lens = build_history_matrix(uids[keep], iids[keep], n_users + 1)
    history = torch.as_tensor(hist, dtype=torch.int64, device="cuda")
    hist_len = torch.as_tensor(lens, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"history {tuple(history.shape)}", flush=True)
    for name, (R, B, k) in (("bpr_train_draw", (8, 2048, 1)), ("uni100_eval_draw", (8, 512, 100))):
        users = torch.randint(1, n_users + 1, (B,), generator=gen, device="cuda")
        cand = torch.randint(1, n_items + 1, (R, B, k), generator=gen, device="cuda")
        args_ = (cand, users, history, hist_len)
        same = bool(torch.equal(first_non_colliding(*args_), all_pairs(torch, *args_)))
        out = {"draw": name, "shape": [R, B, k, history.shape[1]], "same_ids": same}
        for route, fn in (("binary_search", first_non_colliding),
                          ("all_pairs", lambda *a: all_pairs(torch, *a))):
            out[f"{route}_ms"] = chip_smoke.cuda_ms(torch, lambda: fn(*args_), args.iters)
            out[f"{route}_host_ms"] = host_ms(torch, lambda: fn(*args_), args.iters)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
