"""Time the port's packed-bit kernels and the LightGCN step that launches
them, for one checkout of the repository, on one CUDA card.

    python scripts/torch_bit_ab.py [TREE] [--kernels-only] [--clusters 1,2,4,8,16]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` and its ``chip_smoke.py`` phases are imported, the
timing tools are this checkout's ``chip_smoke.py``, so two checkouts are
compared by running the script once for each, in turns (A, B, B, A), on one
machine. It prints, for ``bit_rows_matmul_cuda`` and
``bit_cols_matmul_cuda`` at both sides of a LightGCN step at the Yelp shape
(``chip_smoke.yelp_bit_inputs``, seed 7: 2,048 users into the user image,
4,096 items into the item image, D 64):

* ``ms``: CUDA events over back-to-back calls; ``graph_ms``: the same calls
  captured in one CUDA graph and replayed, so the host's launch rate drops
  out;
* ``bound_ms`` (``chip_smoke.time_bit_kernels``' count of the bytes) and
  ``library_ms``: the unpacked rows in bf16 through ``torch.mm``;
* ``launches``: the kernels one call launches, with their device time
  (torch.profiler), and ``wrapper``: the calls and kernel launches of 20
  calls by the wrapper's own counters where it keeps them; the grid its
  last call launched where the tree's wrapper keeps it (the column kernel:
  blocks, cluster size, and the waves that makes at the runtime's
  occupancy; the row kernel: the walk's blocks, warps and split slots, and
  its counters);

the row kernel gets each image's set bits a row where the tree's wrapper
takes them. Then both kernels on the item side's 2,048 positives and 2,048
negatives alone (events and graph), both kernels at ml-100k's two sides (a
draw of its counts: 943 users, 1,682 items, 100,000 interactions; 256 bytes
a row), the two
other kernels of LightGCN's step at the Yelp shape as ``chip_smoke.py`` times
them (``windowed_grad`` into the user and item tables, ``time_windowed``;
Adam over the two tables, ``time_adam``), and LightGCN-Yelp's steady step
(wall, card busy, launches) as the tree's ``chip_smoke.phase_lightgcn`` logs
it (``--kernels-only`` skips the step).
``--clusters`` adds the column kernel at both Yelp sides and ml-100k's with
each cluster size given, past the plan (trees with ``bit_cols_plan``). Exits
non-zero without a card.
"""

import argparse
import importlib.util
import inspect
import os
import subprocess
import sys
import tempfile

import numpy as np

ML100K = (943, 1682, 100_000)


def ml100k_bit_inputs(torch, tools, seed=11):
    """Packed images of an ml-100k-sized draw (uniform users, power-law
    items, as ``chip_smoke.yelp_draw``) and a train batch's rows: 2,048
    users, and 2,048 positive and 2,048 uniform negative items."""
    from recbole_tpu_torch.ops.bitgraph import _pack_side
    n_users, n_items, n_inter = ML100K
    rng = np.random.RandomState(seed)
    uids = rng.randint(1, n_users + 1, size=n_inter)
    iids = 1 + np.floor((n_items - 1) * rng.random_sample(n_inter) ** 2.2).astype(np.int64)
    n_u, n_i = n_users + 1, n_items + 1
    pick = rng.randint(0, n_inter, 2048)
    rows_u = torch.from_numpy(uids[pick].astype(np.int64)).cuda()
    rows_i = torch.from_numpy(np.concatenate([iids[pick], rng.randint(1, n_i, 2048)])
                              .astype(np.int64)).cuda()
    out = {}
    for side, image, rows, n_cols in (("user", _pack_side(uids, iids, n_u, n_i), rows_u, n_i),
                                      ("item", _pack_side(iids, uids, n_i, n_u), rows_i, n_u)):
        counts = np.unpackbits(image, axis=1).sum(axis=1).astype(np.int32)
        out[side] = (torch.from_numpy(image).cuda(), rows, n_cols,
                     torch.from_numpy(counts).cuda())
    return out


def grid(bk, device, D):
    """The grid the column kernel's last call launched, with the waves it
    makes at the card's occupancy, where the tree's wrapper keeps it."""
    last = getattr(bk.bit_cols_matmul_cuda, "last_grid", None)
    if last is None:
        return None
    sms, per_sm, _ = bk.cols_occupancy(device, D)
    return {**last, "slots": sms * per_sm, "waves": -(-last["blocks"] // (sms * per_sm))}


def row_call(bk, bits, rows, v, counts):
    """A call of the tree's row kernel, with the counts where it takes them."""
    if "counts" in inspect.signature(bk.bit_rows_matmul_cuda).parameters:
        return lambda: bk.bit_rows_matmul_cuda(bits, rows, v, counts)
    return lambda: bk.bit_rows_matmul_cuda(bits, rows, v)


def wrapper_counts(torch, bk, kernel, call):
    """Calls and kernel launches of 20 calls by the wrapper's counters, and
    what its last call reports (grid, counters), where the wrapper keeps them."""
    before = (kernel.launches, getattr(kernel, "kernel_launches", None))
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    out = {"calls": (kernel.launches - before[0]) / 20}
    if before[1] is not None:
        out["kernels"] = (kernel.kernel_launches - before[1]) / 20
    if hasattr(bk, "rows_counters") and kernel is bk.bit_rows_matmul_cuda:
        out["grid"] = kernel.last_grid
        out["counters"] = bk.rows_counters()
    return out


def time_kernels(torch, tools, bk, clusters):
    rng = np.random.RandomState(23)
    images = tools.yelp_bit_inputs(torch, seed=7)
    D = 64
    for side in ("user", "item"):
        bits, rows, n_cols, counts = images[side]
        R, nbytes = rows.numel(), bits.shape[1]
        v = torch.from_numpy(rng.randn(n_cols, D).astype(np.float32) * 0.1).cuda().bfloat16()
        g = torch.from_numpy(rng.randn(R, D).astype(np.float32) * 1e-3).cuda().bfloat16()
        unpacked = bk.unpack_bits(bits[rows])
        set_bits = int(unpacked.sum())
        touched = int(unpacked.any(dim=0).sum())
        distinct = int(torch.unique(rows).numel())
        del unpacked
        v_pad = bk.pad_k(v, nbytes * 8)
        work = {"bit_rows_matmul": (row_call(bk, bits, rows, v, counts),
                                    lambda: torch.mm(bk.unpack_bits(bits[rows]).bfloat16(),
                                                     v_pad, out_dtype=torch.float32),
                                    touched * D * 2 + R * D * 4),
                "bit_cols_matmul": (lambda: bk.bit_cols_matmul_cuda(bits, rows, g),
                                    lambda: torch.mm(bk.unpack_bits(bits[rows]).bfloat16().T,
                                                     g, out_dtype=torch.float32),
                                    R * D * 2 + nbytes * 8 * D * 4)}
        for name, (call, lib, io_bytes) in work.items():
            t = {"ms": tools.cuda_ms(torch, call, 50), "graph_ms": tools.graph_ms(torch, call),
                 "library_ms": tools.cuda_ms(torch, lib, 10)}
            t["bound_ms"], t["bound_by"] = tools.bound(float(set_bits * D),
                                                       distinct * nbytes + R * 8 + io_bytes)
            t["launches"] = tools.kernels_per_call(torch, call)
            t["wrapper"] = wrapper_counts(torch, bk, getattr(bk, f"{name}_cuda"), call)
            if name == "bit_cols_matmul":
                t["grid"] = grid(bk, bits.device, D)
            tools.log(f"[bit-ab] {name} {side} side R={R} nbytes={nbytes} D={D} ({set_bits} set "
                      f"bits): {t}")
        if side == "item":
            for half, sl in (("positives", slice(0, R // 2)), ("negatives", slice(R // 2, R))):
                sub = rows[sl].contiguous()
                gs = g[sl].contiguous()
                calls = {"bit_rows_matmul": row_call(bk, bits, sub, v, counts),
                         "bit_cols_matmul": lambda: bk.bit_cols_matmul_cuda(bits, sub, gs)}
                ms = {k: (round(tools.cuda_ms(torch, c, 50), 4),
                          round(tools.graph_ms(torch, c), 4)) for k, c in calls.items()}
                tools.log(f"[bit-ab] item side, the {R // 2} {half} alone "
                          f"({int(bk.unpack_bits(bits[sub]).sum())} set bits): (ms, graph ms) "
                          f"{ms}")
        if clusters:
            sweep(torch, tools, bk, f"Yelp {side} side", bits, rows, g, clusters)
    small = ml100k_bit_inputs(torch, tools)
    for side in ("user", "item"):
        bits, rows, n_cols, counts = small[side]
        g = torch.from_numpy(rng.randn(rows.numel(), D).astype(np.float32) * 1e-3).cuda()
        g = g.bfloat16()
        v = torch.from_numpy(rng.randn(n_cols, D).astype(np.float32) * 0.1).cuda().bfloat16()
        calls = {"bit_rows_matmul": row_call(bk, bits, rows, v, counts),
                 "bit_cols_matmul": lambda: bk.bit_cols_matmul_cuda(bits, rows, g)}
        for name, call in calls.items():
            t = {"ms": tools.cuda_ms(torch, call, 50), "graph_ms": tools.graph_ms(torch, call)}
            if name == "bit_cols_matmul":
                t["grid"] = grid(bk, bits.device, D)
            else:
                t["wrapper"] = wrapper_counts(torch, bk, bk.bit_rows_matmul_cuda, call)
            tools.log(f"[bit-ab] {name} ml-100k {side} side R={rows.numel()} "
                      f"nbytes={bits.shape[1]} D={D}: {t}")
        if clusters:
            sweep(torch, tools, bk, f"ml-100k {side} side", bits, rows, g, clusters)


def time_step_neighbours(torch, tools):
    """The kernels that share LightGCN's step with the bit kernels, each as
    ``chip_smoke.py`` times it: ``windowed_grad`` at the Yelp step's user and
    item tables, and Adam over LightGCN's two tables."""
    from recbole_tpu_torch.ops import embed_grad as eg
    w = tools.time_windowed(torch, eg, plain=False)
    for label in ("lightgcn_users", "lightgcn_items"):
        tools.log(f"[bit-ab] windowed_grad {label}: ms {w[label]['ms']:.4f}, graph_ms "
                  f"{w[label]['graph_ms']:.4f}")
    n, t = tools.time_adam(torch, *tools.ADAM_SETS["lightgcn"], 200)
    tools.log(f"[bit-ab] adam_leaf over LightGCN's tables ({n} elements): ms {t['ms']:.4f}, "
              f"graph_ms {t['graph_ms']:.4f}")


def sweep(torch, tools, bk, label, bits, rows, g, clusters):
    """The column kernel with each cluster size, the plan bypassed: graph ms,
    and whether it matches the plan's output bit for bit."""
    plan = bk.bit_cols_plan
    want = bk.bit_cols_matmul_cuda(bits, rows, g)
    out = {}
    try:
        for C in clusters:
            bk.bit_cols_plan = lambda *a, C=C: {**plan(*a), "cluster": C}
            same = bool(torch.equal(bk.bit_cols_matmul_cuda(bits, rows, g), want))
            out[C] = (round(tools.graph_ms(torch, lambda: bk.bit_cols_matmul_cuda(bits, rows, g)),
                            4), same)
    finally:
        bk.bit_cols_plan = plan
    tools.log(f"[bit-ab] bit_cols_matmul {label} by cluster size (graph ms, the same bits as "
              f"the plan's): {out}")


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--clusters", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_bit_ab: needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    import chip_smoke as cs
    from recbole_tpu_torch.ops import bit_kernels as bk
    from recbole_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tools.log(f"[bit-ab] tree {tree}; {smi.strip()}")
    cuda_build.build(["masked_topk", "embed_grad", "bit_kernels", "fused_adam"])
    time_kernels(torch, tools, bk, [int(c) for c in args.clusters.split(",") if c])
    time_step_neighbours(torch, tools)
    if args.kernels_only:
        return
    cs.count_adam_steps()  # the phase holds Adam to one launch a step
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_lightgcn(torch, tmp)


if __name__ == "__main__":
    main()
