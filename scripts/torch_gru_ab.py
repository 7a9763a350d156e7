"""Time the port's GRU recurrence kernels, for one checkout of the repository,
on one CUDA card.

    python scripts/torch_gru_ab.py [TREE] [--untimed] [--rows 8,8b,8c]
                                   [--phases gru4rec,wide]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` is imported, so two checkouts are compared by
running the script once for each, in turns (A, B, B, A), on one machine.
At GRU4Rec's step (B 2,048, L 50), forward and backward, for the kernel
table's rows (``--rows``, default all three): 8, the bf16 instance at hidden
128 (GRU4Rec's default); 8b, the fp32 instance at 128 (NARM's); 8c, the
bf16 instance at 256 (the cluster route), it prints:

* ``ms``: CUDA events over back-to-back calls (what chip_smoke.py reports);
* ``graph_ms``: the same calls captured in one CUDA graph and replayed, so
  the host's launch rate drops out;
* ``kernels``: each kernel a call launches, with its count and device time
  per call (torch.profiler): the backward's split by kernel;
* ``library_ms``: ``torch.nn.GRU`` in the instance's type (cuDNN) on
  inputs of the same shape: forward, and forward + backward beside the
  backward;
* ``err``: the largest |difference| from the plain version over the
  tensor's largest |value| (out; the worst of dxi, dh0, dwh and dbh);

and, where the tree has the cluster route, its geometry on this card
(cluster size, rows a block, clusters, the clusters the card holds at once)
and the per-step floor: the forward's L - 1 steps of the h exchange and the
cluster barrier alone, then with the recurrent product. ``--untimed``
prints only the geometry and the floor, and times no kernel of the tree.
``--phases`` then runs GRU4Rec's training phases of the tree's own
chip_smoke.py (this checkout's where the tree has none; ``gru4rec``: its
defaults, 2 epochs and 20 steps under the profiler; ``narm``: NARM's
defaults, 1 epoch and 20 steps under the profiler; ``wide``: 5 steps each
at hidden 10 and 256, and SASRec's wide shapes). The kernel timings use this
checkout's chip_smoke.py helpers, whatever the tree. Exits non-zero without
a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--untimed", action="store_true")
    ap.add_argument("--rows", default="8,8b,8c")
    ap.add_argument("--phases", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_gru_ab: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import fused_gru as fg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tools.log(f"[gru-ab] tree {tree}; {smi}")
    cuda_build.build(["fused_gru"])
    B, L, E = (tools.GRU4REC[k] for k in ("B", "L", "E"))

    if hasattr(fg, "fused_gru_cluster_plan"):
        for H in (132, 256, fg._lib().fused_gru_max_cluster_hidden()):
            plan = {way: fg.fused_gru_cluster_plan(B, H, way == "bwd") for way in ("fwd", "bwd")}
            floor = [tools.cuda_ms(torch, lambda: fg.fused_gru_cluster_floor_cuda(
                B, L, H, "cuda", product), 20) for product in (False, True)]
            tools.log(f"[gru-ab] cluster H={H} B={B}: plan {json.dumps(plan)}; floor "
                      f"({L - 1} steps of exchange + barrier) {floor[0]:.4f} ms, "
                      f"{1e3 * floor[0] / (L - 1):.3f} us a step; with the product "
                      f"{floor[1]:.4f} ms, {1e3 * floor[1] / (L - 1):.3f} us a step")
    rows = {"8": (128, True), "8b": (128, False), "8c": (256, True)}
    if not args.untimed:
        for row in args.rows.split(","):
            H, bf16 = rows[row]
            dt = torch.bfloat16 if bf16 else torch.float32
            xi, hinit, wh, bh, dout = tools.gru_inputs(torch, B, L, H, 41, bf16, False)
            y = fg.fused_gru_fwd_cuda(xi, hinit, wh, bh)
            lib = torch.nn.GRU(E, H, batch_first=True, device="cuda").to(dt)
            x = torch.randn(B, L, E, device="cuda", dtype=dt)
            xg = x.clone().requires_grad_(True)

            def lib_fwd():
                with torch.no_grad():
                    return lib(x)[0]

            def lib_fwd_bwd():
                for prm in lib.parameters():
                    prm.grad = None
                xg.grad = None
                lib(xg)[0].backward(dout)

            library = {"fwd": tools.cuda_ms(torch, lib_fwd, 20),
                       "bwd": tools.cuda_ms(torch, lib_fwd_bwd, 20)}
            calls = {"fwd": lambda: fg.fused_gru_fwd_cuda(xi, hinit, wh, bh),
                     "bwd": lambda: fg.fused_gru_bwd_cuda(xi, hinit, wh, bh, y, dout)}
            ref = {"fwd": [fg.fused_gru_torch_fwd(xi, hinit, wh, bh, bf16)],
                   "bwd": fg.fused_gru_torch_bwd(xi, hinit, wh, bh, y, dout, bf16)}
            for way, kernel in calls.items():
                got = kernel()
                got = [got] if way == "fwd" else got
                t = {"ms": tools.cuda_ms(torch, kernel, 20),
                     "graph_ms": tools.graph_ms(torch, kernel, calls=5, replays=10),
                     "library_ms": library[way],
                     "err": max(tools.rel_err(a, b) for a, b in zip(got, ref[way])),
                     "kernels": tools.kernels_per_call(torch, kernel, calls=5)}
                tools.log(f"[gru-ab] row {row} {way} {'bf16' if bf16 else 'fp32'} B={B} L={L} "
                          f"H={H}: {json.dumps(t)}")
    if args.phases:
        # the tree's own phases, which know its kernels' launch counts
        own = os.path.join(tree, "chip_smoke.py")
        if os.path.exists(own):
            spec = importlib.util.spec_from_file_location("tree_smoke", own)
            tools = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(tools)
        tools.count_adam_steps()  # the phases hold Adam to one launch a step
        with tempfile.TemporaryDirectory() as tmp:
            tools.write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
            for phase in args.phases.split(","):
                getattr(tools, f"phase_{phase}")(torch, tmp)


if __name__ == "__main__":
    main()
